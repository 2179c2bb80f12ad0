"""A copy of the JAX-free :mod:`ppqsflhe_tpu.ckks.openfhe_io` (its package's
``__init__`` imports JAX).

Readers for the reference repo's serialized OpenFHE (cereal-JSON)
artifacts — the checked-in CryptoContext and client keys
(client/storage/*/private/*.key, server/storage/CC.json; SURVEY.md §2.3).

These artifacts pin the exact CKKS parameter set and key material of the
authors' run, giving us *bit-exact* interop tests without OpenFHE itself:
iNTT-ing a secret-key tower with the right negacyclic convention must yield a
ternary polynomial in {0, 1, q-1}, CRT-consistent across towers
(tests/test_interop.py).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class OpenFhePoly:
    """A DCRTPoly: per-tower residue vectors + moduli + 2N-th roots."""

    towers: np.ndarray          # u64[L, N]
    moduli: List[int]
    roots: List[int]
    fmt: int                    # 0 = EVALUATION (NTT domain), 1 = COEFFICIENT
    ring_dim: int


def build_id_index(doc) -> dict:
    """ptr_wrapper id (sans MSB) → data, for resolving cereal back-references
    (shared pointers serialize data only at first use)."""
    out = {}
    stack = [doc]
    while stack:
        cur = stack.pop()
        if isinstance(cur, dict):
            if "id" in cur and "data" in cur:
                out[int(cur["id"]) & 0x7FFFFFFF] = cur["data"]
            stack.extend(cur.values())
        elif isinstance(cur, list):
            stack.extend(cur)
    return out


def _resolve_ptr(node: dict, ids: dict | None):
    pw = node["ptr_wrapper"]
    if "data" in pw:
        return pw["data"]
    if ids is None or (int(pw["id"]) & 0x7FFFFFFF) not in ids:
        raise KeyError(f"unresolved ptr id {pw.get('id')}")
    return ids[int(pw["id"]) & 0x7FFFFFFF]


def _tower_arrays(poly_node: dict, ids: dict | None = None) -> OpenFhePoly:
    towers, moduli, roots = [], [], []
    for t in poly_node["v"]:
        data = t["v"]["ptr_wrapper"]["data"]
        towers.append(np.array([int(x) for x in data["v"]], dtype=np.uint64))
        moduli.append(int(data["m"]["v"]))
        p = _resolve_ptr(t["p"], ids)["value0"]
        ru = p.get("ru")
        roots.append(int(ru["v"]) if isinstance(ru, dict) and "v" in ru else 0)
    params = _resolve_ptr(poly_node["p"], ids)["value0"]
    return OpenFhePoly(
        towers=np.stack(towers),
        moduli=moduli,
        roots=roots,
        fmt=int(poly_node["f"]),
        ring_dim=int(params["rd"]),
    )


def _find_first(node, key: str):
    """DFS for the first dict containing `key` (cereal graphs nest deeply)."""
    stack = [node]
    while stack:
        cur = stack.pop()
        if isinstance(cur, dict):
            if key in cur:
                return cur[key]
            stack.extend(cur.values())
        elif isinstance(cur, list):
            stack.extend(cur)
    return None


def load_secret_key(path: str) -> OpenFhePoly:
    """client_*-private.key → the secret DCRTPoly `s` (EVAL format, 4 towers)."""
    with open(path) as f:
        doc = json.load(f)
    s = _find_first(doc, "s")
    if s is None or "v" not in s:
        raise ValueError(f"no secret poly found in {path}")
    return _tower_arrays(s)


def load_public_key(path: str) -> List[OpenFhePoly]:
    """PublicKey cereal-JSON (keyGen.cpp:45 format) → the two EVAL-format
    DCRTPolys (b, a) of the "h" member."""
    with open(path) as f:
        doc = json.load(f)
    h = _find_first(doc, "h")
    if h is None:
        raise ValueError(f"no public-key 'h' member in {path}")
    ids = build_id_index(doc)
    return [_tower_arrays(p, ids) for p in h]


def load_eval_key(path: str) -> List[List[OpenFhePoly]]:
    """EvalKey (PRE/relin) cereal-JSON (REkeyGen.cpp:60 format) → the "k"
    member as [b_polys, a_polys] (EvalKeyRelinImpl.m_rKey layout)."""
    with open(path) as f:
        doc = json.load(f)
    k = _find_first(doc, "k")
    if k is None:
        raise ValueError(f"no eval-key 'k' member in {path}")
    ids = build_id_index(doc)
    return [[_tower_arrays(p, ids) for p in row] for row in k]


def load_context_params(path: str) -> dict:
    """server/storage/CC.json → the interesting scalars (co, rd, batch,
    scaling mod size, technique enums)."""
    with open(path) as f:
        doc = json.load(f)
    out = {}
    for key in ("co", "rd"):
        out[key] = _find_first(doc, key)
    enp = _find_first(doc, "enp")
    if enp is not None:
        bs = _find_first(enp, "bs")
        out["batch_size"] = bs
    for key in ("rs", "ks", "dnum", "muld", "md", "slv", "ab", "eb"):
        v = _find_first(doc, key)
        if v is not None:
            out[key] = v
    return out


# ---------------------------------------------------------------------------
# Template-based emission (write-back)
#
# Emitting a cereal polymorphic graph from scratch is unverifiable without an
# OpenFHE binary (none exists in this environment), so emission is
# TEMPLATE-BASED: take a checked-in artifact with the identical graph
# structure, substitute the numeric payload, keep every structural field
# (polymorphic_id, ptr_wrapper ids, class versions) untouched. Verified by
# structural round-trip: emit(load(x), template=x) == parse(x)
# (tests/test_interop.py::test_secret_key_emission_roundtrip).
# ---------------------------------------------------------------------------


def save_secret_key(towers: np.ndarray, template_path: str, out_path: str) -> None:
    """Write an OpenFHE cereal-JSON private key whose secret DCRTPoly carries
    ``towers`` (u64[L, N], EVALUATION format), using ``template_path`` (a
    checked-in ``client_*-private.key``) for the surrounding graph.

    The template's modulus chain is kept — ``towers`` must be residues for
    exactly that chain (reference: keyGen.cpp:41-48 writes SerType::JSON).
    """
    with open(template_path) as f:
        doc = json.load(f)
    s = _find_first(doc, "s")
    if s is None or "v" not in s:
        raise ValueError(f"template {template_path} has no secret poly")
    if len(s["v"]) != towers.shape[0]:
        raise ValueError(
            f"tower count mismatch: template {len(s['v'])} vs {towers.shape[0]}")
    for i, t in enumerate(s["v"]):
        data = t["v"]["ptr_wrapper"]["data"]
        if len(data["v"]) != towers.shape[1]:
            raise ValueError("ring dimension mismatch with template")
        data["v"] = [int(x) for x in towers[i]]
    with open(out_path, "w") as f:
        json.dump(doc, f, indent=4)


def save_context(params: dict, template_path: str, out_path: str) -> None:
    """Write an OpenFHE cereal-JSON CryptoContext with scalar parameters
    substituted into a checked-in CC.json template. Supported keys mirror
    :func:`load_context_params` (muld/md depth, rs/ks techniques, dnum,
    batch_size → enp.bs). Structural graph fields are untouched."""
    with open(template_path) as f:
        doc = json.load(f)

    def sub_first(node, key, value) -> bool:
        stack = [node]
        while stack:
            cur = stack.pop()
            if isinstance(cur, dict):
                if key in cur and not isinstance(cur[key], (dict, list)):
                    cur[key] = value
                    return True
                stack.extend(cur.values())
            elif isinstance(cur, list):
                stack.extend(cur)
        return False

    for key, value in params.items():
        if key == "batch_size":
            enp = _find_first(doc, "enp")
            if enp is not None:
                sub_first(enp, "bs", int(value))
        else:
            sub_first(doc, key, int(value))
    with open(out_path, "w") as f:
        json.dump(doc, f, indent=4)
