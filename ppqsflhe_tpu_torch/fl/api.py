"""The federated-learning tools: the reference's seven binaries on files, and
the server's two tools in memory with the composed aggregation round.

Twin of ``ppqsflhe_tpu.fl.api`` (``:72-885``), with the same file contracts:

| reference binary                  | here                          |
|-----------------------------------|-------------------------------|
| genCC                             | :func:`gen_cc`                |
| keyGen                            | :func:`key_gen`               |
| REkeyGen                          | :func:`rekey_gen`             |
| encryptModelWeights               | :func:`encrypt_weights`       |
| decryptModelWeights               | :func:`decrypt_weights`       |
| changeCipherDomain                | :func:`change_cipher_domain`  |
| aggregateEncryptedWeights         | :func:`aggregate_encrypted_weights` |

and the seven threshold tools of the MULTIPARTY protocol
(``ppqsflhe_tpu.fl.api:565-800``, :mod:`..ckks.threshold`):
:func:`threshold_keygen`, :func:`threshold_combine_pubkey`,
:func:`threshold_partial_decrypt`, :func:`threshold_shamir_share`,
:func:`threshold_aggregate_shares`, :func:`threshold_partial_decrypt_t` and
:func:`threshold_fuse_decrypt`, with the JAX tools' documents
(``ckks_public_share``, ``ckks_partial_decryptions``, ``ckks_shamir_share``,
``ckks_sigma_share`` and the standard key documents).

Weights JSON: ``{"weights_summary": [{layer, shape, mean, std_dev,
values[]}…]}``; optimizer layers are skipped, values are chunked at the slot
count and the padding is trimmed on decrypt. The encrypted document holds
the same layers with ciphertext fields (Base64 PQTC blobs, or raw blobs in
the PQWD container, which every tool preserves; with ``wire="openfhe"``,
Base64 cereal-BINARY in JSON, the reference's wire). Each tool runs the
ciphertexts of a file as ONE stacked (B, 2, l, N) batch on ``device`` (the
card unless the caller names another). Noise comes from a
``torch.Generator``: with a seed, one seeded from it; without, one whose
whole mt19937 state is OS entropy. The 16-byte expansion seeds
(:func:`_derived_seed`) are the JAX tools', so for the same ``seed`` the
public key's ``a`` half and the seeded wire's c1 are bit-equal to theirs.

:func:`change_cipher_domain_batch` and :func:`aggregate_batch` are the
tools' compute cores on batched ciphertexts; :func:`server_round` composes
the round the way ``bench.py``'s ``server_round`` does in each of its five
schedules (``bench.py:178-222``).
"""

from __future__ import annotations

import base64
import functools
import hashlib
import json
import math
import os
from typing import Dict, List, Sequence

import numpy as np
import torch

from .. import convert
from ..ckks import eval as ev
from ..ckks import rlwe
from ..ckks import serialize as ser
from ..ckks import threshold as th
from ..ckks.params import CkksParams
from ..ckks.scheme import CkksScheme
from ..ckks.types import Ciphertext, KeySwitchKey

OPTIMIZER_PREFIX = "optimizer"  # layers skipped at encrypt time


# ---------------------------------------------------------------------------
# The server's tools in memory, and the composed round
# ---------------------------------------------------------------------------

def change_cipher_domain_batch(sch: CkksScheme, rekey: KeySwitchKey, cts: Ciphertext,
                               drop_limbs: int = 0, keep_limbs: int | None = None,
                               pk_to=None, gen: torch.Generator | None = None) -> Ciphertext:
    """ReEncrypt every ciphertext of the batch ``cts`` (data (B, 2, l, n))
    into the rekey's target domain, after an optional LevelReduce:
    ``drop_limbs`` removes top limbs, ``keep_limbs`` keeps exactly that many.
    The rekey should already be in Montgomery form (``ev.ksk_to_mont``).
    Under INDCCA ``pk_to`` and ``gen`` re-randomize each output."""
    l = cts.nlimbs
    if keep_limbs is not None:
        if not 1 <= keep_limbs <= l:
            raise ValueError(f"keep_limbs={keep_limbs} outside [1, {l}]")
        drop_limbs = l - keep_limbs
    if drop_limbs:
        if drop_limbs >= l:
            raise ValueError(f"cannot drop {drop_limbs} of {l} limbs")
        cts = ev.level_reduce(sch.ctx, cts, l - drop_limbs)
    return sch.re_encrypt(cts, rekey, pk_to, gen)


def aggregate_batch(sch: CkksScheme, stacks: Sequence[Ciphertext], lazy: bool) -> Ciphertext:
    """Homomorphic FedAvg over clients' batches, all in one key domain:
    Σ_i ct_i · (1/N). Every input is first LevelReduced to the common
    minimum level. With ``lazy`` and N a power of two, ÷N is exact scale
    metadata and one more limb is LevelReduced off the output; otherwise it
    is EvalMult(1/N) + rescale."""
    n_clients = len(stacks)
    scale = stacks[0].scale
    lmin = min(s.nlimbs for s in stacks)
    acc = ev.level_reduce(sch.ctx, stacks[0], lmin)
    for s in stacks[1:]:
        acc = ev.add(sch.ctx, acc, ev.level_reduce(sch.ctx, s, lmin))
    if lazy and (n_clients & (n_clients - 1)) == 0 and lmin > 1:
        return Ciphertext(acc.data[..., : lmin - 1, :], scale=scale * n_clients)
    return ev.mult_scalar(sch.ctx, acc, 1.0 / n_clients)


LAZY_MODES = (0, 1, 2, 3, 4)


def server_round(sch: CkksScheme, stack1: Ciphertext, stack2: Ciphertext,
                 rk12: KeySwitchKey, rk21: KeySwitchKey, lazy: int = 4):
    """The server's encrypted-aggregation round over two clients' batches:
    PRE 1→2, FedAvg, PRE back to 1, composed as ``bench.py:178-222``
    composes it in each schedule. Returns (average in client 2's domain,
    average re-encrypted to client 1); their scale is the one ``bench.py``
    decrypts at (the input's ×2 wherever ÷2 is free).

    - ``lazy=0``: the full level: PRE with every digit, add,
      mult_scalar(0.5) + rescale, PRE one level down;
    - ``lazy=1``: LevelReduce one limb first, then as 0;
    - ``lazy=2``: LevelReduce to one limb, ÷2 as scale metadata, both PREs
      at one limb;
    - ``lazy=3``: LevelReduce one limb, ÷2 as scale metadata, both PREs at
      that level;
    - ``lazy=4`` (the default): as 3, then a LevelReduce of one more limb
      before the PRE back."""
    if lazy not in LAZY_MODES:
        raise ValueError(f"lazy={lazy}: one of {LAZY_MODES}")
    L = sch.params.num_q
    drop = min(2 if lazy == 2 else min(lazy, 1), L - 1)
    c1in2 = change_cipher_domain_batch(sch, rk12, stack1, drop_limbs=drop)
    if lazy in (2, 3):
        s = ev.add(sch.ctx, c1in2, ev.level_reduce(sch.ctx, stack2, L - drop))
        avg = Ciphertext(s.data, scale=2 * s.scale)
    else:
        avg = aggregate_batch(sch, [c1in2, stack2], lazy=lazy == 4)
    return avg, change_cipher_domain_batch(sch, rk21, avg)


# ---------------------------------------------------------------------------
# Context, randomness, keys
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=4)
def _scheme_for(params: CkksParams, device: str) -> CkksScheme:
    return CkksScheme(params, device=device)


def load_scheme(cc_path: str, device="cuda") -> CkksScheme:
    return _scheme_for(ser.load_params(cc_path), str(torch.device(device)))


# torch's CPU generator state: seed (u64), left, seeded (i32), next (u64),
# then the 624 mt19937 words, each in a u64 slot
_MT_OFFSET, _MT_WORDS = 24, 624


def _rng(seed: int | None) -> torch.Generator:
    """The generator of a tool's noise and key material. An explicit seed
    keeps runs reproducible. Without one, long-term secrets must not be
    capped at the 64 bits ``manual_seed`` takes: the generator's whole
    mt19937 state (624 words) is filled from OS entropy."""
    gen = torch.Generator()
    if seed is not None:
        return gen.manual_seed(seed)
    state = gen.get_state()
    end = _MT_OFFSET + 8 * _MT_WORDS
    words = state[_MT_OFFSET:end].numpy().view(np.uint64)
    if state.numel() < end or (words >> np.uint64(32)).any():
        raise RuntimeError("unrecognised torch CPU generator state layout")
    fresh = np.frombuffer(os.urandom(4 * _MT_WORDS), dtype=np.uint32).astype(np.uint64)
    state[_MT_OFFSET:end] = torch.from_numpy(fresh.view(np.uint8).copy())
    gen.set_state(state)
    return gen


def _derived_seed(seed: int | None, tag: str) -> bytes:
    """16-byte expansion seed: OS entropy, or derived from an explicit seed
    exactly as the JAX tools derive it."""
    if seed is None:
        return os.urandom(16)
    return hashlib.blake2b(f"{tag}:{seed}".encode(), digest_size=16).digest()


def gen_cc(config: Dict | str, cc_out: str) -> CkksParams:
    """Build and write the shared context from the reference's
    config_cc.json schema ({multiplicative_depth, scaling_mod_size,
    batch_size, PREMode}) plus the optional ring_dim / first_mod_size /
    dnum / ntt_backend / ntt_impl / use_reference_chain keys; the backend
    defaults to radix-2, as in the JAX tool."""
    import dataclasses

    if isinstance(config, str):
        with open(config) as f:
            config = json.load(f)

    def pick(*names, default=None):
        for nm in names:
            if nm in config:
                return config[nm]
        return default

    depth = int(pick("multiplicative_depth", "mult_depth", default=2))
    scale_bits = int(pick("scaling_mod_size", "scale_bits", default=40))
    batch = int(pick("batch_size", "slots", default=0))
    n = int(pick("ring_dim", default=1 << 14))
    pre_mode = pick("PREMode", "pre_mode", default="INDCPA")
    if not 1 <= depth <= 20:
        raise ValueError(f"multiplicative_depth {depth} outside [1, 20]")
    if not 30 < scale_bits < 100:
        raise ValueError(f"scaling_mod_size {scale_bits} outside (30, 100)")
    if batch and not 0 < batch <= n // 2:
        raise ValueError(f"batch_size {batch} outside (0, ring_dim/2={n // 2}]")
    backend = dict(ntt_backend=pick("ntt_backend", default="radix2"),
                   ntt_impl=pick("ntt_impl", default="xla"))
    if pick("use_reference_chain", default=False):
        params = dataclasses.replace(CkksParams.reference(slots=batch or 8192), **backend)
    else:
        params = CkksParams.generate(n=n, mult_depth=depth, scale_bits=scale_bits,
                                     first_mod_bits=int(pick("first_mod_size", default=60)),
                                     dnum=int(pick("dnum", default=2)), slots=batch, **backend)
    params = dataclasses.replace(params, pre_mode=pre_mode)
    ser.save_params(params, cc_out)
    return params


def key_gen(cc_path: str, pub_out: str, priv_out: str, seed: int | None = None,
            device="cuda") -> None:
    """KeyGen and write both halves; the public key's uniform ``a`` half is
    seed-expanded, so its document ships b and the 16-byte seed."""
    sch = load_scheme(cc_path, device)
    a_seed = _derived_seed(seed, "pk_a")
    sk, pk = sch.keygen(_rng(seed), a_seed=a_seed)
    ser.save_json(ser.serialize_public_key(pk, a_seed=a_seed), pub_out)
    ser.save_json(ser.serialize_secret_key(sk), priv_out)


def rekey_gen(cc_path: str, own_priv: str, peer_pub: str, rekey_out: str,
              seed: int | None = None, device="cuda") -> None:
    """ReKeyGen(own sk, peer pk): the PRE key own → peer."""
    sch = load_scheme(cc_path, device)
    sk = ser.deserialize_secret_key(ser.load_json(own_priv), sch.ctx, device)
    pk = ser.deserialize_public_key(ser.load_json(peer_pub), sch.ctx, device)
    ser.save_json(ser.serialize_ksk(sch.rekey_gen(sk, pk, _rng(seed))), rekey_out)


# ---------------------------------------------------------------------------
# Ciphertexts on the wire
# ---------------------------------------------------------------------------

def _blobs_of(sch: CkksScheme, cts: Ciphertext, wire: str = "native",
              seeds=None) -> List[bytes]:
    """The wire bytes of every ciphertext of a batch, after one copy of the
    batch to the host: PQTC blobs (v3 where a seed is given) on the
    ``"native"`` wire, cereal-BINARY on the ``"openfhe"`` one (the
    reference's; it has no seeded form, so both components ship dense)."""
    host = cts.data.cpu()
    if wire == "openfhe":
        return [ser.ciphertext_to_bytes_openfhe(Ciphertext(d, cts.scale), sch.ctx)
                for d in host]
    if wire != "native":
        raise ValueError(f"wire={wire!r}: 'native' or 'openfhe'")
    seeds = seeds or [None] * host.shape[0]
    return [ser.ciphertext_to_bytes(Ciphertext(d, cts.scale), a_seed=s)
            for d, s in zip(host, seeds)]


def _field(blob: bytes, raw: bool):
    return blob if raw else base64.b64encode(blob).decode()


def _doc_fields(enc: Dict):
    """Every ciphertext field of an encrypted document in order, as
    (entry, field, value index or None, payload)."""
    for entry in enc["weights_summary"]:
        yield entry, "mean", None, entry["mean"]
        yield entry, "std_dev", None, entry["std_dev"]
        for vi, s in enumerate(entry["values"]):
            yield entry, "values", vi, s


def _raw(payload) -> bytes:
    return payload if isinstance(payload, (bytes, bytearray)) else base64.b64decode(payload)


def _load_cts(payloads, sch: CkksScheme) -> List[Ciphertext]:
    """Ciphertexts from wire payloads (Base64 or raw; PQTC of any version or
    OpenFHE cereal-BINARY). Dense blobs upload one by one; seeded v3 blobs
    expand their c1 in ONE batched transform per level."""
    dev = sch.device
    cts: List[Ciphertext | None] = []
    seeded: Dict[int, list] = {}
    for p in payloads:
        raw = _raw(p)
        if raw[:4] != ser.MAGIC:
            cts.append(ser.ciphertext_from_bytes_any(raw, sch.ctx, dev))
            continue
        data, seed, scale = ser.ciphertext_parts(raw)
        if seed is None:
            cts.append(Ciphertext(data=convert.residues(data, dev), scale=scale))
        else:
            seeded.setdefault(data.shape[0], []).append((len(cts), data, seed, scale))
            cts.append(None)
    for l, recs in seeded.items():
        a_all = rlwe.expand_a_batch(sch.ctx, [r[2] for r in recs], l, dev)
        c0_all = convert.residues(np.stack([r[1] for r in recs]), dev)
        for (pos, _, _, scale), c0, a in zip(recs, c0_all, a_all):
            cts[pos] = Ciphertext(data=torch.stack([c0, a]), scale=scale)
    return cts


def _stack(cts: Sequence[Ciphertext]) -> Ciphertext:
    """One batch (B, 2, l, n) of ciphertexts that share a level and scale."""
    shapes = {tuple(c.data.shape) for c in cts}
    scales = {float(c.scale) for c in cts}
    if len(shapes) != 1 or len(scales) != 1:
        raise ValueError(f"ciphertexts of one document differ in shape {sorted(shapes)} or "
                         f"scale {sorted(scales)}")
    return Ciphertext(data=torch.stack([c.data for c in cts]), scale=cts[0].scale)


# ---------------------------------------------------------------------------
# Weight encryption / decryption
# ---------------------------------------------------------------------------

def encrypt_weights(cc_path: str, pub_path: str, weights_in: str, enc_out: str,
                    seed: int | None = None, wire: str = "native",
                    container: str = "json", device="cuda") -> Dict:
    """Per layer, encrypt the scalar mean and std_dev and the values in
    slot-sized chunks, all as ONE batch. With the client's SECRET key file
    as ``pub_path`` (detected by its type), each chunk is sk-encrypted with
    a seed-expanded c1 and ships as a seeded v3 blob (c0 + 16-byte seed).
    ``container="bin"`` writes the PQWD container. ``wire="openfhe"`` writes
    every field as Base64(cereal-BINARY), the reference's wire: an
    sk-encryption then ships both components dense, always in a JSON
    document."""
    sch = load_scheme(cc_path, device)
    keydoc = ser.load_json(pub_path)
    sk_mode = keydoc.get("type") == "ckks_secret_key"
    with open(weights_in) as f:
        weights = json.load(f)

    slots = sch.encoder.slots
    vecs: List[np.ndarray] = []
    layout = []                         # (layer entry, value chunks)
    for entry in weights["weights_summary"]:
        if entry["layer"].startswith(OPTIMIZER_PREFIX):
            continue
        values = np.asarray(entry["values"], dtype=np.float64)
        vecs.append(np.array([entry["mean"]], np.float64))
        vecs.append(np.array([entry["std_dev"]], np.float64))
        nchunks = max(1, math.ceil(values.size / slots))
        vecs += [values[c * slots : (c + 1) * slots] for c in range(nchunks)]
        layout.append((entry, nchunks))

    pt = sch.make_plaintext(vecs)                 # (B, L, n), one batched NTT
    if sk_mode:
        sk = ser.deserialize_secret_key(keydoc, sch.ctx, device)
        seeds = [_derived_seed(seed if seed is None else seed + 7919 * j, f"ct_a:{j}")
                 for j in range(len(vecs))]
        cts = rlwe.encrypt_sk(sch.ctx, sk, pt, _rng(seed), seeds)
    else:
        seeds = None
        pk = ser.deserialize_public_key(keydoc, sch.ctx, device)
        cts = sch.encrypt(pk, pt, _rng(seed))
    blobs = iter(_blobs_of(sch, cts, wire, seeds))
    raw = container == "bin" and wire != "openfhe"
    out = {"weights_summary": []}
    for entry, nchunks in layout:
        out["weights_summary"].append({
            "layer": entry["layer"], "shape": entry["shape"],
            "mean": _field(next(blobs), raw), "std_dev": _field(next(blobs), raw),
            "values": [_field(next(blobs), raw) for _ in range(nchunks)]})
    ser.save_enc_doc(out, enc_out, binary=raw)
    return out


def decrypt_weights(cc_path: str, priv_path: str, enc_in: str, plain_out: str,
                    device="cuda") -> Dict:
    """Inverse of :func:`encrypt_weights`, trimming each layer's padding to
    prod(shape). The ciphertexts of one level, component count and scale
    decrypt as one batch."""
    sch = load_scheme(cc_path, device)
    sk = ser.deserialize_secret_key(ser.load_json(priv_path), sch.ctx, device)
    enc = ser.load_enc_doc(enc_in)
    fields = list(_doc_fields(enc))
    cts = _load_cts([f[3] for f in fields], sch)
    groups: Dict[tuple, List[int]] = {}
    for i, ct in enumerate(cts):
        groups.setdefault((ct.nlimbs, ct.num_components, float(ct.scale)), []).append(i)
    vals: Dict[int, np.ndarray] = {}
    for idxs in groups.values():
        batch = _stack([cts[i] for i in idxs])
        coeffs = rlwe.decrypt_to_coeffs(sch.ctx, sk.s_eval, batch).cpu()
        for i, co in zip(idxs, coeffs):
            vals[i] = rlwe.decode_coeffs(sch.ctx, co, cts[i], sch.encoder)

    out = {"weights_summary": []}
    recs: Dict[int, Dict] = {}
    for i, (entry, field, vi, _) in enumerate(fields):
        rec = recs.get(id(entry))
        if rec is None:
            rec = recs[id(entry)] = {"layer": entry["layer"], "shape": entry["shape"],
                                     "mean": 0.0, "std_dev": 0.0, "_vals": {}}
            out["weights_summary"].append(rec)
        if field == "values":
            rec["_vals"][vi] = vals[i]
        else:
            rec[field] = float(vals[i][0])
    for rec in out["weights_summary"]:
        size = int(np.prod(rec["shape"]))
        flat = np.concatenate([rec["_vals"][j] for j in sorted(rec["_vals"])])[:size]
        rec["values"] = [float(x) for x in flat]
        del rec["_vals"]
    with open(plain_out, "w") as f:
        json.dump(out, f)
    return out


# ---------------------------------------------------------------------------
# Server side: PRE + aggregation
# ---------------------------------------------------------------------------

# Device-resident rekey cache: a server applies the same long-lived
# re-encryption key every round. Keyed by (path, mtime, size, params,
# device), the Montgomery-form key skips the parse, upload and conversion
# on repeated rounds.
_REKEY_CACHE: Dict[tuple, KeySwitchKey] = {}


def _load_rekey_mont(sch: CkksScheme, rekey_path: str) -> KeySwitchKey:
    st = os.stat(rekey_path)
    key = (os.path.abspath(rekey_path), st.st_mtime_ns, st.st_size, sch.params,
           str(sch.device))
    rk = _REKEY_CACHE.get(key)
    if rk is None:
        if len(_REKEY_CACHE) > 16:          # bound device memory
            _REKEY_CACHE.clear()
        rk = _REKEY_CACHE[key] = ev.ksk_to_mont(
            sch.ctx, ser.deserialize_ksk(ser.load_json(rekey_path), sch.ctx, sch.device))
    return rk


def _write_back(enc: Dict, fields, blobs: Sequence[bytes], raw: bool) -> None:
    for (entry, field, vi, _), b in zip(fields, blobs):
        if field == "values":
            entry["values"][vi] = _field(b, raw)
        else:
            entry[field] = _field(b, raw)


def change_cipher_domain(cc_path: str, rekey_path: str, enc_in: str, enc_out: str,
                         pub_path: str | None = None, seed: int | None = None,
                         drop_limbs: int = 0, wire: str = "native",
                         keep_limbs: int | None = None, device="cuda") -> Dict:
    """ReEncrypt every ciphertext field as one batched key switch, after an
    optional LevelReduce (``drop_limbs``, or ``keep_limbs`` absolute).
    Under PREMode INDCCA ``pub_path`` (the TARGET domain's public key) is
    required: every output is re-randomized with Enc_pk(0) + flooding.
    The input's container is kept, except on the OpenFHE wire (JSON)."""
    sch = load_scheme(cc_path, device)
    rekey = _load_rekey_mont(sch, rekey_path)
    indcca = sch.params.pre_mode == "INDCCA"
    if indcca and pub_path is None:
        raise ValueError("PREMode INDCCA: changeCipherDomain needs the target domain's "
                         "public key (pub_path)")
    pk = (ser.deserialize_public_key(ser.load_json(pub_path), sch.ctx, device)
          if indcca else None)
    enc = ser.load_enc_doc(enc_in)
    fields = list(_doc_fields(enc))
    cts = _stack(_load_cts([f[3] for f in fields], sch))
    out = change_cipher_domain_batch(sch, rekey, cts, drop_limbs, keep_limbs, pk,
                                     _rng(seed) if indcca else None)
    binary = ser.doc_is_binary(enc_in) and wire != "openfhe"
    _write_back(enc, fields, _blobs_of(sch, out, wire), binary)
    ser.save_enc_doc(enc, enc_out, binary=binary)
    return enc


def aggregate_encrypted_weights(cc_path: str, enc_paths: Sequence[str], agg_out: str,
                                lazy: bool = False, wire: str = "native",
                                device="cuda") -> Dict:
    """Homomorphic FedAvg over N clients' documents in one key domain:
    layers matched by name AND shape (unmatched ones dropped), ct_avg =
    (Σ ct_i)·(1/N) as one batch. ``lazy``: for N a power of two, ÷N is
    exact scale metadata plus one more LevelReduce. The first input's
    container is kept, except on the OpenFHE wire (JSON)."""
    sch = load_scheme(cc_path, device)
    docs = [ser.load_enc_doc(p) for p in enc_paths]

    def key_of(e):
        return (e["layer"], tuple(e["shape"]))

    maps = [{key_of(e): e for e in d["weights_summary"]} for d in docs[1:]]
    per_client: List[list] = [[] for _ in docs]      # payloads, one list per client
    layout = []
    for entry in docs[0]["weights_summary"]:
        k = key_of(entry)
        if not all(k in m for m in maps):
            continue
        group = [entry] + [m[k] for m in maps]
        nv = min(len(e["values"]) for e in group)
        for c, e in enumerate(group):
            per_client[c] += [e["mean"], e["std_dev"]] + list(e["values"][:nv])
        layout.append(({"layer": entry["layer"], "shape": entry["shape"]}, nv))
    if not layout:
        raise ValueError("no layers matched by name AND shape across all clients — "
                         "federated averaging requires every client to train the same "
                         "architecture")
    loaded = [_load_cts(p, sch) for p in per_client]
    lmin = min(ct.nlimbs for cl in loaded for ct in cl)
    stacks = [_stack([ev.level_reduce(sch.ctx, ct, lmin) for ct in cl]) for cl in loaded]
    avg = aggregate_batch(sch, stacks, lazy)
    blobs = iter(_blobs_of(sch, avg, wire))
    binary = ser.doc_is_binary(enc_paths[0]) and wire != "openfhe"
    out = {"weights_summary": []}
    for rec, nv in layout:
        rec["mean"] = _field(next(blobs), binary)
        rec["std_dev"] = _field(next(blobs), binary)
        rec["values"] = [_field(next(blobs), binary) for _ in range(nv)]
        out["weights_summary"].append(rec)
    ser.save_enc_doc(out, agg_out, binary=binary)
    return out


# ---------------------------------------------------------------------------
# Threshold multiparty protocol (ckks/threshold.py)
# ---------------------------------------------------------------------------

def _array_doc(t: torch.Tensor, **fields) -> Dict:
    a = convert.residues_np(t)
    return dict(fields, shape=list(a.shape), data=ser._arr_to_b64(a))


def _doc_array(d: Dict, device) -> torch.Tensor:
    return convert.residues(ser._b64_to_arr(d["data"], d["shape"]), device)


def threshold_keygen(cc_path: str, crs_seed: int, priv_share_out: str, pub_share_out: str,
                     seed: int | None = None, device="cuda") -> None:
    """A party's round 1 of the joint key: derive the CRS from ``crs_seed``,
    sample a secret share and write it (standard secret-key document) and
    its public b-share."""
    sch = load_scheme(cc_path, device)
    a = th.common_random_poly(sch.ctx, crs_seed, sch.device)
    sk_i, b_i = th.partial_keygen(sch.ctx, a, _rng(seed))
    ser.save_json(ser.serialize_secret_key(sk_i), priv_share_out)
    ser.save_json(_array_doc(b_i, type="ckks_public_share", crs_seed=int(crs_seed)),
                  pub_share_out)


def threshold_combine_pubkey(cc_path: str, crs_seed: int, pub_share_paths: Sequence[str],
                             joint_pub_out: str, device="cuda") -> None:
    """The joint public key (Σ b_i, a), written as a standard public-key
    document that :func:`encrypt_weights` takes unchanged."""
    sch = load_scheme(cc_path, device)
    a = th.common_random_poly(sch.ctx, crs_seed, sch.device)
    shares = []
    for p in pub_share_paths:
        d = ser.load_json(p)
        if int(d.get("crs_seed", crs_seed)) != int(crs_seed):
            raise ValueError(f"{p}: public share was generated for a different CRS seed")
        shares.append(_doc_array(d, sch.device))
    ser.save_json(ser.serialize_public_key(th.joint_public_key(sch.ctx, a, shares)),
                  joint_pub_out)


def _partials_doc(enc: Dict, parts: torch.Tensor, **extra) -> Dict:
    """A ``ckks_partial_decryptions`` document: one Base64 array per
    ciphertext field of ``enc``, in its order."""
    host = convert.residues_np(parts)
    out = dict({"type": "ckks_partial_decryptions", "limbs": int(host.shape[1]),
                "n": int(host.shape[2])}, **extra)
    out["weights_summary"] = []
    i = 0
    for entry in enc["weights_summary"]:
        nv = len(entry["values"])
        out["weights_summary"].append({
            "layer": entry["layer"], "shape": entry["shape"],
            "mean": ser._arr_to_b64(host[i]), "std_dev": ser._arr_to_b64(host[i + 1]),
            "values": [ser._arr_to_b64(host[i + 2 + c]) for c in range(nv)]})
        i += 2 + nv
    return out


def _doc_batch(sch: CkksScheme, enc_in: str) -> tuple[Dict, Ciphertext]:
    enc = ser.load_enc_doc(enc_in)
    return enc, _stack(_load_cts([f[3] for f in _doc_fields(enc)], sch))


def threshold_partial_decrypt(cc_path: str, priv_share_path: str, enc_in: str,
                              partial_out: str, seed: int | None = None,
                              smudging_bits: int | None = None, device="cuda") -> Dict:
    """A party's decryption shares p_i = c1·s_i + e_flood of every
    ciphertext of an encrypted-weights document, as one batch."""
    sch = load_scheme(cc_path, device)
    sk = ser.deserialize_secret_key(ser.load_json(priv_share_path), sch.ctx, device)
    bits = th.DEFAULT_SMUDGING_BITS if smudging_bits is None else smudging_bits
    enc, cts = _doc_batch(sch, enc_in)
    out = _partials_doc(enc, th.partial_decrypt(sch.ctx, sk, cts, _rng(seed), bits))
    ser.save_json(out, partial_out)
    return out


def threshold_shamir_share(cc_path: str, priv_share_path: str, n_parties: int, t: int,
                           out_paths: Sequence[str], seed: int | None = None,
                           device="cuda") -> None:
    """Shamir-share this party's additive secret share among all N
    parties, t-of-N: one share document per recipient (out_paths[j−1] for
    party j)."""
    if len(out_paths) != n_parties:
        raise ValueError(f"need {n_parties} output paths, got {len(out_paths)}")
    sch = load_scheme(cc_path, device)
    sk = ser.deserialize_secret_key(ser.load_json(priv_share_path), sch.ctx, device)
    rows = th.shamir_share_secret(sch.ctx, sk, n_parties, t, _rng(seed))
    for j, path in enumerate(out_paths, start=1):
        ser.save_json(_array_doc(rows[j - 1], type="ckks_shamir_share", recipient=j,
                                 n_parties=n_parties, threshold=t), path)


def threshold_aggregate_shares(cc_path: str, incoming_paths: Sequence[str], sigma_out: str,
                               device="cuda") -> None:
    """Party j's σ_j = Σ_i f_i(j) from the shares every party sent it (all
    for the same recipient)."""
    sch = load_scheme(cc_path, device)
    docs = [ser.load_json(p) for p in incoming_paths]
    recips = {int(d["recipient"]) for d in docs}
    if len(recips) != 1:
        raise ValueError(f"shares target different recipients: {sorted(recips)}")
    sigma = th.aggregate_received_shares(
        sch.ctx, torch.stack([_doc_array(d, sch.device) for d in docs]))
    d0 = docs[0]
    ser.save_json(_array_doc(sigma, type="ckks_sigma_share", recipient=d0["recipient"],
                             n_parties=d0["n_parties"], threshold=d0["threshold"]), sigma_out)


def threshold_partial_decrypt_t(cc_path: str, sigma_path: str, enc_in: str, partial_out: str,
                                party_set: Sequence[int], party_id: int,
                                seed: int | None = None, smudging_bits: int | None = None,
                                device="cuda") -> Dict:
    """Party j's t-of-N decryption shares (λ_j·σ_j folded in) of every
    ciphertext of a document; fuse the t documents with
    :func:`threshold_fuse_decrypt`."""
    sch = load_scheme(cc_path, device)
    d = ser.load_json(sigma_path)
    if int(d["recipient"]) != int(party_id):
        raise ValueError(f"sigma share belongs to party {d['recipient']}, not {party_id}")
    if len(party_set) != int(d["threshold"]):
        raise ValueError(f"participating set size {len(party_set)} != threshold "
                         f"t={d['threshold']}")
    bits = th.DEFAULT_SMUDGING_BITS if smudging_bits is None else smudging_bits
    pset = tuple(int(x) for x in party_set)
    enc, cts = _doc_batch(sch, enc_in)
    parts = th.partial_decrypt_t(sch.ctx, _doc_array(d, sch.device), cts, pset, int(party_id),
                                 _rng(seed), bits)
    out = _partials_doc(enc, parts, party_set=list(pset))
    ser.save_json(out, partial_out)
    return out


def threshold_fuse_decrypt(cc_path: str, enc_in: str, partial_paths: Sequence[str],
                           plain_out: str, device="cuda") -> Dict:
    """The fusion over a document: per ciphertext iNTT(c0 + Σ_i p_i), then
    decode and trim each layer to prod(shape) (the output contract of
    :func:`decrypt_weights`)."""
    sch = load_scheme(cc_path, device)
    enc, cts = _doc_batch(sch, enc_in)
    l, n = cts.nlimbs, sch.params.n
    partials = []
    for p in partial_paths:
        doc = ser.load_json(p)
        flat = [ser._b64_to_arr(s, (l, n)) for _, _, _, s in _doc_fields(doc)]
        partials.append(convert.residues(np.stack(flat), sch.device))
    coeffs = th.fuse_partial_decryptions(sch.ctx, cts, partials).cpu()
    vals = [rlwe.decode_coeffs(sch.ctx, c, cts, sch.encoder) for c in coeffs]
    out = {"weights_summary": []}
    i = 0
    for entry in enc["weights_summary"]:
        nv = len(entry["values"])
        size = int(np.prod(entry["shape"]))
        flat = np.concatenate(vals[i + 2 : i + 2 + nv])[:size]
        out["weights_summary"].append({
            "layer": entry["layer"], "shape": entry["shape"],
            "mean": float(vals[i][0]), "std_dev": float(vals[i + 1][0]),
            "values": [float(x) for x in flat]})
        i += 2 + nv
    with open(plain_out, "w") as f:
        json.dump(out, f)
    return out
