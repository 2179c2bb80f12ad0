"""Serialization of contexts, keys and ciphertexts.

Twin of :mod:`ppqsflhe_tpu.ckks.serialize`, with the same formats byte for
byte, so either package reads what the other writes and re-emitting a
document gives the same bytes:

- the CC document (``"format": "ppqsflhe_tpu.ckks.v1"``, the file format's
  name); a document without ``ntt_backend`` reads as radix-2, as the JAX
  reader does;
- the key documents: secret keys as ternary coefficients, public keys and
  key-switch keys dense or seeded (``a_seed``: only the b half travels);
- the PQTC ciphertext blobs: v1 (raw u64), v2 (per-limb widths from the
  residues' actual maxima), v3 (seeded: packed c0 + the 16-byte seed);
- the encrypted-weights documents: JSON with Base64 fields, or the PQWD
  raw-binary container;
- the reference's OpenFHE wire: a ciphertext as cereal-BINARY
  (:mod:`.openfhe_emit`), written by :func:`ciphertext_to_b64_openfhe` and
  read, beside PQTC, by :func:`ciphertext_from_bytes_any`.

Residues cross as numpy ``uint64`` on the host and load as int64 tensors on
``device`` (the card unless the caller names another).
"""

from __future__ import annotations

import base64
import json
import struct
from typing import Any, Dict

import numpy as np
import torch

from ..convert import residues as _tensor
from ..convert import residues_np as _np
from .params import CkksContext, CkksParams
from .types import Ciphertext, KeySwitchKey, PublicKey, SecretKey

MAGIC = b"PQTC"  # ppqsflhe-tpu ciphertext
DOC_MAGIC = b"PQWD"


# -- params / context -------------------------------------------------------

def params_to_dict(p: CkksParams) -> Dict[str, Any]:
    return {
        "format": "ppqsflhe_tpu.ckks.v1",
        "ring_dim": p.n,
        "q_moduli": [str(q) for q in p.q_moduli],
        "p_moduli": [str(q) for q in p.p_moduli],
        "q_roots": [str(r) for r in p.q_roots] if p.q_roots else None,
        "p_roots": [str(r) for r in p.p_roots] if p.p_roots else None,
        "scale_bits": p.scale_bits,
        "dnum": p.dnum,
        "slots": p.slots,
        "sigma": p.sigma,
        "ntt_backend": p.ntt_backend,
        "ntt_impl": p.ntt_impl,
        "flexible_ext": p.flexible_ext,
        "pre_mode": p.pre_mode,
        "pre_flood_bits": p.pre_flood_bits,
    }


def params_from_dict(d: Dict[str, Any]) -> CkksParams:
    return CkksParams(
        n=d["ring_dim"],
        q_moduli=tuple(int(x) for x in d["q_moduli"]),
        p_moduli=tuple(int(x) for x in d["p_moduli"]),
        q_roots=tuple(int(x) for x in d["q_roots"]) if d.get("q_roots") else None,
        p_roots=tuple(int(x) for x in d["p_roots"]) if d.get("p_roots") else None,
        scale_bits=d["scale_bits"],
        dnum=d["dnum"],
        slots=d["slots"],
        sigma=d.get("sigma", 3.19),
        ntt_backend=d.get("ntt_backend", "radix2"),
        ntt_impl=d.get("ntt_impl", "xla"),
        flexible_ext=d.get("flexible_ext", False),
        pre_mode=d.get("pre_mode", "INDCPA"),
        pre_flood_bits=d.get("pre_flood_bits", 30),
    )


def save_params(p: CkksParams, path: str) -> None:
    with open(path, "w") as f:
        json.dump(params_to_dict(p), f, indent=1)


def load_params(path: str) -> CkksParams:
    with open(path) as f:
        return params_from_dict(json.load(f))


# -- array blobs ------------------------------------------------------------

def _arr_to_b64(a: np.ndarray) -> str:
    return base64.b64encode(np.asarray(a, dtype="<u8").tobytes()).decode()


def _b64_to_arr(s: str, shape) -> np.ndarray:
    return np.frombuffer(base64.b64decode(s), dtype="<u8").reshape(shape).copy()


# -- keys -------------------------------------------------------------------

def serialize_secret_key(sk: SecretKey) -> Dict[str, Any]:
    """Only the ternary coefficients travel; the eval form is re-derived
    from the context on load."""
    return {
        "type": "ckks_secret_key",
        "s_int": base64.b64encode(np.asarray(sk.s_int, np.int8).tobytes()).decode(),
    }


def deserialize_secret_key(d: Dict[str, Any], ctx: CkksContext, device="cuda") -> SecretKey:
    from ..core import sampling

    s_int = np.frombuffer(base64.b64decode(d["s_int"]), dtype=np.int8).copy()
    coeff = sampling.signed_to_rns(torch.from_numpy(s_int.astype(np.int32)).to(device),
                                   ctx.moduli_qp)
    return SecretKey(s_eval=ctx.ntt(coeff, tuple(range(len(ctx.moduli_qp)))), s_int=s_int)


def serialize_public_key(pk: PublicKey, a_seed: bytes | None = None) -> Dict[str, Any]:
    """With ``a_seed`` (the seed given to keygen) only the b half travels;
    the a half re-expands on load."""
    if a_seed is not None:
        return {"type": "ckks_public_key", "shape": list(pk.data.shape),
                "b": _arr_to_b64(_np(pk.data[0])), "a_seed": a_seed.hex()}
    return {"type": "ckks_public_key", "shape": list(pk.data.shape),
            "data": _arr_to_b64(_np(pk.data))}


def deserialize_public_key(d: Dict[str, Any], ctx: CkksContext | None = None,
                           device="cuda") -> PublicKey:
    if "a_seed" in d:
        if ctx is None:
            raise ValueError("seeded public key needs a context to re-expand a — pass ctx")
        from .rlwe import expand_a

        shape = d["shape"]
        b = _tensor(_b64_to_arr(d["b"], shape[1:]), device)
        a = expand_a(ctx, bytes.fromhex(d["a_seed"]), shape[1], device)
        return PublicKey(data=torch.stack([b, a]))
    return PublicKey(data=_tensor(_b64_to_arr(d["data"], d["shape"]), device))


def serialize_ksk(k: KeySwitchKey, a_seed: bytes | None = None) -> Dict[str, Any]:
    """With ``a_seed`` (the seed given to keyswitch_key_gen) only the b rows
    travel; each digit's a row re-expands on load."""
    if k.mont:
        raise ValueError("serialize the key-switch key before its Montgomery conversion")
    if a_seed is not None:
        return {"type": "ckks_keyswitch_key", "shape": list(k.data.shape),
                "b": _arr_to_b64(_np(k.data[:, 0])), "a_seed": a_seed.hex()}
    return {"type": "ckks_keyswitch_key", "shape": list(k.data.shape),
            "data": _arr_to_b64(_np(k.data))}


def deserialize_ksk(d: Dict[str, Any], ctx: CkksContext | None = None,
                    device="cuda") -> KeySwitchKey:
    if "a_seed" in d:
        if ctx is None:
            raise ValueError("seeded keyswitch key needs a context to re-expand its a rows "
                             "— pass ctx")
        from .eval import _ksk_digit_seed
        from .rlwe import expand_a_batch

        nd, _, LK, n = d["shape"]
        seed = bytes.fromhex(d["a_seed"])
        b = _tensor(_b64_to_arr(d["b"], (nd, LK, n)), device)
        a = expand_a_batch(ctx, [_ksk_digit_seed(seed, j) for j in range(nd)], LK, device)
        return KeySwitchKey(data=torch.stack([b, a], dim=1))
    return KeySwitchKey(data=_tensor(_b64_to_arr(d["data"], d["shape"]), device))


def save_json(obj: Dict[str, Any], path: str) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)


def load_json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


# -- ciphertexts (binary, Base64-wrapped by callers) ------------------------
#
# Header: MAGIC + <IIIId (version, k, l, n, scale). v1: raw little-endian u64
# residues. v2: per-limb byte widths from the residues' actual maxima, then
# the limbs packed. v3 (seeded): the widths, the 16-byte seed, then c0's
# limbs; readers regenerate c1 = expand_a(seed) (needs a context).

def _pack_limb(a: np.ndarray, width: int) -> bytes:
    raw = np.ascontiguousarray(a.astype("<u8")).view(np.uint8).reshape(-1, 8)
    return raw[:, :width].tobytes()


def _unpack_limb(b: bytes, width: int, n: int) -> np.ndarray:
    if width == 8:
        return np.frombuffer(b, dtype="<u8", count=n).copy()
    raw = np.frombuffer(b, dtype=np.uint8, count=n * width).reshape(n, width)
    out = np.zeros((n, 8), np.uint8)
    out[:, :width] = raw
    return out.view("<u8")[:, 0].copy()


def _widths(limbs) -> bytes:
    return bytes(max(1, (int(a.max()).bit_length() + 7) // 8) if a.size else 8 for a in limbs)


def ciphertext_to_bytes(ct: Ciphertext, version: int = 2,
                        a_seed: bytes | None = None) -> bytes:
    """One ciphertext (data (k, l, n)) as a PQTC blob: v2 by default, v3
    with ``a_seed`` (the caller guarantees c1 == expand_a(a_seed, l)), v1
    with ``version=1``."""
    data = _np(ct.data)
    k, l, n = data.shape
    if version == 1:
        return MAGIC + struct.pack("<IIIId", 1, k, l, n, float(ct.scale)) + data.astype(
            "<u8").tobytes()
    if a_seed is not None:
        if k != 2 or len(a_seed) != 16:
            raise ValueError("seeded wire needs a 2-component ct + 16B seed")
        widths = _widths(data[0])
        header = MAGIC + struct.pack("<IIIId", 3, k, l, n, float(ct.scale)) + widths + a_seed
        return header + b"".join(_pack_limb(data[0, i], widths[i]) for i in range(l))
    widths = _widths(data[:, i] for i in range(l))
    header = MAGIC + struct.pack("<IIIId", 2, k, l, n, float(ct.scale)) + widths
    return header + b"".join(_pack_limb(data[:, i].ravel(), widths[i]) for i in range(l))


def ciphertext_parts(b: bytes):
    """Parse a PQTC blob without a context: (data, seed, scale) with data
    u64[k, l, n] and seed None for v1/v2, c0 u64[l, n] and the 16-byte seed
    for v3. Raises "bad ciphertext magic" for anything else."""
    if b[:4] != MAGIC:
        raise ValueError("bad ciphertext magic: not a PQTC blob")
    ver, k, l, n, scale = struct.unpack("<IIIId", b[4:28])
    if ver == 1:
        return np.frombuffer(b[28:], dtype="<u8").reshape(k, l, n).copy(), None, scale
    if ver not in (2, 3):
        raise ValueError(f"unsupported ciphertext version {ver}")
    widths = b[28 : 28 + l]
    off = 28 + l
    seed = None
    if ver == 3:
        seed, off, k = b[off : off + 16], off + 16, 1
    data = np.zeros((k, l, n), np.uint64)
    for i in range(l):
        data[:, i] = _unpack_limb(b[off:], widths[i], k * n).reshape(k, n)
        off += k * n * widths[i]
    return (data[0], seed, scale) if ver == 3 else (data, None, scale)


def ciphertext_seeded_parts(b: bytes):
    """For a v3 (seeded) blob: (c0 u64[l, n], seed, scale) without expanding
    c1, so callers can batch many expansions. None for any other blob."""
    if b[:4] != MAGIC or struct.unpack("<I", b[4:8])[0] != 3:
        return None
    return ciphertext_parts(b)


def ciphertext_from_bytes(b: bytes, ctx: CkksContext | None = None,
                          device="cuda") -> Ciphertext:
    data, seed, scale = ciphertext_parts(b)
    if seed is None:
        return Ciphertext(data=_tensor(data, device), scale=scale)
    if ctx is None:
        raise ValueError("seeded (v3) ciphertext needs a context to re-expand c1 — pass ctx")
    from .rlwe import expand_a

    a = expand_a(ctx, seed, data.shape[0], device)
    return Ciphertext(data=torch.stack([_tensor(data, device), a]), scale=scale)


def ciphertext_to_b64(ct: Ciphertext, a_seed: bytes | None = None) -> str:
    return base64.b64encode(ciphertext_to_bytes(ct, a_seed=a_seed)).decode()


def ciphertext_from_b64(s: str, ctx: CkksContext | None = None, device="cuda") -> Ciphertext:
    return ciphertext_from_bytes(base64.b64decode(s), ctx, device)


# -- the OpenFHE wire (cereal-BINARY ciphertexts) ---------------------------

def _openfhe_emitter(ctx: CkksContext):
    """The context's cereal emitter over the Q chain, made once."""
    em = getattr(ctx, "_openfhe_emitter", None)
    if em is None:
        from .openfhe_emit import OpenFheEmitter

        L = ctx.params.num_q
        em = ctx._openfhe_emitter = OpenFheEmitter(
            ctx.params.n, list(ctx.params.q_moduli), [int(p) for p in ctx.basis.psis[:L]],
            batch_size=ctx.params.slots, scaling_mod_size=ctx.params.scale_bits,
            mult_depth=ctx.params.num_q - 1, dnum=ctx.params.dnum, sigma=ctx.params.sigma)
    return em


def ciphertext_to_bytes_openfhe(ct: Ciphertext, ctx: CkksContext,
                                key_tag: str = "ppqsflhe") -> bytes:
    """One ciphertext (data (k, l, n)) as cereal-BINARY, the reference's
    wire (``Serial::Serialize(ct, BINARY)``); a level-reduced ciphertext
    carries its truncated chain, as OpenFHE's do."""
    l = ct.nlimbs
    return _openfhe_emitter(ctx).ciphertext_binary(
        _np(ct.data), scale=float(ct.scale), level=ctx.params.num_q - l, key_tag=key_tag,
        moduli=list(ctx.params.q_moduli[:l]), roots=[int(p) for p in ctx.basis.psis[:l]])


def ciphertext_to_b64_openfhe(ct: Ciphertext, ctx: CkksContext,
                              key_tag: str = "ppqsflhe") -> str:
    """Base64(cereal-BINARY): :func:`ciphertext_to_bytes_openfhe` as the
    reference's tools write it into a document."""
    return base64.b64encode(ciphertext_to_bytes_openfhe(ct, ctx, key_tag)).decode()


def ciphertext_from_b64_any(s: str, ctx: CkksContext | None = None,
                            device="cuda") -> Ciphertext:
    """Either wire's ciphertext, Base64-wrapped: a PQTC blob or OpenFHE
    cereal-BINARY (told apart by the leading bytes)."""
    return ciphertext_from_bytes_any(base64.b64decode(s), ctx, device)


def ciphertext_from_bytes_any(b: bytes, ctx: CkksContext | None = None,
                              device="cuda") -> Ciphertext:
    if b[:4] == MAGIC:
        return ciphertext_from_bytes(b, ctx, device)
    from .openfhe_emit import parse_ciphertext_binary

    try:
        rec = parse_ciphertext_binary(b)
    except Exception as e:
        # a corrupted or foreign blob would otherwise surface as a bare
        # AssertionError from deep inside the cereal parser
        raise ValueError(
            "bad ciphertext magic: not a PQTC blob and not parseable as "
            f"OpenFHE cereal BINARY ({type(e).__name__})") from e
    return Ciphertext(data=_tensor(rec["towers"], device), scale=rec["scale"])


# -- encrypted-weights documents (JSON or raw-binary container) -------------
#
# PQWD magic + u32 header length + JSON header (the document with each
# ciphertext field replaced by a blob index, plus "blob_lens") + the raw
# blobs. Readers detect the container by its magic.

def save_enc_doc(doc: Dict[str, Any], path: str, binary: bool = False) -> None:
    """Write an encrypted-weights document: reference-shaped JSON with
    Base64 ciphertext fields, or (``binary``) the PQWD container, whose
    fields may arrive as Base64 strings or raw bytes."""
    if not binary:
        with open(path, "w") as f:
            json.dump(doc, f)
        return
    blobs: list[bytes] = []

    def take(v) -> int:
        blobs.append(base64.b64decode(v) if isinstance(v, str) else bytes(v))
        return len(blobs) - 1

    head = {k: v for k, v in doc.items() if k != "weights_summary"}
    head["weights_summary"] = [
        {**{k: v for k, v in e.items() if k not in ("mean", "std_dev", "values")},
         "mean": take(e["mean"]), "std_dev": take(e["std_dev"]),
         "values": [take(s) for s in e["values"]]}
        for e in doc["weights_summary"]
    ]
    head["blob_lens"] = [len(b) for b in blobs]
    hb = json.dumps(head).encode()
    with open(path, "wb") as f:
        f.write(DOC_MAGIC + struct.pack("<I", len(hb)) + hb)
        for b in blobs:
            f.write(b)


def load_enc_doc(path: str) -> Dict[str, Any]:
    """Read an encrypted-weights document in either container; the PQWD
    container yields raw ``bytes`` ciphertext fields."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != DOC_MAGIC:
        return json.loads(data.decode())
    (hlen,) = struct.unpack("<I", data[4:8])
    head = json.loads(data[8 : 8 + hlen].decode())
    lens = head.pop("blob_lens")
    offs = [8 + hlen]
    for ln in lens:
        offs.append(offs[-1] + ln)

    def blob(i: int) -> bytes:
        return data[offs[i] : offs[i] + lens[i]]

    for e in head["weights_summary"]:
        e["mean"] = blob(e["mean"])
        e["std_dev"] = blob(e["std_dev"])
        e["values"] = [blob(i) for i in e["values"]]
    return head


def doc_is_binary(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(4) == DOC_MAGIC
