"""Carry state between the JAX package and the port.

Everything crosses as numpy arrays and plain Python values, so this module
imports neither package's framework beyond torch: residues are numpy
``uint64`` on the JAX side and ``torch.int64`` (same bits) here. A caller
holding JAX objects passes ``np.asarray(...)`` of their arrays. Tensors land
on the card unless the caller names another ``device``.

Both evaluation orders cross: the params carry ``ntt_backend``, so keys and
ciphertexts stay in the order their context was made for. Every four-step
``ntt_impl`` gives the same evaluations: ``"pallas"`` runs the port's
butterfly transform, the others (``"xla"``, ``"mxu"``, ``"pallas_mxu"``)
its digit-matmul route.

A model family's parameter list (``train/``, Keras layout, float32) crosses
as a list of numpy arrays: :func:`train_params` and :func:`train_params_np`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ckks.params import CkksParams
from .ckks.types import Ciphertext, KeySwitchKey, PublicKey, SecretKey

_PORT_FIELDS = tuple(f.name for f in dataclasses.fields(CkksParams))


def residues(a, device="cuda") -> torch.Tensor:
    """numpy uint64 residues → int64 tensor (same bits) on ``device``."""
    a = np.array(a, dtype=np.uint64, order="C", copy=True)    # owned, writable
    return torch.from_numpy(a.view(np.int64)).to(device)


def residues_np(t: torch.Tensor) -> np.ndarray:
    """int64 tensor → numpy uint64 residues (same bits)."""
    return t.detach().cpu().contiguous().numpy().view(np.uint64)


def params(fields: dict) -> CkksParams:
    """The port's params from the JAX ``CkksParams`` fields
    (``dataclasses.asdict`` of it)."""
    kw = {k: fields[k] for k in _PORT_FIELDS if k in fields}
    for k in ("q_moduli", "p_moduli", "q_roots", "p_roots"):
        if kw.get(k) is not None:
            kw[k] = tuple(int(v) for v in kw[k])
    return CkksParams(**kw)


def params_fields(p: CkksParams) -> dict:
    """Keyword arguments for the JAX ``CkksParams`` that matches ``p``."""
    return dataclasses.asdict(p)


def secret_key(s_eval, s_int, device="cuda") -> SecretKey:
    return SecretKey(s_eval=residues(s_eval, device), s_int=np.asarray(s_int, np.int8))


def public_key(data, device="cuda") -> PublicKey:
    return PublicKey(data=residues(data, device))


def keyswitch_key(data, mont: bool = False, device="cuda") -> KeySwitchKey:
    return KeySwitchKey(data=residues(data, device), mont=bool(mont))


def rotation_keys(keys: dict, mont: bool = False, device="cuda") -> dict:
    """JAX rotation keys as {rotation: numpy data} → {rotation: KeySwitchKey}."""
    return {int(r): keyswitch_key(a, mont, device) for r, a in keys.items()}


def ciphertext(data, scale: float, device="cuda") -> Ciphertext:
    return Ciphertext(data=residues(data, device), scale=float(scale))


def to_numpy(obj) -> dict:
    """A port key or ciphertext → its fields as numpy / plain values, named
    as the JAX type's constructor arguments; a dict of keys (rotation keys)
    → the same dict of such fields."""
    if isinstance(obj, dict):
        return {k: to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, SecretKey):
        return {"s_eval": residues_np(obj.s_eval), "s_int": np.asarray(obj.s_int)}
    if isinstance(obj, PublicKey):
        return {"data": residues_np(obj.data)}
    if isinstance(obj, KeySwitchKey):
        return {"data": residues_np(obj.data), "mont": obj.mont}
    if isinstance(obj, Ciphertext):
        return {"data": residues_np(obj.data), "scale": obj.scale}
    raise TypeError(f"cannot convert {type(obj).__name__}")


def train_params(arrays, device="cuda") -> list:
    """A JAX model's parameter list (numpy, Keras layout) → float32 tensors
    on ``device``, in the same order; ``Model(params)`` of the matching
    family in ``train/`` computes from them."""
    return [torch.from_numpy(np.array(a, dtype=np.float32, copy=True)).to(device)
            for a in arrays]


def train_params_np(params) -> list:
    """The port's parameter list (tensors, or a model's ``param_list()``) →
    float32 numpy arrays, for the JAX model of the same family."""
    return [p.detach().cpu().numpy().astype(np.float32) for p in params]
