"""Transformer-encoder forecaster in torch (fourth model family).

Twin of ``ppqsflhe_tpu.train.transformer``: Dense embed → sinusoidal
positions → N_LAYERS × (pre-LN multi-head self-attention + pre-LN FFN,
residuals) → last-token Dense(1) head, with the JAX model's flat parameter
list (Keras dense layout: kernel (in, out), bias (out,)). The attention is
the plain matmul and softmax of the JAX ``_mha``.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List

import numpy as np
import torch

from .gru import ParamListModel, _glorot, dropout

HIDDEN = 64          # d_model
N_LAYERS = 2
N_HEADS = 4
FFN_MULT = 2

# per-layer param slots (after the 2 embed params):
#   Wq, Wk, Wv, Wo, bo, W1, b1, W2, b2, g1, be1, g2, be2
_PER_LAYER = 13


def init_params(gen: torch.Generator, n_features: int, hidden: int = HIDDEN,
                n_layers: int = N_LAYERS) -> List[torch.Tensor]:
    d = int(hidden)
    params: List[torch.Tensor] = [_glorot(gen, (n_features, d)), torch.zeros((d,))]
    for _ in range(n_layers):
        params += [
            _glorot(gen, (d, d)),               # Wq
            _glorot(gen, (d, d)),               # Wk
            _glorot(gen, (d, d)),               # Wv
            _glorot(gen, (d, d)),               # Wo
            torch.zeros((d,)),                  # bo
            _glorot(gen, (d, FFN_MULT * d)),    # W1
            torch.zeros((FFN_MULT * d,)),       # b1
            _glorot(gen, (FFN_MULT * d, d)),    # W2
            torch.zeros((d,)),                  # b2
            torch.ones((d,)),                   # ln1 scale
            torch.zeros((d,)),                  # ln1 bias
            torch.ones((d,)),                   # ln2 scale
            torch.zeros((d,)),                  # ln2 bias
        ]
    params += [_glorot(gen, (d, 1)), torch.zeros((1,))]
    return params


@lru_cache(maxsize=None)
def _positions(t: int, d: int, device: torch.device) -> torch.Tensor:
    """The (t, d) sinusoidal table, uploaded once per device and kept: a
    step on the card must not copy from the host (a CUDA graph reads the
    table by address)."""
    pos = np.arange(t)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / d)
    pe = np.zeros((t, d), np.float32)
    pe[:, 0::2] = np.sin(ang)
    pe[:, 1::2] = np.cos(ang)
    return torch.from_numpy(pe).to(device)


def _layernorm(x, scale, bias, eps: float = 1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * scale + bias


def _mha(x, Wq, Wk, Wv, Wo, bo, n_heads: int):
    b, t, d = x.shape
    hd = d // n_heads

    def split(z):  # (b, t, d) → (b, heads, t, hd)
        return z.reshape(b, t, n_heads, hd).permute(0, 2, 1, 3)

    q, k, v = split(x @ Wq), split(x @ Wk), split(x @ Wv)
    att = torch.softmax(q @ k.transpose(-1, -2) / float(np.sqrt(float(hd))), dim=-1)
    out = (att @ v).permute(0, 2, 1, 3).reshape(b, t, d)
    return out @ Wo + bo


class Model(ParamListModel):
    """[We, be] + N_LAYERS × 13 slots + [Wd, bd]."""

    def forward(self, x, train: bool = False, generator: torch.Generator | None = None,
                dropout_rate: float = 0.1):
        """x: (B, lookback, F) → (B,) prediction."""
        params = self.param_list()
        drop = train and generator is not None
        h = x @ params[0] + params[1]
        h = h + _positions(h.shape[1], h.shape[2], h.device)
        n_layers = (len(params) - 4) // _PER_LAYER
        for li in range(n_layers):
            p = params[2 + li * _PER_LAYER : 2 + (li + 1) * _PER_LAYER]
            Wq, Wk, Wv, Wo, bo, W1, b1, W2, b2, g1, be1, g2, be2 = p
            a = _mha(_layernorm(h, g1, be1), Wq, Wk, Wv, Wo, bo, N_HEADS)
            if drop:
                a = dropout(a, dropout_rate, generator)
            h = h + a
            f = _layernorm(h, g2, be2)
            f = torch.relu(f @ W1 + b1) @ W2 + b2
            if drop:
                f = dropout(f, dropout_rate, generator)
            h = h + f
        return (h[:, -1, :] @ params[-2] + params[-1])[:, 0]


def num_params(params) -> int:
    return sum(int(np.prod(p.shape)) for p in params)
