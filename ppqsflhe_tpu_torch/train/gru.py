"""GRU forecaster in torch with the Keras weight layout.

Twin of ``ppqsflhe_tpu.train.gru`` (the reference's Keras model,
client/src/c_trainAndUpdate.py:47-56: GRU(64, return_sequences) →
Dropout(0.3) → GRU(64) → Dropout(0.3) → Dense(1), l2(0.01) on the first GRU
kernel). The parameters are registered in ``keras.Model.get_weights()``
order and shapes — kernel W (F, 3H) with gate order [z, r, h], recurrent
kernel U (H, 3H), bias b (2, 3H) input/recurrent halves per layer, then Wd
(H, 1), bd (1,) — so ``list(model.parameters())`` is the exported weight
list (39,041 values for 7 features, hidden 64). The cell is written in
torch ops (reset_after=True); ``nn.GRU`` orders its gates [r, z, n] and
would need every export permuted.

Randomness comes from explicit ``torch.Generator`` objects: the
initializers draw from a CPU generator, dropout from one on the model's
device (``torch.bernoulli``; ``F.dropout`` takes no generator).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
from torch import nn

HIDDEN = 64


def _glorot(gen: torch.Generator, shape) -> torch.Tensor:
    limit = float(np.sqrt(6.0 / (shape[0] + shape[1])))
    return (torch.rand(tuple(shape), generator=gen) * 2 - 1) * limit


def _orthogonal(gen: torch.Generator, shape) -> torch.Tensor:
    """Keras recurrent initializer: per-gate orthogonal blocks, each Q of a
    Gaussian's QR with the sign of R's diagonal folded in."""
    h, w = shape
    blocks = []
    for _ in range(w // h):
        q, r = torch.linalg.qr(torch.randn((h, h), generator=gen))
        blocks.append(q * torch.sign(torch.diagonal(r)))
    return torch.cat(blocks, dim=1)


def dropout(h: torch.Tensor, rate: float, gen: torch.Generator) -> torch.Tensor:
    """Inverted dropout with an explicit generator: keep with 1 - rate,
    scale the kept values by 1 / (1 - rate)."""
    keep = torch.bernoulli(torch.full_like(h, 1.0 - rate), generator=gen)
    return h * keep / (1.0 - rate)


def _param(t) -> nn.Parameter:
    return nn.Parameter(torch.as_tensor(t, dtype=torch.float32).detach().clone())


class ParamListModel(nn.Module):
    """A model whose parameters are one list in export order (copied in);
    each family reads its widths off the shapes."""

    def __init__(self, params: Sequence[torch.Tensor]):
        super().__init__()
        self.weights = nn.ParameterList([_param(p) for p in params])

    def param_list(self) -> List[torch.Tensor]:
        return list(self.weights)


def _gru_layer(x_seq, W, U, b, return_sequences: bool):
    """x_seq (B, T, F) → (B, T, H) or (B, H); Keras GRU cell, reset_after,
    gate order [z, r, hh]. The input projection runs once for all steps."""
    hidden = U.shape[0]
    xw = x_seq @ W + b[0]
    h = x_seq.new_zeros((x_seq.shape[0], hidden))
    hs = []
    for t in range(x_seq.shape[1]):
        hu = torch.addmm(b[1], h, U)
        x_t = xw[:, t]
        zr = torch.sigmoid(x_t[:, : 2 * hidden] + hu[:, : 2 * hidden])
        z, r = zr[:, :hidden], zr[:, hidden:]
        cand = torch.tanh(x_t[:, 2 * hidden :] + r * hu[:, 2 * hidden :])
        h = z * h + (1.0 - z) * cand
        if return_sequences:
            hs.append(h)
    return torch.stack(hs, dim=1) if return_sequences else h


class Model(ParamListModel):
    """[W1, U1, b1, W2, U2, b2, Wd, bd]."""

    def forward(self, x, train: bool = False, generator: torch.Generator | None = None,
                dropout_rate: float = 0.3):
        """(B, T, F) → (B,) predictions; dropout only with ``train`` and a
        generator on the model's device."""
        p = self.param_list()
        drop = train and dropout_rate > 0 and generator is not None
        h = _gru_layer(x, p[0], p[1], p[2], True)
        if drop:
            h = dropout(h, dropout_rate, generator)
        h = _gru_layer(h, p[3], p[4], p[5], False)
        if drop:
            h = dropout(h, dropout_rate, generator)
        return (h @ p[6] + p[7])[:, 0]


def init_params(gen: torch.Generator, n_features: int, hidden: int = HIDDEN) -> List[torch.Tensor]:
    """[W1, U1, b1, W2, U2, b2, Wd, bd] — Keras get_weights() order."""
    return [
        _glorot(gen, (n_features, 3 * hidden)),
        _orthogonal(gen, (hidden, 3 * hidden)),
        torch.zeros((2, 3 * hidden)),
        _glorot(gen, (hidden, 3 * hidden)),
        _orthogonal(gen, (hidden, 3 * hidden)),
        torch.zeros((2, 3 * hidden)),
        _glorot(gen, (hidden, 1)),
        torch.zeros((1,)),
    ]


def params_to_summary(params) -> list:
    """model.get_weights() → weights_summary records (c_trainAndUpdate.py
    :175-190: layer=param_{idx}, shape, mean, std_dev, flat values)."""
    out = []
    for idx, arr in enumerate(params):
        a = (arr.detach().cpu().numpy() if isinstance(arr, torch.Tensor)
             else np.asarray(arr)).astype(np.float32)
        out.append({
            "layer": f"param_{idx}",
            "shape": list(a.shape),
            "mean": float(a.mean()),
            "std_dev": float(a.std()),
            "values": [float(x) for x in a.flatten()],
        })
    return out


def summary_to_params(summary: list, device="cuda") -> List[torch.Tensor]:
    """reconstruct_model_from_json equivalent (c_trainAndUpdate.py:65-78)."""
    return [torch.from_numpy(np.asarray(e["values"], np.float32).reshape(e["shape"])).to(device)
            for e in summary]
