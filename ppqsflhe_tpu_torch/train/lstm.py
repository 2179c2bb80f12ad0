"""Stacked-LSTM forecaster in torch (Keras weight layout).

Twin of ``ppqsflhe_tpu.train.lstm``: LSTM(h) → LSTM(h) → Dense(1), kernel
(F, 4H), recurrent (H, 4H), bias (4H,) per layer with gate order [i, f, c,
o] and unit_forget_bias; ``init_params(n_features=7, hidden=300)`` gives
the 1,091,101 parameters of ``BASELINE.json`` config 5. No dropout, as in
the JAX model.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .gru import ParamListModel, _glorot, _orthogonal


def init_params(gen: torch.Generator, n_features: int, hidden: int = 300) -> List[torch.Tensor]:
    """[W1, U1, b1, W2, U2, b2, Wd, bd] — stacked LSTM(h) → LSTM(h) → Dense(1)."""
    b = torch.zeros(4 * hidden)
    b[hidden : 2 * hidden] = 1.0  # unit_forget_bias
    return [
        _glorot(gen, (n_features, 4 * hidden)),
        _orthogonal(gen, (hidden, 4 * hidden)),
        b.clone(),
        _glorot(gen, (hidden, 4 * hidden)),
        _orthogonal(gen, (hidden, 4 * hidden)),
        b.clone(),
        _glorot(gen, (hidden, 1)),
        torch.zeros((1,)),
    ]


def _lstm_layer(x_seq, W, U, b, return_sequences: bool):
    hidden = U.shape[0]
    xw = x_seq @ W + b
    h = x_seq.new_zeros((x_seq.shape[0], hidden))
    c = torch.zeros_like(h)
    hs = []
    for t in range(x_seq.shape[1]):
        z = xw[:, t] + h @ U
        i = torch.sigmoid(z[:, :hidden])
        f = torch.sigmoid(z[:, hidden : 2 * hidden])
        g = torch.tanh(z[:, 2 * hidden : 3 * hidden])
        o = torch.sigmoid(z[:, 3 * hidden :])
        c = f * c + i * g
        h = o * torch.tanh(c)
        if return_sequences:
            hs.append(h)
    return torch.stack(hs, dim=1) if return_sequences else h


class Model(ParamListModel):
    """[W1, U1, b1, W2, U2, b2, Wd, bd]."""

    def forward(self, x, train: bool = False, generator: torch.Generator | None = None):
        p = self.param_list()
        h = _lstm_layer(x, p[0], p[1], p[2], True)
        h = _lstm_layer(h, p[3], p[4], p[5], False)
        return (h @ p[6] + p[7])[:, 0]


def num_params(params) -> int:
    return sum(int(np.prod(p.shape)) for p in params)
