"""Windowed-MLP forecaster in torch (Keras weight layout).

Twin of ``ppqsflhe_tpu.train.mlp``: the (lookback, F) window flattened
through Dense(h) → ReLU → Dense(h) → ReLU → Dense(1), kernel (in, out),
bias (out,).
"""

from __future__ import annotations

from typing import List

import torch

from .gru import ParamListModel, _glorot, dropout

HIDDEN = 64


def init_params(gen: torch.Generator, n_features: int, hidden: int = HIDDEN,
                lookback: int | None = None) -> List[torch.Tensor]:
    """[W1, b1, W2, b2, Wd, bd]. ``lookback`` must be pinned at init because
    the flattened window is the input width; default 72 (the reference's)."""
    d_in = int(lookback or 72) * n_features
    return [
        _glorot(gen, (d_in, hidden)), torch.zeros((hidden,)),
        _glorot(gen, (hidden, hidden)), torch.zeros((hidden,)),
        _glorot(gen, (hidden, 1)), torch.zeros((1,)),
    ]


class Model(ParamListModel):
    """[W1, b1, W2, b2, Wd, bd]."""

    def forward(self, x, train: bool = False, generator: torch.Generator | None = None,
                dropout_rate: float = 0.3):
        """x: (B, lookback, F) → (B,) prediction."""
        p = self.param_list()
        drop = train and generator is not None
        h = torch.relu(x.reshape(x.shape[0], -1) @ p[0] + p[1])
        if drop:
            h = dropout(h, dropout_rate, generator)
        h = torch.relu(h @ p[2] + p[3])
        if drop:
            h = dropout(h, dropout_rate, generator)
        return (h @ p[4] + p[5])[:, 0]

