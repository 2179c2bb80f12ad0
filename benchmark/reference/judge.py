"""Decryption with the benchmark's secrets, canonical decoding, the plain
FedAvg, and the comparison that decides ``correct``.

A round of C clients (the hub is the last) hands back the average in the
hub's domain, (B, 2, l, N), and its re-encryption to each other client,
(C−1, B, 2, l, N), evaluations in the program's layout. Each ciphertext is
decrypted limb by limb (m = c0 + c1·s mod q_i, then the inverse transform),
m is read centered from limb 0 and every other limb must hold the same
integer mod its prime; the slots are m(ζ^(5^t)) / scale, ζ = e^(iπ/N), and
are held to the plain mean of the clients' payloads, times the factor by
which the schedule's ÷C departs from 1/C. The schedule fixes the outputs'
limbs, scale and that factor (:func:`plan`), which the reference works out
itself."""

from __future__ import annotations

import math

import numpy as np
import torch

from . import modq
from .chain import Chain, min_root

LAZY, FULL = 4, 0


def plan(chain: Chain, scale_bits: int, clients: int, lazy: int) -> tuple:
    """(limbs, scale, factor) of the round's outputs: they decode to
    ``factor`` × the plain FedAvg. A fresh encryption has the scale Δ, under
    FLEXIBLEAUTOEXT Δ·q_ext (the extension limb is dropped, never rescaled,
    before a lazy round's first hop). ``lazy`` 4 (upstream ``LAZY_LEVELS``):
    the inbound hop runs one limb below full, ÷C is scale metadata (C a
    power of two) and one more limb is dropped before the hop back, so both
    outputs hold L−2 limbs at C times the fresh scale, and decode to the
    mean itself. ``lazy`` 0 (OpenFHE's round): ÷C is a product by the
    integer round(q_top/C) (the constant encoded at scale q_top) and a
    rescale by q_top, leaving L−1 limbs at the fresh scale; they decode to
    C·round(q_top/C)/q_top × the mean (1 − 1.8·10⁻⁶ for C = 2 or 16 when
    q_top is the 20-bit q_ext = 557057)."""
    fresh = float(2 ** scale_bits) * (chain.q[-1] if chain.ext else 1)
    if lazy == LAZY:
        if clients & (clients - 1):
            raise ValueError(f"lazy-4 divides by {clients} clients as scale: a power of two")
        return len(chain.q) - 2, fresh * clients, 1.0
    if lazy == FULL:
        q_top = chain.q[-1]
        return len(chain.q) - 1, fresh, clients * round(q_top / clients) / q_top
    raise ValueError(f"no plan for lazy={lazy}")


def fedavg(payload_set) -> np.ndarray:
    """The plain FedAvg: for each ciphertext position b, the mean over
    clients of their vectors (each zero-padded to the longest) →
    float64 (B, width)."""
    clients = len(payload_set)
    width = max(len(v) for vecs in payload_set for v in vecs)
    out = np.zeros((len(payload_set[0]), width))
    for vecs in payload_set:
        for b, v in enumerate(vecs):
            out[b, : len(v)] += v
    return out / clients


class Decryptor:
    """Decryption and decoding under one set of secrets over a chain."""

    def __init__(self, chain: Chain, order: str, secrets: np.ndarray, slots: int, device):
        self.chain, self.order, self.slots = chain, order, slots
        self.device = torch.device(device)
        self.secrets = torch.as_tensor(np.asarray(secrets, dtype=np.int64), device=self.device)
        self.psi = [min_root(2 * chain.n, q) for q in chain.q]
        self._s_eval = {}
        n = chain.n
        j = torch.arange(n, dtype=torch.float64, device=self.device)
        self.twist = torch.polar(torch.ones_like(j), math.pi * j / n)
        g, bins = 1, []
        for _ in range(slots):
            bins.append((g - 1) // 2)
            g = g * 5 % (2 * n)
        self.bins = torch.as_tensor(bins, device=self.device)

    def s_eval(self, client: int, limb: int) -> torch.Tensor:
        key = (client, limb)
        if key not in self._s_eval:
            q = self.chain.q[limb]
            s = self.secrets[client] % q
            self._s_eval[key] = modq.forward(s, q, self.psi[limb], self.order)
        return self._s_eval[key]

    def coeffs(self, cts: torch.Tensor, client: int) -> tuple:
        """(centered integer coefficients (…, N) from limb 0, the count of
        coefficients that another limb contradicts) of ciphertexts (…, 2, l, N)."""
        cts = cts.to(self.device)
        per_limb = []
        for i in range(cts.shape[-2]):
            q = self.chain.q[i]
            c0, c1 = cts[..., 0, i, :], cts[..., 1, i, :]
            m = (c0 + modq.mulmod(c1, self.s_eval(client, i), q)) % q
            per_limb.append(modq.inverse(m, q, self.psi[i], self.order))
        q0 = self.chain.q[0]
        v = torch.where(per_limb[0] > q0 // 2, per_limb[0] - q0, per_limb[0])
        bad = sum(int((v % q != m).sum()) for q, m in zip(self.chain.q[1:], per_limb[1:]))
        return v, bad

    def decode(self, v: torch.Tensor, scale: float) -> torch.Tensor:
        """Slots m(ζ^(5^t)) / scale, complex128 (…, slots)."""
        n = v.shape[-1]
        evals = torch.fft.ifft(v.to(torch.float64) * self.twist) * n
        return evals[..., self.bins] / scale


def judge(dec: Decryptor, outputs, expect: np.ndarray, hub: int, limbs: int, scale: float,
          block: int = 64) -> dict:
    """Compare one round's outputs with the plain FedAvg ``expect`` (B, w).
    ``outputs`` is ((average data, its scale), (re-encryptions (C−1, …), their
    scale)). → {"max_err": worst |slot − mean| (inf where a shape is not the
    plan's), "limb_mismatch": coefficients one limb contradicts,
    "scale_gap": worst |scale / planned − 1|}."""
    (avg, avg_scale), (back, back_scale) = outputs
    B = expect.shape[0]
    want = torch.zeros((B, dec.slots), dtype=torch.complex128, device=dec.device)
    want[:, : expect.shape[1]] = torch.as_tensor(expect, device=dec.device)
    n = dec.chain.n
    res = {"max_err": 0.0, "limb_mismatch": 0,
           "scale_gap": max(abs(avg_scale / scale - 1), abs(back_scale / scale - 1))}
    jobs = [(avg, hub)] + [(back[c], c) for c in range(back.shape[0])]
    for data, client in jobs:
        if tuple(data.shape) != (B, 2, limbs, n):
            res["max_err"] = math.inf
            continue
        for lo in range(0, B, block):
            v, bad = dec.coeffs(data[lo:lo + block], client)
            err = (dec.decode(v, scale) - want[lo:lo + block]).abs().max().item()
            res["max_err"] = max(res["max_err"], err)
            res["limb_mismatch"] += bad
    return res
