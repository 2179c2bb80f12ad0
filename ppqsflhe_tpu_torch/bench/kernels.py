"""The NTT and key-switch microbenchmarks on one GPU: the twin of
``bench_kernels.py``.

**The NTT north star** (``bench_kernels.py:53-127``): the four-step runner
over ``first_prime_down(59, 2N)`` + 3 × 40-bit primes (L=4), at N=2^14 with
B=27 polys and at N=2^16 with B=8, numpy-seeded residues. Each
implementation, under its JAX name, runs R chained forward transforms (each
output the next input):

- ``core``: the radix-2 transform (``core/ntt.Radix2Ntt``, plain torch,
  each call a replay of its cached CUDA graph on the card as the JAX
  package jits ``_ntt_impl``; the bit-reversed order, so its chain is not
  compared);
- ``pallas``: the butterfly transform, kernel 6;
- ``pallas_mxu``: the digit-matmul route (``route``: kernel 1, 1b, or 4+5
  per digit-count group).

``pallas`` and ``pallas_mxu`` must give bit-equal chains. The JAX bench's
``4step`` and ``mxu`` are XLA paths with no counterpart here; a stderr line
names the implementation :mod:`..convert` maps them to. Time: the marginal
cost between 100 and 300 chained transforms (:mod:`.timing`), in µs per
limb-NTT.

**The key switch** (``bench_kernels.py:134-221``): the full hybrid key switch
(iNTT, decompose, base extension, NTT, KSK inner product, ModDown) of B=27
random ciphertext components at full level with a random Montgomery-form
key, on ``CkksParams.generate(n=2^14, mult_depth=2, dnum=2)`` (L=3, LK=5) and
again with ``extra_mod_bits=20``, the FLEXIBLEAUTOEXT chain (L=4, LK=6). The
outputs must be bit-equal across ``pallas_mxu`` and ``pallas``; time: the
marginal cost between 20 and 60 chained switches (a data-dependent carry),
in µs per key switch.

A failed bit-equality raises after the JSON lines are printed. Run on the
card::

    python -m ppqsflhe_tpu_torch.bench.kernels

It prints the JAX bench's JSON lines (``ntt_us_per_limb_N{n}``,
``keyswitch_us_N16384_L{L}_montkeys``, each with ``results``) plus
``"card"``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .. import convert
from ..ckks import eval as ev
from ..ckks.params import CkksParams
from ..ckks.scheme import CkksScheme
from ..ckks.types import KeySwitchKey
from ..core import primes
from ..core.ntt import NttBasis, Radix2Ntt
from ..ops import cuda_ntt
from . import timing
from .timing import card_line

NTT_SIZES = ((1 << 14, 4, 27), (1 << 16, 4, 8))     # (N, L, B), bench_kernels.py:53
NTT_ROUNDS = (100, 300)     # chained transforms (bench_kernels.py:41)
KS_N, KS_B = 1 << 14, 27
KS_ROUNDS = (20, 60)        # chained key switches (bench_kernels.py:193)
KS_IMPLS = (cuda_ntt.MXU, cuda_ntt.BUTTERFLY)
# the JAX bench's XLA paths and the runner convert maps their ntt_impl to
NO_COUNTERPART = {"4step": "xla", "mxu": "mxu"}


def ntt_chain_moduli(n: int, L: int) -> list:
    return ([primes.first_prime_down(59, 2 * n)] + primes.prime_chain(40, 3, 2 * n))[:L]


def ntt_runners(n: int, moduli) -> dict:
    """Each implementation's forward transform over all limbs, by JAX name."""
    psis = [primes.root_of_unity(2 * n, q) for q in moduli]
    core = Radix2Ntt(NttBasis(n, moduli, psis))
    idx = tuple(range(len(moduli)))
    run = {"core": lambda a: core.ntt(a, idx=idx)}
    for impl in (cuda_ntt.BUTTERFLY, cuda_ntt.MXU):
        f = cuda_ntt.four_step_ntt(n, moduli, psis, impl)
        run[impl] = f.ntt
    return run


def ntt_input(n: int, moduli, B: int, device) -> torch.Tensor:
    """B polys of uniform residues per modulus (numpy seed 0, as the JAX
    bench draws them)."""
    rng = np.random.default_rng(0)
    x = np.stack([np.stack([rng.integers(0, q, n, dtype=np.uint64) for q in moduli])
                  for _ in range(B)])
    return convert.residues(x, device)


def chained(f, x, rounds: int) -> torch.Tensor:
    for _ in range(rounds):
        x = f(x)
    return x


def ntt_bench(n: int, L: int, B: int, device, card=None, reps: int = 3, out=print) -> dict:
    """One NTT size: the chains (checked bit-equal across the four-step
    implementations), then µs per limb-NTT by implementation (on the card).
    Prints and returns the JSON line; raises after printing on a mismatch."""
    moduli = ntt_chain_moduli(n, L)
    x = ntt_input(n, moduli, B, device)
    runs = ntt_runners(n, moduli)
    rounds = NTT_ROUNDS
    # core's output order differs (bit-reversed), so only the four-step
    # chains are compared, as bench_kernels.py compares them
    same = torch.equal(chained(runs[cuda_ntt.BUTTERFLY], x, rounds[0]),
                       chained(runs[cuda_ntt.MXU], x, rounds[0]))
    results = dict.fromkeys(runs)
    if x.is_cuda:
        for name, f in runs.items():
            m = timing.marginal_ms(f, x, *rounds, reps)
            timing.unit_report(f"kbench ntt N={n} {name}", lambda: f(x), m["ms"], card)
            results[name] = m["ms"] * 1e3 / (B * L)
            print(f"[kbench] N=2^{n.bit_length() - 1} L={L} B={B} {name:10s}: "
                  f"{results[name]:8.2f} us/limb-NTT marginal ({1e6 / results[name]:,.0f} "
                  f"limb-NTT/s; chains of {rounds[0]} / {rounds[1]}: {m['t_lo_ms']:.2f} / "
                  f"{m['t_hi_ms']:.2f} ms) ({card})", file=sys.stderr)
    result = {"metric": f"ntt_us_per_limb_N{n}", "results": results, "L": L, "B": B,
              "bit_equal": same, "card": card}
    out(json.dumps(result))
    if not same:
        raise AssertionError(f"N={n}: the pallas and pallas_mxu chains differ")
    return result


def keyswitch_inputs(sch: CkksScheme, B: int):
    """B random components at full level and a random key over QP (numpy
    seed 0, as ``bench_kernels.py:156-164``), the key in Montgomery form."""
    rng = np.random.default_rng(0)
    L, n = sch.params.num_q, sch.params.n
    qs = np.array(sch.params.q_moduli, np.uint64)
    c = rng.integers(0, 1 << 59, size=(B, L, n), dtype=np.uint64) % qs[None, :, None]
    nd, LK = len(sch.ctx.digit_groups), len(sch.ctx.moduli_qp)
    rk = rng.integers(0, 1 << 59, size=(nd, 2, LK, n), dtype=np.uint64) \
        % np.array(sch.ctx.moduli_qp, np.uint64)[None, None, :, None]
    key = ev.ksk_to_mont(sch.ctx, KeySwitchKey(data=convert.residues(rk, sch.device)))
    return convert.residues(c, sch.device), key


def keyswitch_all(sch: CkksScheme, c: torch.Tensor, key: KeySwitchKey) -> torch.Tensor:
    """Every component's key switch at full level: (B, 2, L, N)."""
    d0, d1 = ev.keyswitch(sch.ctx, c, key, sch.params.num_q)
    return torch.stack([d0, d1], dim=1)


def keyswitch_bench(device, extra_mod_bits: int = 0, n: int = KS_N, B: int = KS_B, card=None,
                    reps: int = 3, out=print) -> dict:
    """The key switch per implementation on one chain: outputs bit-equal
    across implementations, then µs per key switch (on the card). Prints
    and returns the JSON line; raises after printing on a mismatch."""
    results, outs = {}, {}
    for impl in KS_IMPLS:
        sch = CkksScheme(CkksParams.generate(n=n, mult_depth=2, scale_bits=40, dnum=2,
                                             extra_mod_bits=extra_mod_bits,
                                             ntt_backend="fourstep", ntt_impl=impl),
                         device=device)
        L = sch.params.num_q
        c, key = keyswitch_inputs(sch, B)
        outs[impl] = keyswitch_all(sch, c, key)
        results[impl] = None
        if c.is_cuda:
            unit = lambda: [keyswitch_all(sch, c, key)]
            m = timing.marginal_carried_ms(unit, c, *KS_ROUNDS, reps)
            timing.unit_report(f"kbench keyswitch L={L} {impl}", unit, m["ms"], card)
            results[impl] = m["ms"] * 1e3 / B
            print(f"[kbench] keyswitch N=2^{n.bit_length() - 1} L={L} "
                  f"LK={len(sch.ctx.moduli_qp)} B={B} mont-keys {impl:10s}: "
                  f"{results[impl]:8.1f} us/keyswitch marginal ({B * 1e3 / m['ms']:,.0f} "
                  f"keyswitch/s) ({card})", file=sys.stderr)
    same = torch.equal(*outs.values())
    result = {"metric": f"keyswitch_us_N{n}_L{L}_montkeys", "results": results, "B": B,
              "LK": len(sch.ctx.moduli_qp), "bit_equal": same, "card": card}
    out(json.dumps(result))
    if not same:
        raise AssertionError(f"keyswitch L={L}: the implementations' outputs differ")
    return result


def bench(device="cuda", ntt_sizes=NTT_SIZES, ks_n: int = KS_N, ks_b: int = KS_B, reps: int = 3,
          out=print) -> list:
    """Every JSON line of the bench, in ``bench_kernels.py``'s order."""
    device = torch.device(device)
    card = card_line() if device.type == "cuda" else None
    for name, impl in NO_COUNTERPART.items():
        print(f"[kbench] {name}: an XLA path of the JAX package with no counterpart here; "
              f"convert maps its ntt_impl {impl!r} to {cuda_ntt.RUNNER[impl]!r}, timed under "
              f"that name", file=sys.stderr)
    lines = [ntt_bench(n, L, B, device, card, reps, out) for n, L, B in ntt_sizes]
    for extra in (0, 20):
        lines.append(keyswitch_bench(device, extra, ks_n, ks_b, card, reps, out))
    return lines


def main(argv=None) -> None:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernels bench: needs a CUDA GPU")
    bench("cuda")


if __name__ == "__main__":
    main()
