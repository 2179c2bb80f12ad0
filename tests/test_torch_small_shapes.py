"""The smallest rings the JAX package runs, N = 2^6 … 2^9 (n1, n2 = 8 and 16:
the m = 8, 16 instances of kernels 1, 1b, 4, 5 and 6), against the JAX
package on the CPU: the four-step transforms of every route, plain versions
of the kernels, bit-equal to the JAX ``FourStepNtt`` (``implementation=
"xla"``, jitted), and the wrappers' shape checks. Exact residues, tolerance
0. The server round at N = 2^8 is ``tests/test_torch_small_round.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppqsflhe_tpu.ops.pallas_ntt import FourStepNtt as JaxFourStepNtt
from ppqsflhe_tpu_torch.core import primes
from ppqsflhe_tpu_torch.ops import cuda_mxu_ntt, cuda_ntt, streamed_ntt
from ppqsflhe_tpu_torch.ops.cuda_mxu_ntt import CudaMxuNtt, CudaMxuNttBig, route
from ppqsflhe_tpu_torch.ops.cuda_ntt import CudaFourStepNtt

RINGS = (1 << 6, 1 << 7, 1 << 8, 1 << 9)
B = 2            # polys of a transform


def _chain(n):
    """A 59-bit limb (9 digits) and a 40-bit one (6 digits), bench_kernels'
    primes at ring size n."""
    moduli = [primes.first_prime_down(59, 2 * n), primes.first_prime_down(40, 2 * n)]
    return moduli, [primes.root_of_unity(2 * n, q) for q in moduli]


def _residues(moduli, n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, q, (B, n), dtype=np.uint64) for q in moduli], axis=1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64))


def _u(t):
    return t.numpy().view(np.uint64)


@pytest.mark.parametrize("n", RINGS, ids=[f"n{n}" for n in RINGS])
def test_fourstep_transforms_equal_jax(n):
    """Every route of the port at ring size n — the fused route of kernel 1
    and of kernel 1b (both twiddles), the streamed pair of kernels 4 and 5,
    and kernel 6's butterfly transform, each by its plain versions — equals
    the JAX four-step transform (kernel order) bit for bit, forward and
    inverse, and the runner's route is the JAX runner's, the fused one."""
    moduli, psis = _chain(n)
    jx = JaxFourStepNtt(n, moduli, psis)
    x, y = _residues(moduli, n, n), _residues(moduli, n, n + 1)
    want_f = np.asarray(jax.jit(lambda a: jx.ntt(a, implementation="xla"))(jnp.asarray(x)))
    want_i = np.asarray(jax.jit(lambda a: jx.intt(a, implementation="xla"))(jnp.asarray(y)))
    mxu = CudaMxuNtt(n, moduli, psis)
    assert {route(n, t.nd) for t in mxu.tabs} == {"fused"}
    assert min(mxu.n1, mxu.n2) in (8, 16) and max(mxu.n1, mxu.n2) in streamed_ntt.SIZES
    big, bf = CudaMxuNttBig(mxu.tables), CudaFourStepNtt(n, moduli, psis)
    sel = list(range(len(moduli)))
    for fwd, src, want in ((True, x, want_f), (False, y, want_i)):
        xt = _t(src)
        got = {"route": (mxu.ntt if fwd else mxu.intt)(xt),
               "kernel 1": mxu.fused(xt, fwd, sel),
               "kernel 1b": mxu.fused(xt, fwd, sel, mont=True),
               "kernels 4+5": (big.ntt if fwd else big.intt)(xt),
               "kernel 6": (bf.ntt if fwd else bf.intt)(xt)}
        for name, g in got.items():
            np.testing.assert_array_equal(_u(g), want, err_msg=f"{name}, forward={fwd}")


def test_small_ring_kernel_shapes_are_taken():
    """The wrappers take the small rings' shapes (m = 8, 16; 8-column stages
    for kernels 1, 1b, 6; narrow tiles for 4 and 5), so a CPU tensor of such
    a shape reaches the device check and is refused there, never sent to a
    plain version; shapes below the kernels' still raise a ValueError that
    names the limit."""
    tabs, info = torch.zeros(8, dtype=torch.int64), torch.zeros((1, 4), dtype=torch.int64)
    for m, c in ((8, 8), (8, 16), (16, 8), (16, 32)):
        x = torch.zeros((1, 1, m, c), dtype=torch.int64)
        for first in (True, False):
            y = torch.zeros((1, 1, c, m) if first else (1, 1, m, c), dtype=torch.int64)
            with pytest.raises(ValueError, match="CUDA"):
                cuda_mxu_ntt.ntt_stage(x, y, tabs, info, True, first)
            with pytest.raises(ValueError, match="CUDA"):
                cuda_ntt.fourstep_pass(x, y, tabs, info, True, first)
    for m, c, match in ((4, 8, "m in"), (32, 8, "tiles"), (8, 4, "tiles")):
        x = torch.zeros((1, 1, m, c), dtype=torch.int64)
        y = torch.zeros((1, 1, c, m), dtype=torch.int64)
        with pytest.raises(ValueError, match=match):
            cuda_mxu_ntt.ntt_stage(x, y, tabs, info, True, True)
        with pytest.raises(ValueError, match=match):
            cuda_ntt.fourstep_pass(x, y, tabs, info, True, True)
    for c, col0 in ((1, 63), (2, 62), (4, 60), (8, 56), (16, 48)):
        x = torch.zeros((1, 1, 64, c), dtype=torch.int64)
        with pytest.raises(ValueError, match="CUDA"):
            streamed_ntt.stage_a(x, x, tabs, info, True, 64, col0)
        with pytest.raises(ValueError, match="CUDA"):
            streamed_ntt.stage_b(x.reshape(1, 1, c, 64), x, tabs, info, True)
    for c, col0, match in ((2, 61, "tile"), (8, 4, "tile"), (12, 0, "power of two"),
                           (24, 0, "power of two")):
        x = torch.zeros((1, 1, 64, c), dtype=torch.int64)
        with pytest.raises(ValueError, match=match):
            streamed_ntt.stage_a(x, x, tabs, info, True, 64, col0)
    assert streamed_ntt.tile_width(1, "c") == 1 and streamed_ntt.tile_width(48, "c") == 16
    x = torch.zeros((1, 1, 64, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="m in"):
        streamed_ntt.stage_b(x, x.reshape(1, 1, 4, 64), tabs, info, True)
