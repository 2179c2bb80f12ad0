"""The port package imports without JAX, and its CUDA wrappers import (and
route CPU tensors to their plain versions) without nvcc or a GPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = [
    "ppqsflhe_tpu_torch",
    "ppqsflhe_tpu_torch.core.modarith",
    "ppqsflhe_tpu_torch.core.primes",
    "ppqsflhe_tpu_torch.core.ntt",
    "ppqsflhe_tpu_torch.core.rns",
    "ppqsflhe_tpu_torch.core.sampling",
    "ppqsflhe_tpu_torch.core.jax_prng",
    "ppqsflhe_tpu_torch.ops.mxu_ntt",
    "ppqsflhe_tpu_torch.ops.fourstep",
    "ppqsflhe_tpu_torch.ops.cuda_lib",
    "ppqsflhe_tpu_torch.ops.cuda_mxu_ntt",
    "ppqsflhe_tpu_torch.ops.streamed_ntt",
    "ppqsflhe_tpu_torch.ops.cuda_ntt",
    "ppqsflhe_tpu_torch.ops.cuda_ext",
    "ppqsflhe_tpu_torch.ops.cuda_ks",
    "ppqsflhe_tpu_torch.ckks.types",
    "ppqsflhe_tpu_torch.ckks.params",
    "ppqsflhe_tpu_torch.ckks.encoding",
    "ppqsflhe_tpu_torch.ckks.eval",
    "ppqsflhe_tpu_torch.ckks.rlwe",
    "ppqsflhe_tpu_torch.ckks.scheme",
    "ppqsflhe_tpu_torch.ckks.serialize",
    "ppqsflhe_tpu_torch.ckks.noise",
    "ppqsflhe_tpu_torch.ckks.multikey",
    "ppqsflhe_tpu_torch.ckks.threshold",
    "ppqsflhe_tpu_torch.ckks.openfhe_emit",
    "ppqsflhe_tpu_torch.ckks.openfhe_io",
    "ppqsflhe_tpu_torch.fl.api",
    "ppqsflhe_tpu_torch.fl.cli",
    "ppqsflhe_tpu_torch.probes",
    "ppqsflhe_tpu_torch.probes.mxu_vpu_overlap",
    "ppqsflhe_tpu_torch.probes.kernel_report",
    "ppqsflhe_tpu_torch.bench",
    "ppqsflhe_tpu_torch.bench.multikey",
    "ppqsflhe_tpu_torch.bench.orchestrated",
    "ppqsflhe_tpu_torch.bench.timing",
    "ppqsflhe_tpu_torch.bench.server_round",
    "ppqsflhe_tpu_torch.bench.rotations",
    "ppqsflhe_tpu_torch.bench.kernels",
    "ppqsflhe_tpu_torch.bench.sizes",
    "ppqsflhe_tpu_torch.utils",
    "ppqsflhe_tpu_torch.utils.profiling",
    "ppqsflhe_tpu_torch.convert",
    "ppqsflhe_tpu_torch.comm",
    "ppqsflhe_tpu_torch.comm.metrics",
    "ppqsflhe_tpu_torch.comm.client",
    "ppqsflhe_tpu_torch.comm.server",
    "ppqsflhe_tpu_torch.comm.analyze",
    "ppqsflhe_tpu_torch.ingest",
    "ppqsflhe_tpu_torch.ingest.broker",
    "ppqsflhe_tpu_torch.ingest.service",
    "ppqsflhe_tpu_torch.ingest.telemetry",
    "ppqsflhe_tpu_torch.train",
    "ppqsflhe_tpu_torch.train.data",
    "ppqsflhe_tpu_torch.train.gru",
    "ppqsflhe_tpu_torch.train.lstm",
    "ppqsflhe_tpu_torch.train.mlp",
    "ppqsflhe_tpu_torch.train.transformer",
    "ppqsflhe_tpu_torch.train.trainer",
    "ppqsflhe_tpu_torch.train.optim",
    "ppqsflhe_tpu_torch.train.compiled",
    "ppqsflhe_tpu_torch.train.evaluate",
    "ppqsflhe_tpu_torch.orchestration",
    "ppqsflhe_tpu_torch.orchestration.orchestrator",
    "ppqsflhe_tpu_torch.orchestration.cli",
    "ppqsflhe_tpu_torch.ops.sharded_ntt",
    "ppqsflhe_tpu_torch.parallel",
    "ppqsflhe_tpu_torch.parallel.mesh",
    "ppqsflhe_tpu_torch.parallel.multihost",
    "ppqsflhe_tpu_torch.parallel.sharded_scheme",
    "ppqsflhe_tpu_torch.parallel.dryrun",
    "ppqsflhe_tpu_torch.bench.sharded",
    "ppqsflhe_tpu_torch.bench.scaling",
    "ppqsflhe_tpu_torch.runtime",
    "ppqsflhe_tpu_torch.runtime.native",
]


def test_port_imports_without_jax():
    """A fresh interpreter imports every port module and never loads jax
    (nor the JAX package, whose __init__ imports jax)."""
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'ppqsflhe_tpu.')))\n"
        "print('LOADED', bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "LOADED []" in r.stdout


def test_port_imports_without_pandas_or_matplotlib():
    """The card's machine has neither pandas nor matplotlib: importing every
    port module loads neither (the plot helpers import matplotlib inside
    the function, guarded)."""
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('pandas', 'matplotlib'))\n"
        "print('LOADED', bad)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "LOADED []" in r.stdout


def test_no_jax_import_in_port_sources():
    """No source file of the port, nor chip_smoke.py, names jax or the JAX
    package in an import statement."""
    root = os.path.join(REPO, "ppqsflhe_tpu_torch")
    offenders = []
    walk = list(os.walk(root)) + [(REPO, [], ["chip_smoke.py"])]
    for dirpath, _, files in walk:
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    for line in fh:
                        s = line.strip()
                        if s.startswith(("import jax", "from jax", "import ppqsflhe_tpu.",
                                         "from ppqsflhe_tpu.")) or s == "import ppqsflhe_tpu":
                            offenders.append(f"{f}: {s}")
    assert offenders == []


def test_cuda_wrappers_route_cpu_tensors_to_plain():
    """Each kernel wrapper, given CPU tensors, runs its plain version and
    launches nothing (no nvcc, no build, counter unchanged)."""
    from ppqsflhe_tpu_torch.core import primes
    from ppqsflhe_tpu_torch.core.modarith import u64_to_i64
    from ppqsflhe_tpu_torch.core.rns import BaseExtender
    from ppqsflhe_tpu_torch.ops import cuda_ext, cuda_ks, cuda_lib, cuda_mxu_ntt

    n = 256
    moduli = [primes.first_prime_down(60, 2 * n)] + primes.prime_chain(40, 2, 2 * n)
    psis = [primes.root_of_unity(2 * n, q) for q in moduli]
    rng = np.random.default_rng(0)
    x = torch.from_numpy(np.stack([rng.integers(0, q, (2, n), dtype=np.int64)
                                   for q in moduli], axis=1))
    before = (cuda_mxu_ntt.launches, cuda_ext.launches, cuda_ks.launches)
    runner = cuda_mxu_ntt.CudaMxuNtt(n, moduli, psis)
    assert torch.equal(runner.intt(runner.ntt(x)), x)
    ext = BaseExtender(moduli[:2], moduli[2:])
    assert torch.equal(cuda_ext.fused_extend(x[:, :2], ext), ext.extend(x[:, :2]))
    dig = x[:, None].expand(2, 2, 3, n).contiguous()
    key = x[:2].reshape(2, 1, 3, n).expand(2, 2, 3, n).contiguous()
    limb_map = torch.arange(3)
    q = torch.tensor(u64_to_i64(moduli)).reshape(-1, 1)
    qinv = torch.tensor(u64_to_i64([primes.mont_qinv_neg(v) for v in moduli])).reshape(-1, 1)
    got = cuda_ks.ks_inner_product(dig, key, limb_map, q, qinv)
    assert torch.equal(got, cuda_ks.ks_inner_product_plain(dig, key, limb_map, q, qinv))
    assert (cuda_mxu_ntt.launches, cuda_ext.launches, cuda_ks.launches) == before
    assert cuda_lib._lib is None


def test_kernel_wrappers_reject_cpu_tensors():
    """The launch functions take CUDA tensors only: a CPU tensor raises before
    any build or launch — no silent fallback."""
    from ppqsflhe_tpu_torch.core import primes
    from ppqsflhe_tpu_torch.core.rns import BaseExtender
    from ppqsflhe_tpu_torch.ops import cuda_ext, cuda_mxu_ntt

    x = torch.zeros((1, 1, 32, 32), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_mxu_ntt.ntt_stage(x, x, torch.zeros(8, dtype=torch.int64),
                               torch.zeros((1, 4), dtype=torch.int64), True, first=False)
    src, dst = primes.prime_chain(40, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_ext.base_extend(torch.zeros((1, 1, 8), dtype=torch.int64),
                             cuda_ext.ext_params(BaseExtender([src], [dst])), 1)
