"""The port's multi-host path (``parallel/multihost.py``): the twin of
``tests/test_multihost.py``'s two-process job, on ``gloo``. Each of 2
processes plays one host holding 2 clients (one rank each: the port runs a
process per device), joined through ``multihost.initialize`` with an
explicit coordinator address as the JAX test passes it. The encrypted FedAvg
and the threshold fusion each run as one modular psum over the global
``client`` axis; the fused aggregate must decrypt to the mean of the 4
clients' vectors within 0.2 (the JAX test's bound: ss=30 smudging over 4
parties at N=256, Δ=2^40), the same on both processes.
"""

import json
import os

import numpy as np
import pytest
import torch.distributed as dist

from ppqsflhe_tpu_torch import convert
from ppqsflhe_tpu_torch.ckks.params import CkksParams
from ppqsflhe_tpu_torch.parallel import multihost

WORKER_TIMEOUT_S = 300
ERR_BOUND = 0.2


def test_two_process_fedavg_and_threshold_fusion(tmp_path):
    params = CkksParams.generate(n=256, mult_depth=2, scale_bits=40, dnum=2)
    inputs = tmp_path / "inputs.npz"
    np.savez(inputs, params=json.dumps(convert.params_fields(params)))
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_dist_worker.py")
    outs = multihost.spawn_ranks([worker, "multihost", str(inputs), str(tmp_path)], 2, "cpu",
                                 timeout=WORKER_TIMEOUT_S)
    assert len(outs) == 2
    res = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    for r in res:
        assert float(r["err"]) < ERR_BOUND, float(r["err"])
        assert r["agg"].shape[0] == 1
    np.testing.assert_array_equal(res[0]["agg"], res[1]["agg"])


def test_initialize_needs_a_job(monkeypatch):
    """Without arguments or a torchrun / JAX_* environment, initialize
    refuses before touching torch.distributed."""
    for name in ("JAX_COORDINATOR_ADDRESS", "MASTER_ADDR", "JAX_NUM_PROCESSES", "WORLD_SIZE",
                 "JAX_PROCESS_ID", "RANK"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="coordinator"):
        multihost.initialize(device="cpu")
    assert not dist.is_initialized()
