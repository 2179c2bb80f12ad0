"""The port's mesh entry points on the CPU at a tiny size: the twins of
``bench_sharded.py`` and ``bench_scaling.py`` (``bench/sharded.py``,
``bench/scaling.py``) and of ``__graft_entry__.py``'s dry run
(``parallel/dryrun.py``), each run as its own command with ``--device
cpu``; their JSON lines carry the JAX benches' keys. On the CPU nothing is
timed as a device metric: the sharded twin's ``value`` is None and the
scaling twin names its platform."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 300


def _run(args, env=None):
    r = subprocess.run([sys.executable, "-m", *args], cwd=REPO, capture_output=True, text=True,
                       timeout=TIMEOUT_S,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
                                **(env or {})))
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    return r.stdout.strip().splitlines()


@pytest.mark.parametrize("lazy", [4, 0])
def test_sharded_bench_on_cpu(lazy):
    """The sharded round (N=2^12, 2 ciphertexts a client, one-rank gloo
    group) is bit-equal to the replicated round and decrypts within 1e-3."""
    out = json.loads(_run(["ppqsflhe_tpu_torch.bench.sharded", "--device", "cpu", "--n",
                           "4096", "--count", "2"], {"PPQSFLHE_BENCH_LAZY": str(lazy)})[-1])
    for key in ("metric", "value", "replicated_ms", "lazy", "impl", "card"):
        assert key in out
    assert out["metric"] == "sharded_round_ms" and out["lazy"] == lazy
    assert out["value"] is None and out["card"] is None
    assert out["bit_equal"] and out["correct"] and out["err"] < 1e-3
    assert out["collectives"]["all_to_all"]["ops"] == (8 if lazy == 4 else 11)


def test_scaling_bench_on_cpu():
    """Weak scaling at D = 1, 2 and 8 on gloo, on the JAX bench's shapes
    (the aggregation at N=256, the round at N=2^12 with 2D ciphertexts a
    client): the JAX bench's keys, and at D = 2 and 8 the sharded round's
    collectives equal the JAX package's committed model
    (SCALING_MODEL.json) in ops and bytes; D = 8 runs the round on shards
    of 8 columns."""
    out = json.loads(_run(["ppqsflhe_tpu_torch.bench.scaling", "--device", "cpu", "--devs",
                           "1,2,8", "--reps", "1", "--n-ntt", "4096"])[-1])
    for key in ("metric", "value", "round_value", "unit", "devices", "platform", "ntt_ms",
                "agg_ms", "round_ms", "round_cts", "collective_bytes", "note", "card"):
        assert key in out
    assert out["platform"] == "cpu" and out["devices"] == [1, 2, 8]
    assert out["model_diff"] == {"1": [], "2": [], "8": []}
    assert out["collective_bytes"]["2"]["all-to-all"] == {"ops": 11, "bytes": 2490368}
    assert out["round_cts"]["8"] == 16 and all(v is not None for v in out["round_ms"].values())


@pytest.mark.parametrize("n", [1, 2])
def test_dryrun_on_cpu(n):
    """entry()'s step, then the dry run's four steps on n gloo ranks."""
    lines = _run(["ppqsflhe_tpu_torch.parallel.dryrun", str(n), "--device", "cpu"])
    assert lines[0].startswith("entry() ok: (2, 2, 4096)")
    assert lines[-1].startswith(f"[dryrun_multichip] ok on {n} ranks")
    assert "decrypts to 0" in lines[-1] and "rotation" in lines[-1]
