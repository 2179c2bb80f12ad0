"""The bench twins (``ppqsflhe_tpu_torch/bench/{server_round,rotations,kernels,
sizes,multikey}.py``) at small sizes on the CPU, with their gates, and
``utils/profiling.py``'s ``profile_trace``.

On the CPU the twins time nothing (their ``value`` and their compiled
units' ``compiled_*`` keys are None); what is held here is their set-up,
their units and their gates: the round decrypts in all five schedules, the
multikey round in both, the rotations pass ``bench_rotations.py``'s gates, the
NTT chains and the key switches (L=3 and the 4-tower FLEXIBLEAUTOEXT chain)
are bit-equal across ``pallas`` and ``pallas_mxu``, and ``sizes.py``'s byte
counts equal the JAX tools' for the same cut payload and chain. Each
``main`` refuses to run without CUDA (``sizes.py`` excepted, which refuses
the repository's ``SIZES.json`` instead), and a failed gate raises after
the JSON line is printed."""

import json
import os

import numpy as np
import pytest

from ppqsflhe_tpu.fl import api as japi
from ppqsflhe_tpu_torch.bench import kernels, multikey, rotations, server_round, sizes, timing
from ppqsflhe_tpu_torch.fl import api
from ppqsflhe_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lines():
    got = []
    return got, lambda s: got.append(json.loads(s))


@pytest.mark.parametrize("lazy", [0, 1, 2, 3, 4])
def test_server_round_twin_gates(lazy):
    got, out = _lines()
    r = server_round.bench("cpu", lazy=lazy, n=1 << 11, count=3, out=out)
    assert got == [r] and r["correct"] and r["err"] < server_round.ERR_GATE
    assert r["metric"] == "server_encrypted_aggregation_ms_per_round" and r["unit"] == "ms"
    assert r["value"] is None and r["vs_baseline"] is None and r["card"] is None
    assert all(r[k] is None for k in server_round.COMPILED_KEYS) and list(r)[-1] == "card"
    assert r["out_scale"] == (2 if lazy >= 2 else 1) * 2.0**40
    assert r["out_limbs"] == {0: 2, 1: 1, 2: 1, 3: 2, 4: 1}[lazy]


def test_server_round_twin_settings_and_failed_gate(monkeypatch):
    env = {"PPQSFLHE_BENCH_BACKEND": "radix2", "PPQSFLHE_BENCH_IMPL": "xla",
           "PPQSFLHE_BENCH_LAZY": "2"}
    assert server_round.settings(env) == ("radix2", "xla", 2)
    assert server_round.settings({}) == ("fourstep", "pallas_mxu", 4)
    assert server_round.settings({"PPQSFLHE_BENCH_LAZY": ""})[2] == 0
    with pytest.raises(ValueError, match="LAZY"):
        server_round.settings({"PPQSFLHE_BENCH_LAZY": "5"})
    # a failed gate prints the JSON line first, then raises
    monkeypatch.setattr(server_round, "ERR_GATE", 0.0)
    got, out = _lines()
    with pytest.raises(AssertionError, match="decrypt error"):
        server_round.bench("cpu", "radix2", "xla", 4, n=1 << 11, count=1, out=out)
    assert len(got) == 1 and got[0]["correct"] is False


def test_rotations_twin_gates():
    got, out = _lines()
    r = rotations.bench("cpu", n=1 << 10, rots=[1, 2, 128], out=out)
    assert got == [r] and r["correct"] and r["plain_matches"]
    assert r["err"] < rotations.ERR_GATE and r["err_sum"] < rotations.SUM_GATE
    assert r["metric"] == "hoisted_rotation_us_per_rotation_n1024" and r["value"] is None
    assert rotations.params().n == 1 << 15
    # the compiled units' keys: None on the CPU, where nothing is captured
    assert rotations.COMPILED_KEYS == ("compiled_plain_us", "compiled_us",
                                       "compiled_rot_sum_us", "compiled_equal")
    assert all(r[k] is None for k in rotations.COMPILED_KEYS) and list(r)[-1] == "card"


@pytest.mark.parametrize("lazy", [4, 0])
def test_multikey_twin_line(lazy):
    """The multikey twin's line at N=2^10 with 4 clients on the CPU: the
    gate passes, ``value`` (the eager round's rounds/s) and the compiled
    round's keys are None, "card" last."""
    got, out = _lines()
    r = multikey.bench("cpu", lazy=lazy, n=1 << 10, clients=4,
                       shapes=((3, 40), (300,), (1,)), out=out)
    assert got == [r] and r["correct"] and r["err"] < multikey.ERR_GATE
    assert r["metric"] == "multikey_fl_rounds_per_sec" and r["unit"] == "rounds/s"
    assert r["value"] is None and r["round_seconds"] is None and r["lazy"] == lazy
    assert r["clients"] == 4 and r["params"] == 421
    assert multikey.COMPILED_KEYS == ("compiled_rounds_per_sec", "compiled_device_ms",
                                      "compiled_idle_share", "compiled_capture_s",
                                      "compiled_equal")
    assert all(r[k] is None for k in multikey.COMPILED_KEYS) and list(r)[-1] == "card"


def test_kernels_twin_bit_equal():
    """The NTT chains at two ring sizes and the key switch on both chains
    (L=3, LK=5 and the FLEXIBLEAUTOEXT L=4, LK=6), bit-equal across the
    implementations."""
    got, out = _lines()
    lines = kernels.bench("cpu", ntt_sizes=((256, 4, 2), (1 << 10, 3, 1)), ks_n=256, ks_b=2,
                          out=out)
    assert got == lines
    assert [r["metric"] for r in lines] == ["ntt_us_per_limb_N256", "ntt_us_per_limb_N1024",
                                            "keyswitch_us_N256_L3_montkeys",
                                            "keyswitch_us_N256_L4_montkeys"]
    assert all(r["bit_equal"] for r in lines)
    assert set(lines[0]["results"]) == {"core", "pallas", "pallas_mxu"}
    assert set(lines[2]["results"]) == {"pallas", "pallas_mxu"}
    assert (lines[2]["LK"], lines[3]["LK"]) == (5, 6)


@pytest.mark.parametrize("twin", [server_round, rotations, kernels])
def test_card_only_twins_refuse_without_cuda(twin, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        twin.main([])
    assert e.value.code not in (0, None)


def test_carried_marginal_refuses_a_bare_tensor():
    """A unit's outputs are checksummed as one list: a bare tensor would be
    iterated into a sum per slice, each a launch inside the timed chain."""
    import torch

    work = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(TypeError, match="list of tensors"):
        timing.marginal_carried_ms(lambda: work + 1, work, 1, 2)


def test_sizes_twin_bytes_equal_jax_tools(tmp_path):
    """The same artifacts at ring 256 over a cut GRU payload: every size
    equals the JAX tools' (both on the CPU), and the lazy binary downlink
    decrypts within the gate in both."""
    cc = {"multiplicative_depth": 2, "scaling_mod_size": 40, "batch_size": 64,
          "PREMode": "INDCPA", "ring_dim": 256}
    shapes = [[7, 24], [8, 24], [2, 24], [8, 1], [1]]
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    mine, err = sizes.artifacts(api, str(tmp_path / "port"), cc, shapes, device="cpu")
    theirs, jerr = sizes.artifacts(japi, str(tmp_path / "jax"), cc, shapes)
    assert mine == theirs
    assert err < sizes.ERR_GATE and jerr < sizes.ERR_GATE
    r = sizes.report(mine)
    with open(os.path.join(REPO, "SIZES.json")) as f:
        ref = json.load(f)
    assert set(r) == set(ref) and set(r["sizes_bytes"]) == set(ref["sizes_bytes"])
    assert set(r["ratios_vs_reference"]) == set(ref["ratios_vs_reference"])
    assert sum(int(np.prod(s)) for s in sizes.GRU_SHAPES) == 39041


def test_sizes_twin_never_writes_the_root_sizes(monkeypatch):
    before = open(os.path.join(REPO, "SIZES.json"), "rb").read()
    monkeypatch.setattr(sizes, "bench", lambda *a, **k: pytest.fail("must refuse first"))
    for path in (os.path.join(REPO, "SIZES.json"),
                 os.path.join(REPO, "tests", "..", "SIZES.json")):
        with pytest.raises(SystemExit, match="SIZES.json"):
            sizes.main(["--device", "cpu", "--out", path])
    assert open(os.path.join(REPO, "SIZES.json"), "rb").read() == before


def test_profile_trace_writes_a_trace(tmp_path):
    import torch

    with profiling.profile_trace(str(tmp_path / "trace")), profiling.tracing():
        with profiling.span("a.span"):
            torch.ones(64).cumsum(0)
    profiling.collect()
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "trace" / files[0]) as f:
        doc = json.load(f)
    names = [e.get("name", "") for e in doc["traceEvents"]]
    assert any("cumsum" in n for n in names) and "a.span" in names

