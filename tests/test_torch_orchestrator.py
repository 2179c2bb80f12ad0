"""The port's FL lifecycle (``ppqsflhe_tpu_torch.orchestration``) on the
CPU: the cases of tests/test_orchestrator.py (two rounds with training in
both transports, INDCCA + lazy levels, client and hub dropout, fail-fast,
threshold, resume, the binary wire), the same step log and file tree as
the JAX orchestrator, the JAX tools reading the port's artifacts, the CLI
and the bench twin's step tables. Ring 128, lookback 12, synthetic CSVs."""

import json
import os
import re

import numpy as np
import pytest

from ppqsflhe_tpu.fl import api as jax_api
from ppqsflhe_tpu.orchestration import Orchestrator as JaxOrchestrator
from ppqsflhe_tpu.orchestration import OrchestratorConfig as JaxOrchestratorConfig
from ppqsflhe_tpu_torch.bench import orchestrated
from ppqsflhe_tpu_torch.ckks import serialize as ser
from ppqsflhe_tpu_torch.orchestration import Orchestrator, OrchestratorConfig
from ppqsflhe_tpu_torch.orchestration import cli

CC = {"ring_dim": 128, "batch_size": 32, "multiplicative_depth": 2}


def synth_csv(path, hours=200, seed=0):
    rng = np.random.default_rng(seed)
    ts = np.datetime64("2024-07-01T00:00") + np.arange(hours).astype("timedelta64[h]")
    vals = 100 + 20 * np.sin(2 * np.pi * (np.arange(hours) % 24) / 24) + rng.normal(0, 2, hours)
    with open(path, "w") as f:
        f.write("Timestamp,Data\n")
        for t, v in zip(ts.astype(object), vals):
            f.write(f"{t.strftime('%d-%m-%Y %H:%M')},{float(v)!r}\n")
    return path


def weights_file(path, rng, shape=(4, 2), layer="dense/kernel"):
    vals = rng.uniform(-1, 1, int(np.prod(shape)))
    with open(path, "w") as f:
        json.dump({"weights_summary": [{
            "layer": layer, "shape": list(shape), "mean": float(vals.mean()),
            "std_dev": float(vals.std()), "values": [float(x) for x in vals]}]}, f)
    return path


def values(path, k=0):
    with open(path) as f:
        return np.asarray(json.load(f)["weights_summary"][k]["values"])


def port(**kw):
    return OrchestratorConfig(**dict(dict(cc_config=CC, device="cpu"), **kw))


@pytest.mark.parametrize("comm_mode", ["local", "http"])
def test_two_rounds_with_training(tmp_path, comm_mode):
    """Training, encryption, PRE, aggregation, decryption and warm start
    over two rounds; both clients decrypt the mean of the exported weights."""
    csvs = [synth_csv(str(tmp_path / f"c{i}.csv"), seed=i) for i in (1, 2)]
    client_cfgs = [{"client_id": f"client_{i + 1}", "data_file": csvs[i],
                    "train_end_date": "2024-07-08 23:00:00",
                    "test_start_date": "2024-07-09 00:00:00", "lookback": 12, "hidden": 16,
                    "epochs": 2}
                   for i in range(2)]
    run = tmp_path / "run"
    results = Orchestrator(port(rounds=2, n_clients=2, work_dir=str(run), comm_mode=comm_mode,
                                client_configs=client_cfgs, train=True, seed=5)).run()
    assert [r["dropped"] for r in results] == [[], []]
    for r in results:
        for i in (1, 2):
            t = r["training"][i]
            assert (t["warm_start"] is None) == (r["round"] == 1)
            assert t["epochs"] == 2 and np.isfinite(t["val_mse"])
    decs = [json.load(open(run / f"client_{i}" / "decrypted_weights.json"))["weights_summary"]
            for i in (1, 2)]
    ws = [json.load(open(run / f"client_{i}" / "weights.json"))["weights_summary"]
          for i in (1, 2)]
    assert len(decs[0]) == 8
    for k in range(8):
        assert decs[0][k]["shape"] == decs[1][k]["shape"] == ws[0][k]["shape"]
        np.testing.assert_allclose(decs[0][k]["values"], decs[1][k]["values"], atol=1e-3)
        want = (np.asarray(ws[0][k]["values"]) + np.asarray(ws[1][k]["values"])) / 2
        np.testing.assert_allclose(decs[0][k]["values"], want, atol=1e-3)
    assert os.path.exists(run / "metrics" / "comm_metrics.csv")
    if comm_mode == "http":
        assert os.path.exists(run / "metrics" / "server_comm_metrics.csv")


def test_indcca_lazy_round(tmp_path):
    rng = np.random.default_rng(7)
    w = [weights_file(str(tmp_path / f"w{i}.json"), rng, (40,), "dense") for i in (1, 2)]
    cfg = port(rounds=1, n_clients=2, work_dir=str(tmp_path / "run"), comm_mode="local",
               cc_config=dict(CC, PREMode="INDCCA"),
               client_configs=[{"INPUT_WEIGHTS_PATH": p} for p in w],
               train=False, seed=11, lazy_levels=True)
    Orchestrator(cfg).run()
    want = (values(w[0]) + values(w[1])) / 2
    for i in (1, 2):
        got = values(tmp_path / "run" / f"client_{i}" / "decrypted_weights.json")
        # two INDCCA hops at pre_flood_bits=30, Δ=2^40 (~0.01/hop at N=128)
        np.testing.assert_allclose(got, want, atol=0.1)


def test_client_dropout_tolerance(tmp_path):
    rng = np.random.default_rng(7)
    w = [str(tmp_path / f"w{i}.json") for i in (1, 2, 3)]
    weights_file(w[0], rng)
    weights_file(w[2], rng)                     # client_2 has no weights file
    results = Orchestrator(port(rounds=1, n_clients=3, work_dir=str(tmp_path / "run"),
                                comm_mode="local",
                                client_configs=[{"INPUT_WEIGHTS_PATH": p} for p in w],
                                train=False, seed=9)).run()
    assert results[0]["active"] == [1, 3] and results[0]["dropped"] == [2]
    run = tmp_path / "run"
    assert not os.path.exists(run / "client_2" / "decrypted_weights.json")
    np.testing.assert_allclose(values(run / "client_1" / "decrypted_weights.json"),
                               (values(w[0]) + values(w[2])) / 2, atol=1e-3)


def test_hub_dropout_aborts_round(tmp_path):
    w1 = weights_file(str(tmp_path / "w1.json"), np.random.default_rng(7), (2, 2))
    cfg = port(rounds=1, n_clients=2, work_dir=str(tmp_path / "run"), comm_mode="local",
               client_configs=[{"INPUT_WEIGHTS_PATH": w1},
                               {"INPUT_WEIGHTS_PATH": str(tmp_path / "missing.json")}],
               train=False, seed=9)
    with pytest.raises(RuntimeError, match="hub"):
        Orchestrator(cfg).run()


def test_fail_fast_mode_preserves_reference_semantics(tmp_path):
    cfg = port(rounds=1, n_clients=2, work_dir=str(tmp_path / "run"), comm_mode="local",
               client_configs=[{"INPUT_WEIGHTS_PATH": str(tmp_path / "nope.json")}] * 2,
               train=False, seed=9, fail_fast=True)
    with pytest.raises(FileNotFoundError):
        Orchestrator(cfg).run()


def test_threshold_protocol_round(tmp_path):
    rng = np.random.default_rng(11)
    w = [weights_file(str(tmp_path / f"w{i}.json"), rng) for i in (1, 2, 3)]
    results = Orchestrator(port(rounds=1, n_clients=3, work_dir=str(tmp_path / "run"),
                                comm_mode="local",
                                client_configs=[{"INPUT_WEIGHTS_PATH": p} for p in w],
                                train=False, seed=21, protocol="threshold")).run()
    assert results[0]["active"] == [1, 2, 3]
    assert not os.path.exists(tmp_path / "run" / "server_storage" / "c1_domainChange_c3.json")
    want = np.mean([values(p) for p in w], axis=0)
    for i in (1, 2, 3):
        got = values(tmp_path / "run" / f"client_{i}" / "decrypted_weights.json")
        # ss=30 smudging at Δ=2^40, N=128, 3 parties → ~0.02 slot noise
        np.testing.assert_allclose(got, want, atol=0.1)


def test_checkpoint_resume(tmp_path):
    w = weights_file(str(tmp_path / "w.json"), np.random.default_rng(3), (2, 2), "d/k")
    base = dict(n_clients=2, work_dir=str(tmp_path / "run"), comm_mode="local",
                client_configs=[{"INPUT_WEIGHTS_PATH": w}] * 2, train=False, seed=4)
    assert [x["round"] for x in Orchestrator(port(rounds=1, **base)).run()] == [1]
    key = tmp_path / "run" / "client_1" / "client_1-private.key"
    mtime = os.path.getmtime(key)
    r2 = Orchestrator(port(rounds=3, **base)).run(resume=True)
    assert [x["round"] for x in r2] == [2, 3]
    assert os.path.getmtime(key) == mtime
    bad = dict(base, n_clients=3, client_configs=[{"INPUT_WEIGHTS_PATH": w}] * 3)
    with pytest.raises(ValueError, match="resume mismatch"):
        Orchestrator(port(rounds=3, **bad)).run(resume=True)


def test_binary_wire_lazy_round(tmp_path):
    """Every encrypted artifact is a PQWD container, the downlink is one
    tower, and the FedAvg is exact."""
    rng = np.random.default_rng(13)
    w = [weights_file(str(tmp_path / f"w{i}.json"), rng, (50,), "dense") for i in (1, 2)]
    Orchestrator(port(rounds=1, n_clients=2, work_dir=str(tmp_path / "run"), comm_mode="local",
                      client_configs=[{"INPUT_WEIGHTS_PATH": p} for p in w],
                      train=False, seed=29, lazy_levels=True, binary_wire=True)).run()
    run = tmp_path / "run"
    assert ser.doc_is_binary(str(run / "client_1" / "encrypted_weights_c1.json"))
    dl = str(run / "server_storage" / "c2_domainChange_c1.json")
    assert ser.doc_is_binary(dl)
    doc = ser.load_enc_doc(dl)
    assert ser.ciphertext_from_bytes(doc["weights_summary"][0]["mean"], device="cpu").nlimbs == 1
    want = (values(w[0]) + values(w[1])) / 2
    for i in (1, 2):
        np.testing.assert_allclose(values(run / f"client_{i}" / "decrypted_weights.json"), want,
                                   atol=1e-3)


STEP = re.compile(r"^\[[^\]]+\] \[([^\]]+)\] \[([^\]]+)\] (.*)$")


def step_log(text):
    """(role, step, message) of every step-log line, the round line's
    seconds masked."""
    out = []
    for line in text.splitlines():
        m = STEP.match(line)
        if m:
            out.append((m.group(1), m.group(2),
                        re.sub(r"in \d+\.\ds", "in <t>s", m.group(3))))
    return out


def tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


@pytest.mark.parametrize("protocol", ["pre", "threshold"])
def test_step_log_and_file_tree_match_jax(tmp_path, capsys, protocol):
    """For the same train=False config both orchestrators log the same
    steps in the same order and leave the same files; the JAX decrypt
    reads the port's downloaded aggregate to the mean."""
    rng = np.random.default_rng(17)
    w = [weights_file(str(tmp_path / f"w{i}.json"), rng, (6, 3)) for i in (1, 2)]
    kw = dict(rounds=2, n_clients=2, comm_mode="http", cc_config=CC,
              client_configs=[{"INPUT_WEIGHTS_PATH": p} for p in w], train=False, seed=31,
              protocol=protocol, lazy_levels=True, binary_wire=True)
    JaxOrchestrator(JaxOrchestratorConfig(work_dir=str(tmp_path / "jax"), **kw)).run()
    want = capsys.readouterr().out
    Orchestrator(OrchestratorConfig(work_dir=str(tmp_path / "port"), device="cpu", **kw)).run()
    got = capsys.readouterr().out
    assert step_log(got) == step_log(want) and len(step_log(got)) > 15
    assert tree(tmp_path / "port") == tree(tmp_path / "jax")
    mean = np.mean([values(p) for p in w], axis=0)
    if protocol == "pre":
        c1 = tmp_path / "port" / "client_1"
        out = str(tmp_path / "jax_reads_port.json")
        jax_api.decrypt_weights(str(c1 / "CC.json"), str(c1 / "client_1-private.key"),
                                str(c1 / "aggregated_for_me.json"), out)
        np.testing.assert_allclose(values(out), mean, atol=1e-3)
    for i in (1, 2):
        np.testing.assert_allclose(
            values(tmp_path / "port" / f"client_{i}" / "decrypted_weights.json"), mean,
            atol=1e-3 if protocol == "pre" else 0.1)


def test_cli_reads_the_oconfig_schema(tmp_path, capsys):
    rng = np.random.default_rng(19)
    w = [weights_file(str(tmp_path / f"w{i}.json"), rng) for i in (1, 2)]
    cfg_path = tmp_path / "oConfig.json"
    cfg_path.write_text(json.dumps({
        "ROUNDS": 1, "N_CLIENTS": 2, "WORK_DIR": str(tmp_path / "run"), "COMM_MODE": "MONGOOSE",
        "SERVER_PORT": 0, "SEED": 3, "TRAIN": False, "LAZY_LEVELS": True, "CC_CONFIG": CC,
        "CLIENT_CONFIGS": [{"INPUT_WEIGHTS_PATH": p} for p in w]}))
    assert cli.main([str(cfg_path), "--device", "cpu"]) == 0
    results = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert results[0]["active"] == [1, 2] and results[0]["dropped"] == []
    assert os.path.exists(tmp_path / "run" / "metrics" / "server_comm_metrics.csv")


def test_bench_step_tables(tmp_path):
    """The bench twin's parser on a real run's log: one table per round,
    its steps in log order, the round's total their span."""
    rng = np.random.default_rng(23)
    w = [weights_file(str(tmp_path / f"w{i}.json"), rng) for i in (1, 2)]
    _, log, total = orchestrated.run(port(
        rounds=2, n_clients=2, work_dir=str(tmp_path / "run"), comm_mode="local",
        client_configs=[{"INPUT_WEIGHTS_PATH": p} for p in w], train=False, seed=3,
        lazy_levels=True))
    out = orchestrated.summary(log, total)
    assert out["metric"] == "orchestrated_round_s_warm" and len(out["rounds"]) == 2
    steps = [s["step"] for s in out["rounds"][1]["steps"]]
    assert steps == ["client_1:encrypt", "client_2:encrypt", "server:changeCipherDomain",
                     "server:aggregate", "server:changeCipherDomain", "client_1:decrypt",
                     "client_2:decrypt"]
    assert out["value"] == out["rounds"][1]["total_s"] >= 0
