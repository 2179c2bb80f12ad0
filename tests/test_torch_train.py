"""The port's trainer (``ppqsflhe_tpu_torch.train``) against the JAX
package's: each family's forward, the loss and its gradients, one Adam
step, the data pipeline in both ``dayfirst`` modes, the weights JSON both
ways, and the training loop's early stopping and best-epoch restore. Small
sizes: lookback 12-24, hidden 8, synthetic hourly CSVs from
``np.random.default_rng(seed)``."""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ppqsflhe_tpu.train import data as JD
from ppqsflhe_tpu.train import evaluate as JE
from ppqsflhe_tpu.train import gru as jgru
from ppqsflhe_tpu.train import lstm as jlstm
from ppqsflhe_tpu.train import mlp as jmlp
from ppqsflhe_tpu.train import trainer as JT
from ppqsflhe_tpu.train import transformer as jtransformer
from ppqsflhe_tpu_torch import convert
from ppqsflhe_tpu_torch.train import data as D
from ppqsflhe_tpu_torch.train import evaluate as E
from ppqsflhe_tpu_torch.train import gru
from ppqsflhe_tpu_torch.train import trainer as T

FAMILIES = {"gru": jgru, "lstm": jlstm, "mlp": jmlp, "transformer": jtransformer}
LOOKBACK, HIDDEN, F = 12, 8, 7


def write_csv(path, hours=400, seed=0, fmt="%d-%m-%Y %H:%M", values=None):
    """Hourly series from 2024-07-01 in the reference layout (Timestamp,
    Data): a daily sine plus numpy-seeded noise."""
    rng = np.random.default_rng(seed)
    ts = np.datetime64("2024-07-01T00:00") + np.arange(hours).astype("timedelta64[h]")
    hour = np.arange(hours) % 24
    vals = (100 + 20 * np.sin(2 * np.pi * hour / 24) + rng.normal(0, 2, hours)
            if values is None else values)
    with open(path, "w") as f:
        f.write("Timestamp,Data\n")
        for t, v in zip(ts.astype(object), vals):
            f.write(f"{t.strftime(fmt)},{float(v)!r}\n")
    return path


def jax_params(family, seed=0):
    kw = {"hidden": HIDDEN}
    if family == "mlp":
        kw["lookback"] = LOOKBACK
    return [np.asarray(p) for p in FAMILIES[family].init_params(jax.random.PRNGKey(seed), F, **kw)]


def batch(n=5, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (n, LOOKBACK, F)).astype(np.float32),
            rng.normal(0, 1, n).astype(np.float32))


def port_model(family, params):
    return T.MODEL_FAMILIES[family].Model(convert.train_params(params, "cpu"))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_forward_matches_jax(family):
    params = jax_params(family)
    x, _ = batch()
    want = np.asarray(FAMILIES[family].forward([jnp.asarray(p) for p in params], jnp.asarray(x)))
    with torch.no_grad():
        got = port_model(family, params)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (len(x),)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loss_and_gradients_match_jax(family):
    """Dropout off: mse + 0.01·ΣW1² and its gradient for every parameter."""
    params = jax_params(family, seed=2)
    x, y = batch(seed=3)
    (jloss, jmse), jgrads = jax.value_and_grad(JT._loss_fn, has_aux=True)(
        [jnp.asarray(p) for p in params], jnp.asarray(x), jnp.asarray(y), None, False,
        FAMILIES[family])
    model = port_model(family, params)
    loss, mse = T.loss_fn(model, torch.from_numpy(x), torch.from_numpy(y), False)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(mse.item(), float(jmse), rtol=1e-4, atol=1e-6)
    for p, g in zip(model.param_list(), jgrads):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_adam_steps_match_optax(family):
    """Two Adam steps (bias correction at t=1 and 2) from the same
    gradients give the parameters optax.adam gives."""
    params = jax_params(family, seed=4)
    rng = np.random.default_rng(5)
    grads = [[rng.normal(0, 1, p.shape).astype(np.float32) for p in params] for _ in range(2)]
    opt = optax.adam(1e-3)
    jp = [jnp.asarray(p) for p in params]
    state = opt.init(jp)
    model = port_model(family, params)
    topt = T.make_optimizer(model, 1e-3)
    for g in grads:
        updates, state = opt.update([jnp.asarray(a) for a in g], state)
        jp = optax.apply_updates(jp, updates)
        for p, a in zip(model.param_list(), g):
            p.grad = torch.from_numpy(a)
        topt.step()
    for p, want in zip(model.param_list(), jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_forward_shapes_and_size_at_full_width():
    """The reference's model: 7 inputs, hidden 64 — the Keras shapes and
    39,041 parameters, in registration order."""
    model = gru.Model(gru.init_params(torch.Generator().manual_seed(0), 7))
    shapes = [tuple(p.shape) for p in model.parameters()]
    assert shapes == [(7, 192), (64, 192), (2, 192), (64, 192), (64, 192), (2, 192), (64, 1),
                      (1,)]
    assert sum(p.numel() for p in model.parameters()) == 39041
    with torch.no_grad():
        assert model(torch.zeros((5, 24, 7))).shape == (5,)


def test_lstm_at_the_multikey_width():
    """BASELINE.json config 5's stacked LSTM: 7 inputs, hidden 300 —
    1,091,101 parameters in the JAX model's shapes."""
    from ppqsflhe_tpu_torch.train import lstm

    params = lstm.init_params(torch.Generator().manual_seed(0), 7)
    assert lstm.num_params(params) == 1_091_101
    want = jlstm.init_params(jax.random.PRNGKey(0), 7)
    assert [tuple(p.shape) for p in params] == [tuple(p.shape) for p in want]
    assert torch.equal(params[2][300:600], torch.ones(300))      # unit_forget_bias


def test_dropout_uses_the_generator():
    params = jax_params("gru")
    model = port_model("gru", params)
    x = torch.from_numpy(batch()[0])
    run = lambda s: model(x, train=True, generator=torch.Generator().manual_seed(s))
    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))
    with torch.no_grad():
        assert torch.equal(model(x, train=True), model(x))   # no generator: no dropout


DAYFIRST_CSVS = {
    # tests/test_train.py:161's file: 20 days hourly, Data = 0..479
    "dayfirst_480": dict(hours=20 * 24, values=np.arange(20 * 24)),
    "synthetic_400": dict(hours=400, seed=3),
    "iso_60": dict(hours=60, seed=4, fmt="%Y-%m-%d %H:%M:%S"),
}


@pytest.mark.parametrize("dayfirst", [True, False])
@pytest.mark.parametrize("name", sorted(DAYFIRST_CSVS))
def test_data_pipeline_matches_jax(tmp_path, name, dayfirst):
    """Calendar features equal (NaN on NaT rows), the same rows in each
    split, and X / y within 1e-7 — including the bug-compatible
    month-first reading (days 13+ coerce to NaT)."""
    csv = write_csv(str(tmp_path / "d.csv"), **DAYFIRST_CSVS[name])
    jdf = JD.load_timeseries(csv, dayfirst=dayfirst)
    df = D.load_timeseries(csv, dayfirst=dayfirst)
    assert len(df) == len(jdf)
    np.testing.assert_array_equal(df["Timestamp"],
                                  jdf["Timestamp"].to_numpy().astype("datetime64[s]"))
    for col in D.FEATURE_NAMES:
        want = jdf[col].to_numpy(dtype=np.float64, na_value=np.nan)
        np.testing.assert_array_equal(df[col], want, err_msg=col)
    # pandas' default float parser may land one ulp off the correctly
    # rounded value that float() gives
    np.testing.assert_allclose(df[D.TARGET], jdf[D.TARGET].to_numpy(), rtol=1e-15, atol=0)
    if name == "dayfirst_480" and not dayfirst:
        assert np.isnat(df["Timestamp"]).sum() == 8 * 24
    end, start = ("2024-07-12 23:00:00", "2024-07-13 00:00:00")
    jtr, jte = JD.train_test_frames(jdf, end, start)
    tr, te = D.train_test_frames(df, end, start)
    assert (len(tr), len(te)) == (len(jtr), len(jte))
    jfs, jts = JD.Scaler().fit(jtr[JD.FEATURE_NAMES].values), JD.Scaler().fit(jtr[[JD.TARGET]].values)
    fs, ts = D.Scaler().fit(tr[D.FEATURE_NAMES]), D.Scaler().fit(tr[[D.TARGET]])
    lookback = 12 if name == "iso_60" else 24
    for jframe, frame in ((jtr, tr), (jte, te)):
        jX, jy = JD.prepare_sequences(jframe, lookback, jfs, jts)
        X, y = D.prepare_sequences(frame, lookback, fs, ts)
        assert X.shape == jX.shape and X.dtype == jX.dtype
        np.testing.assert_allclose(X, jX, rtol=0, atol=1e-7)
        np.testing.assert_allclose(y, jy, rtol=0, atol=1e-7)


@pytest.mark.parametrize("first, dayfirst, fmt", [
    ("01-07-2024 00:00", True, "%d-%m-%Y %H:%M"),
    ("01-07-2024 00:00", False, "%m-%d-%Y %H:%M"),
    ("13-07-2024 05:00", False, "%d-%m-%Y %H:%M"),
    ("07/13/2024 05:00", True, "%m/%d/%Y %H:%M"),
    ("2024-07-01 00:00:00", True, "%Y-%d-%m %H:%M:%S"),
    ("2024-07-01 00:00:00", False, "%Y-%m-%d %H:%M:%S"),
    ("2024-01-13T01:00:00", True, "%Y-%m-%dT%H:%M:%S"),
    ("2024-07-01", False, "%Y-%m-%d"),
])
def test_guessed_format_is_pandas(first, dayfirst, fmt):
    """The one format guessed from the first timestamp is the one pandas
    infers (``guess_datetime_format``, which ``to_datetime`` applies)."""
    from pandas._libs.tslibs.parsing import guess_datetime_format

    assert D.guess_format(first, dayfirst) == fmt
    assert guess_datetime_format(first, dayfirst=dayfirst) == fmt


def test_summary_json_both_ways(tmp_path):
    """A weights JSON written by either package reads back bit-equal in the
    other, and both write the same document for the same weights."""
    params = jax_params("gru", seed=6)
    jdoc = {"weights_summary": jgru.params_to_summary([jnp.asarray(p) for p in params])}
    pdoc = {"weights_summary": gru.params_to_summary(convert.train_params(params, "cpu"))}
    assert json.dumps(jdoc) == json.dumps(pdoc)
    path = tmp_path / "w.json"
    path.write_text(json.dumps(jdoc))
    back = gru.summary_to_params(json.loads(path.read_text())["weights_summary"], "cpu")
    for a, b in zip(back, params):
        assert torch.equal(a, torch.from_numpy(b))
    path.write_text(json.dumps(pdoc))
    jback = jgru.summary_to_params(json.loads(path.read_text())["weights_summary"])
    for a, b in zip(jback, params):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert [a.shape for a in convert.train_params_np(back)] == [p.shape for p in params]


def client_cfg(tmp, csv, **kw):
    return dict({
        "client_id": "t1", "data_file": csv,
        "train_end_date": "2024-07-12 23:00:00", "test_start_date": "2024-07-13 00:00:00",
        "lookback": 24, "hidden": HIDDEN, "epochs": 3,
        "INPUT_WEIGHTS_PATH": os.path.join(tmp, "weights.json"),
        "OUTPUT_DECRYPTED_WEIGHTS_PATH": os.path.join(tmp, "decrypted.json"),
    }, **kw)


def test_best_epoch_restored_and_checkpointed(tmp_path):
    """Training lowers the loss; early stopping ends the run after a worse
    epoch, and the returned weights are the best epoch's — the newest
    ``*_best_*.npz`` — not the last epoch's (the optimizer updates the
    parameters in place, so the best ones must be a copy)."""
    csv = write_csv(str(tmp_path / "d.csv"))
    cfg = client_cfg(str(tmp_path), csv, epochs=30, patience=2, learning_rate=0.03,
                     log_dir=str(tmp_path / "logs"))
    res = T.train_client(cfg, seed=0, verbose=False, device="cpu")
    h = res.history
    assert h["loss"][-1] < h["loss"][0]
    assert res.val_mse_init is not None and min(h["val_loss"]) < res.val_mse_init
    assert res.best_epoch == int(np.argmin(h["val_loss"]))
    assert res.best_epoch != len(h["val_loss"]) - 1          # stopped after a worse epoch
    newest = max(glob.glob(str(tmp_path / "logs" / "t1_best_*.npz")), key=os.path.getmtime)
    assert T.load_ckpt_meta(newest) == "gru"
    for a, b in zip(res.params, T.load_ckpt(newest, "cpu")):
        assert torch.equal(a, b)
    X = np.zeros((2, 24, 7), np.float32)
    assert not np.array_equal(T.predict(gru, res.params, X, "cpu"),
                              T.predict(gru, res.params[:-1] + [res.params[-1] + 1], X, "cpu"))
    with open(cfg["INPUT_WEIGHTS_PATH"]) as f:
        exported = gru.summary_to_params(json.load(f)["weights_summary"], "cpu")
    for a, b in zip(res.params, exported):
        assert torch.equal(a, b)


def test_warm_start_both_packages(tmp_path):
    """The FL feedback edge across packages: each trainer warm-starts from
    the other's exported JSON, and the port starts from exactly the JAX
    weights (its validation MSE before the first step is the JAX model's)."""
    csv = write_csv(str(tmp_path / "d.csv"))
    cfg = client_cfg(str(tmp_path), csv, epochs=1)
    JT.train_client(cfg, seed=0, verbose=False)
    os.replace(cfg["INPUT_WEIGHTS_PATH"], cfg["OUTPUT_DECRYPTED_WEIGHTS_PATH"])
    res = T.train_client(cfg, seed=1, verbose=False, device="cpu")
    assert res.warm_start == cfg["OUTPUT_DECRYPTED_WEIGHTS_PATH"]
    with open(cfg["OUTPUT_DECRYPTED_WEIGHTS_PATH"]) as f:
        jparams = jgru.summary_to_params(json.load(f)["weights_summary"])
    df = JD.load_timeseries(csv)
    tr, _ = JD.train_test_frames(df, cfg["train_end_date"], cfg["test_start_date"])
    X, y = JD.prepare_sequences(tr, 24, JD.Scaler().fit(tr[JD.FEATURE_NAMES].values),
                                JD.Scaler().fit(tr[[JD.TARGET]].values))
    _, _, Xv, yv = JD.train_val_split(X, y)
    want = float(jnp.mean((jgru.forward(jparams, jnp.asarray(Xv)) - yv) ** 2))
    np.testing.assert_allclose(res.val_mse_init, want, rtol=1e-5)
    os.replace(cfg["INPUT_WEIGHTS_PATH"], cfg["OUTPUT_DECRYPTED_WEIGHTS_PATH"])
    jres = JT.train_client(cfg, seed=2, verbose=False)
    assert len(jres.params) == 8


@pytest.mark.parametrize("family", ["lstm", "mlp", "transformer"])
def test_families_train_and_warm_start(tmp_path, family):
    csv = write_csv(str(tmp_path / "d.csv"))
    w = str(tmp_path / "w.json")
    cfg = {"client_id": "c1", "data_file": csv, "model": family, "hidden": HIDDEN,
           "train_end_date": "2024-07-08 23:00:00", "test_start_date": "2024-07-09 00:00:00",
           "lookback": LOOKBACK, "epochs": 2, "INPUT_WEIGHTS_PATH": w}
    res = T.train_client(cfg, seed=3, verbose=False, device="cpu")
    assert os.path.exists(w) and np.isfinite(res.metrics["train"]["MAE"])
    cfg["OUTPUT_DECRYPTED_WEIGHTS_PATH"] = w
    res2 = T.train_client(cfg, seed=4, verbose=False, device="cpu")
    assert res2.warm_start == w and len(res2.params) == len(res.params)
    assert np.isfinite(T.evaluate_on_test(res2.params, cfg, device="cpu")["MAE"])


def test_evaluate_rounds_matches_jax(tmp_path):
    """Checkpoints written by the JAX trainer's ``_save_ckpt`` evaluate to
    the same per-round metrics in both packages, and the port writes the
    same CSV columns."""
    import pandas as pd

    csv = write_csv(str(tmp_path / "d.csv"))
    cfg = client_cfg(str(tmp_path), csv, log_dir=str(tmp_path / "logs"), model="lstm")
    os.makedirs(cfg["log_dir"])
    for r in (1, 2):
        params = jlstm.init_params(jax.random.PRNGKey(r), 7, hidden=HIDDEN)
        JT._save_ckpt(params, os.path.join(cfg["log_dir"], f"t1_best_2024010{r}_000000.npz"),
                      model="lstm")
    want = JE.evaluate_rounds(cfg, out_dir=str(tmp_path / "jax"), verbose=False)
    got = E.evaluate_rounds(cfg, out_dir=str(tmp_path / "port"), verbose=False, device="cpu")
    assert [r["checkpoint"] for r in got] == list(want["checkpoint"])
    for row, (_, wrow) in zip(got, want.iterrows()):
        assert list(row) == list(want.columns)
        for k, v in row.items():
            if k not in ("round", "checkpoint"):
                np.testing.assert_allclose(v, wrow[k], rtol=1e-4, err_msg=k)
    port_csv = glob.glob(str(tmp_path / "port" / "t1_metrics_rounds_*.csv"))
    jax_csv = glob.glob(str(tmp_path / "jax" / "t1_metrics_rounds_*.csv"))
    assert list(pd.read_csv(port_csv[0]).columns) == list(pd.read_csv(jax_csv[0]).columns)
    assert len(glob.glob(str(tmp_path / "port" / "t1_round*_predictions_*.csv"))) == 2


def test_calc_metrics():
    y = np.array([1.0, 2.0, 3.0])
    m = T.calc_metrics(y, y, y.mean())
    assert m["MAE"] == 0 and m["RMSE"] == 0 and m["R2"] == 1.0
    yp = y + np.array([0.5, -0.5, 1.0])
    assert T.calc_metrics(y, yp, y.mean()) == JT.calc_metrics(y, yp, y.mean())
