"""Local client training loop in torch.

Twin of ``ppqsflhe_tpu.train.trainer`` (the reference's Keras fit pipeline,
client/src/c_trainAndUpdate.py main():84-208):
- warm start from the decrypted global weights JSON when present (:128-133);
- Adam (:class:`.optim.OptaxAdam`, optax.adam's update: betas (0.9,
  0.999), eps 1e-8), mse + l2(0.01) on the first kernel only, added to the
  loss (Keras' kernel_regularizer, not weight decay); full batches of 32
  in a ``torch.randperm`` order; ≤100 epochs; early stopping on the
  validation MSE with patience 4, restoring the best epoch's weights
  (:139-149);
- weight export to the weights_summary JSON schema (:175-190);
- MAE/RMSE/R2/PMAE metrics on train/val in float64 (:58-63,195-199);
- ``.npz`` checkpoints tagged with the model family, and the loss-curve PNG
  when matplotlib imports (:153-166).

The model runs in float32 on ``device`` (the card unless the caller names
another); TF32 stays off. On the card, as the JAX trainer jits its step and
validation MSE, :func:`train_client` runs both as CUDA graphs
(:mod:`.compiled`: each captured once, replayed every step and epoch); on
the CPU it runs the eager :func:`train_step` and :func:`eval_mse`, which
stay the reference the graphs are held to. Randomness: the initializer
draws from a CPU generator seeded with ``seed``, the shuffle from one
seeded ``seed + 1``, dropout from one on ``device`` seeded ``seed + 2``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from datetime import datetime
from typing import Dict, List

import numpy as np
import torch

from . import data as D
from . import gru, lstm, mlp, transformer
from .optim import OptaxAdam

#: selectable model families (cfg key "model"); all share the generic
#: weights_summary export (param_{idx} records) and the Keras weight layout.
MODEL_FAMILIES = {"gru": gru, "lstm": lstm, "mlp": mlp,
                  "transformer": transformer}


@dataclass
class TrainResult:
    params: List[torch.Tensor]
    history: Dict[str, list]
    metrics: Dict[str, Dict[str, float]]
    weights_path: str | None = None
    best_epoch: int = -1
    #: validation MSE at the starting weights, before the first step
    val_mse_init: float | None = None
    #: the decrypted-weights JSON this run started from (None: fresh init)
    warm_start: str | None = None
    #: each epoch's batch MSEs, in step order
    batch_mse: List[List[float]] | None = None
    #: the optimizer after the last epoch: its parameters are the last
    #: epoch's weights (``params`` are the best epoch's), its state the moments
    optimizer: OptaxAdam | None = None


def calc_metrics(y_true, y_pred, y_mean) -> Dict[str, float]:
    mae = float(np.abs(y_true - y_pred).mean())
    rmse = float(np.sqrt(((y_true - y_pred) ** 2).mean()))
    ss_res = float(((y_true - y_pred) ** 2).sum())
    ss_tot = float(((y_true - y_true.mean()) ** 2).sum())
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0
    pmae = float(mae / y_mean * 100) if y_mean != 0 else 0.0
    return {"MAE": mae, "RMSE": rmse, "R2": r2, "PMAE": pmae}


def loss_fn(model, x, y, train: bool, generator=None, l2: float = 0.01):
    """(mse + l2·ΣW1², mse): the Keras l2 term on the first kernel only."""
    pred = model(x, train=train, generator=generator)
    mse = torch.mean((pred - y) ** 2)
    reg = l2 * torch.sum(model.param_list()[0] ** 2)
    return mse + reg, mse


def make_optimizer(model, lr: float = 1e-3) -> OptaxAdam:
    """optax.adam(lr)'s update: betas (0.9, 0.999), eps 1e-8 outside the
    square root, bias-corrected moments."""
    return OptaxAdam(model.parameters(), lr=lr, b1=0.9, b2=0.999, eps=1e-8)


def train_step(model, opt, x, y, generator) -> torch.Tensor:
    """One Adam step on one batch (dropout on); returns the batch MSE on
    the device."""
    opt.zero_grad(set_to_none=True)
    loss, mse = loss_fn(model, x, y, True, generator)
    loss.backward()
    opt.step()
    return mse.detach()


def run_epoch(model, opt, X, y, batch: int, shuffle_gen, drop_gen,
              step=None) -> List[torch.Tensor]:
    """One epoch of full batches in a fresh random order; the partial last
    batch is skipped. Returns the batch MSEs (device tensors). ``step``, a
    :class:`.compiled.CompiledStep` over the same model, optimizer, data
    and generator, takes each batch's indices in place of
    :func:`train_step`."""
    order = torch.randperm(len(X), generator=shuffle_gen).to(X.device)
    losses = []
    for b in range(max(1, len(X) // batch)):
        sel = order[b * batch : (b + 1) * batch]
        if len(sel) < batch:
            continue
        losses.append(train_step(model, opt, X[sel], y[sel], drop_gen) if step is None
                      else step(sel))
    return losses


@torch.no_grad()
def val_mse(model, X, y) -> torch.Tensor:
    """The model's MSE on (X, y), no dropout, on the device."""
    return torch.mean((model(X) - y) ** 2)


def eval_mse(model, X, y) -> float:
    return float(val_mse(model, X, y))


@torch.no_grad()
def predict(mdl, params, X: np.ndarray, device) -> np.ndarray:
    """The family's forward at ``params`` on ``device`` (no dropout)."""
    model = mdl.Model(params).to(device)
    return model(torch.from_numpy(np.asarray(X, np.float32)).to(device)).cpu().numpy()


def _frames(cfg: Dict):
    df = D.load_timeseries(cfg["data_file"], dayfirst=bool(cfg.get("timestamp_dayfirst", True)))
    train_df, test_df = D.train_test_frames(df, cfg["train_end_date"], cfg["test_start_date"])
    fs = D.Scaler().fit(train_df[D.FEATURE_NAMES])
    tscl = D.Scaler().fit(train_df[[D.TARGET]])
    return train_df, test_df, fs, tscl


def train_client(cfg: Dict, seed: int = 0, verbose: bool = True, device="cuda") -> TrainResult:
    """cfg is the CLIENT section of the reference c_config.json (same keys)."""
    client_id = cfg.get("client_id", "client")
    lookback = int(cfg.get("lookback", 72))
    family = cfg.get("model", "gru")
    mdl = MODEL_FAMILIES[family]
    ts_tag = datetime.now().strftime("%Y%m%d_%H%M%S")
    log_dir = cfg.get("log_dir")
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)

    # Telemetry ingestion hook (the reference's Kafka → client-local-storage
    # handoff, README.md:36): drain any new records from the client's topic
    # into data_file before training reads it.
    if cfg.get("telemetry_broker_root"):
        from ..ingest import Broker, CsvMaterializer

        n_new = CsvMaterializer(Broker(cfg["telemetry_broker_root"]),
                                client_id, cfg["data_file"]).drain()
        if verbose and n_new:
            print(f"[{client_id}] ingested {n_new} new telemetry records")

    train_df, _, fs, tscl = _frames(cfg)
    X, y = D.prepare_sequences(train_df, lookback, fs, tscl)
    X_tr, y_tr, X_val, y_val = D.train_val_split(X, y)

    n_features = X.shape[-1]
    warm = cfg.get("OUTPUT_DECRYPTED_WEIGHTS_PATH")
    warm_start = None
    if warm and os.path.exists(warm):
        with open(warm) as f:
            params = gru.summary_to_params(json.load(f)["weights_summary"], device)
        warm_start = warm
        if verbose:
            print(f"[{client_id}] warm start from {warm}")
    else:
        kw = {}
        if cfg.get("hidden"):
            kw["hidden"] = int(cfg["hidden"])
        if mdl is mlp:
            kw["lookback"] = lookback
        params = mdl.init_params(torch.Generator().manual_seed(seed), n_features, **kw)
        if verbose:
            print(f"[{client_id}] fresh model")

    model = mdl.Model(params).to(device)
    opt = make_optimizer(model, float(cfg.get("learning_rate", 1e-3)))
    dev = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)
    Xt, yt, Xv, yv = dev(X_tr), dev(y_tr), dev(X_val), dev(y_val)

    batch = int(cfg.get("batch_size", 32))
    epochs = int(cfg.get("epochs", 100))
    patience = int(cfg.get("patience", 4))
    shuffle_gen = torch.Generator().manual_seed(seed + 1)
    drop_gen = torch.Generator(device=device).manual_seed(seed + 2)
    step, evaluate = None, (lambda: eval_mse(model, Xv, yv))
    if Xt.is_cuda:
        from .compiled import CompiledEval, CompiledStep

        step = CompiledStep(model, opt, Xt, yt, batch, drop_gen)
        if len(X_val):
            evaluate = CompiledEval(model, Xv, yv)
    val_mse_init = evaluate() if len(X_val) else None

    history = {"loss": [], "val_loss": []}
    batch_mse = []
    best_val, best_epoch = np.inf, -1
    best_params = [p.detach().clone() for p in model.parameters()]
    for epoch in range(epochs):
        losses = run_epoch(model, opt, Xt, yt, batch, shuffle_gen, drop_gen, step)
        ep_losses = [float(v) for v in torch.stack(losses).cpu()] if losses else []
        batch_mse.append(ep_losses)
        vl = evaluate() if len(X_val) else float(np.mean(ep_losses))
        history["loss"].append(float(np.mean(ep_losses)))
        history["val_loss"].append(vl)
        if vl < best_val - 1e-12:
            # a copy: the optimizer updates the parameters in place
            best_val, best_epoch = vl, epoch
            best_params = [p.detach().clone() for p in model.parameters()]
            if log_dir:  # best-checkpoint (ModelCheckpoint equivalent)
                _save_ckpt(best_params, os.path.join(log_dir, f"{client_id}_best_{ts_tag}.npz"),
                           model=family)
        if epoch - best_epoch >= patience:
            break
    params = best_params

    def inv(p):
        return tscl.inverse(np.asarray(p).reshape(-1, 1)).flatten()

    pred_tr = inv(predict(mdl, params, X_tr, device))
    ytr = inv(y_tr)
    metrics = {"train": calc_metrics(ytr, pred_tr, ytr.mean())}
    if len(X_val):
        pred_val = inv(predict(mdl, params, X_val, device))
        yva = inv(y_val)
        metrics["val"] = calc_metrics(yva, pred_val, yva.mean())
    if verbose:
        print(f"[{client_id}] epochs={len(history['loss'])} metrics={metrics}")

    weights_path = cfg.get("INPUT_WEIGHTS_PATH")
    if weights_path:
        with open(weights_path, "w") as f:
            json.dump({"weights_summary": gru.params_to_summary(params)}, f)
    if cfg.get("model_file"):
        _save_ckpt(params, cfg["model_file"], model=family)
    if log_dir:
        _plot_loss(history, client_id, os.path.join(log_dir, f"{client_id}_loss_curve_{ts_tag}.png"))
    return TrainResult(params=params, history=history, metrics=metrics,
                       weights_path=weights_path, best_epoch=best_epoch,
                       val_mse_init=val_mse_init, warm_start=warm_start,
                       batch_mse=batch_mse, optimizer=opt)


def _save_ckpt(params, path: str, model: str = "gru") -> None:
    if not path.endswith(".npz"):
        path = path + ".npz" if "." not in os.path.basename(path) else path
    # __model__ records the family so offline evaluation (evaluate.py) can
    # dispatch the right forward
    np.savez(path, *[p.detach().cpu().numpy() for p in params], __model__=np.array(model))


def load_ckpt(path: str, device="cuda") -> List[torch.Tensor]:
    z = np.load(path)
    return [torch.from_numpy(z[k]).to(device) for k in z.files if not k.startswith("__")]


def load_ckpt_meta(path: str) -> str | None:
    """Model-family tag of a checkpoint ('gru'/'lstm'/…), or None for
    pre-tag checkpoints."""
    z = np.load(path)
    return str(z["__model__"]) if "__model__" in z.files else None


def _plot_loss(history, client_id, path):
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    plt.figure(figsize=(8, 5))
    plt.plot(history["loss"], label="Train Loss")
    plt.plot(history["val_loss"], label="Validation Loss")
    plt.xlabel("Epochs")
    plt.ylabel("Loss (MSE)")
    plt.title(f"Training Loss Curve - {client_id}")
    plt.legend()
    plt.grid(True)
    plt.savefig(path, dpi=100, bbox_inches="tight")
    plt.close()


def evaluate_on_test(params, cfg: Dict, device="cuda") -> Dict[str, float]:
    """Test-split metrics (the c_evalulate_rounds.py per-round evaluation)."""
    lookback = int(cfg.get("lookback", 72))
    _, test_df, fs, tscl = _frames(cfg)
    Xt, yt = D.prepare_sequences(test_df, lookback, fs, tscl)
    if not len(Xt):
        return {}
    mdl = MODEL_FAMILIES[cfg.get("model", "gru")]
    pred = tscl.inverse(predict(mdl, params, Xt, device).reshape(-1, 1)).flatten()
    truth = tscl.inverse(np.asarray(yt).reshape(-1, 1)).flatten()
    return calc_metrics(truth, pred, truth.mean())
