"""The compiled training step (``ppqsflhe_tpu_torch/train/compiled.py``) and
the port's optax Adam (``train/optim.py``) on the CPU, where no CUDA graph
can be captured: ``OptaxAdam`` gives ``optax.adam``'s parameters over ten
steps for all four families; ``CompiledStep`` and ``CompiledEval`` refuse
a CPU model and never train eagerly instead; the captured step body (a
gather from static buffers, then ``train_step``) is bit-equal to
``train_step`` on ``X[sel]``, dropout on, and so is an epoch run through
it; the steady step and validation bodies make no host sync (the patch of
``test_torch_compiled.py``). The capture, its replays and their
bit-equality with the eager trainer on the card are ``chip_smoke.py``'s
compiled-training phase. Small sizes: lookback 12, hidden 8."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ppqsflhe_tpu_torch.train import compiled
from ppqsflhe_tpu_torch.train import trainer as T
from ppqsflhe_tpu_torch.train.optim import OptaxAdam
from test_torch_compiled import HOST_SYNCS, _refuse
from test_torch_train import FAMILIES, batch, client_cfg, jax_params, port_model, write_csv

BATCH, N_ROWS = 4, 10


def data(seed):
    return tuple(torch.from_numpy(a) for a in batch(n=N_ROWS, seed=seed))


def twins(family, seed):
    """Two models and optimizers from the same JAX weights."""
    models = [port_model(family, jax_params(family, seed=seed)) for _ in range(2)]
    return [(m, T.make_optimizer(m, 1e-2)) for m in models]


def opt_state(opt):
    return [t for p in opt.param_groups[0]["params"] for t in opt.state[p].values()] + [
        opt.param_groups[0]["count"]]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_optax_adam_ten_steps(family):
    """Ten steps from numpy-seeded gradients give optax.adam's parameters
    (t = 1 … 10 in the bias corrections); ``make_optimizer`` is it."""
    params = jax_params(family, seed=7)
    rng = np.random.default_rng(8)
    grads = [[rng.normal(0, 1, p.shape).astype(np.float32) for p in params] for _ in range(10)]
    opt = optax.adam(1e-3)
    jp = [jnp.asarray(p) for p in params]
    state = opt.init(jp)
    model = port_model(family, params)
    topt = T.make_optimizer(model, 1e-3)
    assert isinstance(topt, OptaxAdam)
    for g in grads:
        updates, state = opt.update([jnp.asarray(a) for a in g], state)
        jp = optax.apply_updates(jp, updates)
        for p, a in zip(model.param_list(), g):
            p.grad = torch.from_numpy(a)
        topt.step()
    assert float(topt.param_groups[0]["count"]) == 10.0
    for p, want in zip(model.param_list(), jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("make", ["step", "eval"])
def test_compiled_refuses_cpu(monkeypatch, make):
    """A CPU model raises before anything runs: there is no eager path."""
    (model, opt), _ = twins("gru", 1)
    X, y = data(2)

    def eager(*args, **kwargs):
        raise AssertionError("the compiled trainer ran eagerly on the CPU")

    monkeypatch.setattr(compiled, "train_step", eager)
    monkeypatch.setattr(compiled, "val_mse", eager)
    with pytest.raises(RuntimeError, match="CUDA graph"):
        if make == "step":
            compiled.CompiledStep(model, opt, X, y, BATCH, torch.Generator())
        else:
            compiled.CompiledEval(model, X, y)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_step_body_equals_train_step(family):
    """Three steps of the captured body over static buffers, dropout on,
    against ``train_step`` on ``X[sel]``: MSEs, weights, moments and
    count, and the generator's state equal bit for bit."""
    (m1, o1), (m2, o2) = twins(family, 3)
    X, y = data(4)
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    idx = torch.zeros(BATCH, dtype=torch.int64)
    order = torch.randperm(N_ROWS, generator=torch.Generator().manual_seed(6))
    for sel in (order[:BATCH], order[BATCH:2 * BATCH], order[2:2 + BATCH]):
        idx.copy_(sel)
        got = compiled.step_body(m1, o1, X, y, idx, g1)
        want = T.train_step(m2, o2, X[sel], y[sel], g2)
        assert torch.equal(got, want)
    for a, b in zip(list(m1.parameters()) + opt_state(o1), list(m2.parameters()) + opt_state(o2)):
        assert torch.equal(a, b)
    assert torch.equal(g1.get_state(), g2.get_state())


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_epoch_through_a_step_equals_eager(family):
    """``run_epoch`` with a step callable (as ``train_client`` passes its
    ``CompiledStep``) takes each batch's indices and gives the eager
    epoch's losses and weights; ``val_mse`` is ``eval_mse``'s tensor."""
    (m1, o1), (m2, o2) = twins(family, 9)
    X, y = data(10)
    g1, g2 = torch.Generator().manual_seed(11), torch.Generator().manual_seed(11)
    s1, s2 = torch.Generator().manual_seed(12), torch.Generator().manual_seed(12)
    idx = torch.zeros(BATCH, dtype=torch.int64)

    def step(sel):
        idx.copy_(sel)
        return compiled.step_body(m1, o1, X, y, idx, g1)

    for _ in range(2):
        got = T.run_epoch(m1, o1, X, y, BATCH, s1, g1, step)
        want = T.run_epoch(m2, o2, X, y, BATCH, s2, g2)
        assert len(got) == N_ROWS // BATCH and torch.equal(torch.stack(got), torch.stack(want))
    for a, b in zip(m1.parameters(), m2.parameters()):
        assert torch.equal(a, b)
    assert float(T.val_mse(m1, X, y)) == T.eval_mse(m2, X, y)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_steady_step_has_no_host_sync(monkeypatch, family):
    """After one warm-up step (the compiled step warms up the same way),
    the step and validation bodies run with every host sync patched to
    raise."""
    (model, opt), (ref, ref_opt) = twins(family, 13)
    X, y = data(14)
    gen, ref_gen = torch.Generator().manual_seed(15), torch.Generator().manual_seed(15)
    idx = torch.arange(BATCH)
    compiled.step_body(model, opt, X, y, idx, gen)
    T.train_step(ref, ref_opt, X[:BATCH], y[:BATCH], ref_gen)
    for owner, name in HOST_SYNCS:
        monkeypatch.setattr(owner, name, _refuse(name))
    mse = compiled.step_body(model, opt, X, y, idx, gen)
    val = T.val_mse(model, X, y)
    monkeypatch.undo()
    assert torch.equal(mse, T.train_step(ref, ref_opt, X[:BATCH], y[:BATCH], ref_gen))
    assert float(val) == T.eval_mse(ref, X, y)


def test_train_client_on_cpu_is_eager(tmp_path, monkeypatch):
    """On the CPU ``train_client`` builds no compiled step or eval; its
    result carries each epoch's batch MSEs (their means are the loss
    history) and the optimizer after the last epoch."""
    def refuse(*args, **kwargs):
        raise AssertionError("train_client built a CUDA graph on the CPU")

    monkeypatch.setattr(compiled, "CompiledStep", refuse)
    monkeypatch.setattr(compiled, "CompiledEval", refuse)
    cfg = client_cfg(str(tmp_path), write_csv(str(tmp_path / "d.csv")), epochs=2, patience=5)
    res = T.train_client(cfg, seed=0, verbose=False, device="cpu")
    assert len(res.batch_mse) == 2 and all(res.batch_mse)
    assert res.history["loss"] == [float(np.mean(b)) for b in res.batch_mse]
    assert isinstance(res.optimizer, OptaxAdam)
    assert float(res.optimizer.param_groups[0]["count"]) == sum(map(len, res.batch_mse))
