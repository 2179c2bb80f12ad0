"""The compiled server round (``ppqsflhe_tpu_torch/fl/compiled.py``) on the
CPU, where no CUDA graph can be captured: :class:`CompiledRound` refuses a
CPU scheme and never runs the round eagerly instead; the steady-state
round makes no host sync (``item``, ``tolist``, ``cpu``, ``numpy``,
``torch.tensor``/``as_tensor``/``from_numpy``, a tensor's truth value or
number) once its caches are warm, in all five schedules and both NTT
implementations, so a capture cannot meet one; and the function that is
captured gives the JAX package's round (``bench.py``'s ``server_round``)
bit for bit, from the slice test's JAX keys and ciphertexts (and, on the
radix-2 order, from the same world made by a radix-2 JAX scheme). The capture,
its replay and its bit-equality with the eager round on the card are
``chip_smoke.py``'s compiled-round phase."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppqsflhe_tpu_torch import convert
from ppqsflhe_tpu_torch.ckks import eval as ev
from ppqsflhe_tpu_torch.ckks.params import CkksParams
from ppqsflhe_tpu_torch.bench import server_round as twin
from ppqsflhe_tpu_torch.ckks.scheme import CkksScheme
from ppqsflhe_tpu_torch.ckks.types import Ciphertext
from ppqsflhe_tpu_torch.fl import api, compiled
from ppqsflhe_tpu_torch.ops.cuda_ntt import BUTTERFLY, MXU
from test_torch_slice import B, N, _encrypt_batch, _jax_server_round, world  # noqa: F401

from ppqsflhe_tpu.ckks.params import CkksParams as JaxParams
from ppqsflhe_tpu.ckks.scheme import CkksScheme as JaxScheme

N_SMALL = 1 << 10
# what a capture cannot contain: a copy to the host, a host value read from
# a tensor, or an upload from the host
HOST_SYNCS = ((torch.Tensor, "item"), (torch.Tensor, "tolist"), (torch.Tensor, "cpu"),
              (torch.Tensor, "numpy"), (torch.Tensor, "__bool__"), (torch.Tensor, "__int__"),
              (torch.Tensor, "__float__"), (torch, "tensor"), (torch, "as_tensor"),
              (torch, "from_numpy"))


def _keys_and_stacks(sch, seed):
    gen = torch.Generator().manual_seed(seed)
    sk1, pk1 = sch.keygen(gen)
    sk2, pk2 = sch.keygen(gen)
    rk12 = ev.ksk_to_mont(sch.ctx, sch.rekey_gen(sk1, pk2, gen))
    rk21 = ev.ksk_to_mont(sch.ctx, sch.rekey_gen(sk2, pk1, gen))
    rng = np.random.default_rng(seed)
    vals = [rng.uniform(-1, 1, sch.encoder.slots) for _ in range(2)]
    return rk12, rk21, sch.encrypt_values(pk1, vals, gen), sch.encrypt_values(pk2, vals, gen)


@pytest.fixture(scope="module")
def small():
    """N=2^10 schemes in both four-step NTT implementations and on the
    radix-2 order, with keys and stacks."""
    out = {}
    for impl in (MXU, BUTTERFLY, "radix2"):
        kw = {"ntt_backend": "radix2"} if impl == "radix2" else {"ntt_impl": impl}
        sch = CkksScheme(CkksParams.generate(n=N_SMALL, mult_depth=2, scale_bits=40, dnum=2,
                                             **kw), device="cpu")
        out[impl] = (sch,) + _keys_and_stacks(sch, 3)
    return out


def test_compiled_round_refuses_cpu(small, monkeypatch):
    """A CPU scheme raises before any round runs: there is no eager path."""
    sch, rk12, rk21, c1, _ = small[MXU]

    def eager(*args, **kwargs):
        raise AssertionError("CompiledRound ran the round on the CPU")

    monkeypatch.setattr(compiled, "server_round", eager)
    with pytest.raises(RuntimeError, match="CUDA graph"):
        compiled.CompiledRound(sch, rk12, rk21, 4, c1.data.shape[:-3])


def test_host_sync_patch_catches_a_sync(monkeypatch):
    """The patch of the capture-safety test below does catch each sync."""
    for owner, name in HOST_SYNCS:
        monkeypatch.setattr(owner, name, _refuse(name))
    t = torch.ones(2, dtype=torch.int64)
    for call in (lambda: t[0].item(), lambda: t.tolist(), lambda: t.cpu(), lambda: t.numpy(),
                 lambda: bool(t[0]), lambda: int(t[0]), lambda: float(t[0]),
                 lambda: torch.tensor([1]), lambda: torch.as_tensor(np.ones(1)),
                 lambda: torch.from_numpy(np.ones(1))):
        with pytest.raises(RuntimeError, match="host sync"):
            call()


def _refuse(name):
    def refuse(*args, **kwargs):
        raise RuntimeError(f"host sync in the round: {name}")
    return refuse


@pytest.mark.parametrize("lazy", api.LAZY_MODES)
@pytest.mark.parametrize("impl", [MXU, BUTTERFLY, "radix2"])
def test_steady_round_has_no_host_sync(small, monkeypatch, impl, lazy):
    """After one warm-up round (the compiled round warms up the same way),
    the round runs with every host sync patched to raise, and gives the
    warm-up's residues."""
    sch, rk12, rk21, c1, c2 = small[impl]
    warm = api.server_round(sch, c1, c2, rk12, rk21, lazy)
    for owner, name in HOST_SYNCS:
        monkeypatch.setattr(owner, name, _refuse(name))
    steady = api.server_round(sch, c1, c2, rk12, rk21, lazy)
    monkeypatch.undo()
    for a, b in zip(warm, steady):
        assert torch.equal(a.data, b.data) and a.scale == b.scale


@pytest.mark.parametrize("lazy", [4, 0, 1, 2, 3],
                         ids=["lazy4", "full_level", "lazy1", "lazy2", "lazy3"])
def test_captured_round_bitequal_to_jax(world, lazy):  # noqa: F811
    """The captured function is the eager ``fl.api.server_round``; over
    zeroed buffers filled with the JAX package's ciphertexts, as the static
    inputs are, it gives the JAX round's residues in both NTT
    implementations."""
    w = world
    assert compiled.server_round is api.server_round
    k12, k21 = (jnp.asarray(convert.residues_np(k.data)) for k in (w["rk12"], w["rk21"]))
    want = jax.jit(lambda a, b, c, d: _jax_server_round(w["js"], a, b, c, d, w["scale"], lazy))(
        jnp.asarray(w["s1"]), jnp.asarray(w["s2"]), k12, k21)
    params = w["sch"].params
    for impl in (MXU, BUTTERFLY):
        sch = CkksScheme(dataclasses.replace(params, ntt_impl=impl), device="cpu")
        bufs = [torch.zeros(s.shape, dtype=torch.int64) for s in (w["s1"], w["s2"])]
        for buf, s in zip(bufs, (w["s1"], w["s2"])):
            buf.copy_(convert.residues(s, "cpu"))
        got = compiled.server_round(sch, *(Ciphertext(b, w["scale"]) for b in bufs),
                                    w["rk12"], w["rk21"], lazy)
        for g, j in zip(got, want):
            np.testing.assert_array_equal(convert.residues_np(g.data), np.asarray(j))


@pytest.fixture(scope="module")
def radix2_world():
    """The slice test's world made by a radix-2 JAX scheme: keys and
    ciphertexts of the JAX package, rekeys of the port, at N=2^11."""
    jp = JaxParams.generate(n=N, mult_depth=2, scale_bits=40, dnum=2, ntt_backend="radix2")
    js = JaxScheme(jp)
    sch = CkksScheme(convert.params(dataclasses.asdict(jp)), device="cpu")
    assert sch.params.ntt_backend == "radix2"
    k0 = jax.random.PRNGKey(4)
    (jsk1, jpk1), (jsk2, jpk2) = (js.keygen(jax.random.fold_in(k0, i)) for i in (1, 2))
    sk1, sk2 = (convert.secret_key(np.asarray(k.s_eval), np.asarray(k.s_int), device="cpu")
                for k in (jsk1, jsk2))
    pk1, pk2 = (convert.public_key(np.asarray(k.data), device="cpu") for k in (jpk1, jpk2))
    gen = torch.Generator().manual_seed(5)
    rk12 = ev.ksk_to_mont(sch.ctx, sch.rekey_gen(sk1, pk2, gen))
    rk21 = ev.ksk_to_mont(sch.ctx, sch.rekey_gen(sk2, pk1, gen))
    rng = np.random.default_rng(9)
    vs = [[rng.uniform(-1, 1, js.encoder.slots) for _ in range(B)] for _ in range(2)]
    s1, s2 = (np.stack([np.asarray(c.data) for c in _encrypt_batch(
        js, pk, v, jax.random.fold_in(k0, 5 + i))]) for i, (pk, v) in enumerate(
        zip((jpk1, jpk2), vs)))
    return dict(js=js, sch=sch, rk12=rk12, rk21=rk21, s1=s1, s2=s2, scale=js.params.scale)


@pytest.mark.parametrize("lazy", [4, 0, 1, 2, 3],
                         ids=["lazy4", "full_level", "lazy1", "lazy2", "lazy3"])
def test_captured_round_bitequal_to_jax_radix2(radix2_world, lazy):
    """As above on the radix-2 order (``core/ntt.Radix2Ntt``, plain torch
    on every device): the captured function over static buffers gives the
    radix-2 JAX round's residues."""
    w = radix2_world
    k12, k21 = (jnp.asarray(convert.residues_np(k.data)) for k in (w["rk12"], w["rk21"]))
    want = jax.jit(lambda a, b, c, d: _jax_server_round(w["js"], a, b, c, d, w["scale"], lazy))(
        jnp.asarray(w["s1"]), jnp.asarray(w["s2"]), k12, k21)
    bufs = [torch.zeros(s.shape, dtype=torch.int64) for s in (w["s1"], w["s2"])]
    for buf, s in zip(bufs, (w["s1"], w["s2"])):
        buf.copy_(convert.residues(s, "cpu"))
    got = compiled.server_round(w["sch"], *(Ciphertext(b, w["scale"]) for b in bufs),
                                w["rk12"], w["rk21"], lazy)
    for g, j in zip(got, want):
        np.testing.assert_array_equal(convert.residues_np(g.data), np.asarray(j))


def test_twin_json_has_compiled_keys():
    """The bench twin's line carries the compiled round's keys beside its
    own (None on the CPU, where nothing is captured), "card" still last."""
    got = []
    r = twin.bench("cpu", lazy=4, n=1 << 11, count=1, out=lambda s: got.append(json.loads(s)))
    assert got == [r] and r["correct"] and r["value"] is None
    assert all(k in r and r[k] is None for k in twin.COMPILED_KEYS)
    assert list(r)[-1] == "card"
