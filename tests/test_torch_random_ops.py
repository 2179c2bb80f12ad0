"""The port's randomized operations split into draws and bodies
(``core/sampling.py``, ``ckks/rlwe.py``, ``ckks/eval.py``,
``ckks/threshold.py``, ``ckks/scheme.py``), on the CPU:

- the batched samplers at B = 1 and 7 hold the distribution checks of
  ``tests/test_torch_slice.py::test_samplers_distribution``;
- the CDT count by ``searchsorted`` equals the comparison matrix it
  replaced on every edge of the table and on 10^5 random patterns;
- every randomized operation makes one sampler call of each kind, at B = 1
  and B = 27 alike;
- at N=2^10, in both four-step implementations and on the radix-2 order,
  every randomized operation fed numpy-seeded draws gives the JAX function
  fed the same draws bit for bit (the JAX samplers patched with per-kind
  queues, the JAX functions run unjitted);
- every body runs warm with every host sync patched to raise (the patch of
  ``tests/test_torch_compiled.py``).

The bodies' capture on the card, ``torch.equal`` to the eager bodies on
the same draws from CUDA and CPU generators, is ``chip_smoke.py``'s
phase 17."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppqsflhe_tpu.ckks import eval as jev
from ppqsflhe_tpu.ckks import rlwe as jrlwe
from ppqsflhe_tpu.ckks.params import CkksParams as JaxParams
from ppqsflhe_tpu.ckks.scheme import CkksScheme as JaxScheme
from ppqsflhe_tpu.ckks.types import Ciphertext as JaxCt
from ppqsflhe_tpu.ckks.types import KeySwitchKey as JaxKsk
from ppqsflhe_tpu.ckks.types import Plaintext as JaxPt
from ppqsflhe_tpu.ckks.types import PublicKey as JaxPk
from ppqsflhe_tpu.ckks.types import SecretKey as JaxSk
from ppqsflhe_tpu.core import sampling as jsampling
from ppqsflhe_tpu_torch import convert
from ppqsflhe_tpu_torch.ckks import eval as ev
from ppqsflhe_tpu_torch.ckks import rlwe
from ppqsflhe_tpu_torch.ckks import threshold as th
from ppqsflhe_tpu_torch.ckks.params import CkksParams
from ppqsflhe_tpu_torch.ckks.scheme import CkksScheme
from ppqsflhe_tpu_torch.ckks.types import Ciphertext
from ppqsflhe_tpu_torch.core import sampling
from ppqsflhe_tpu_torch.core.modarith import INT64_MIN
from ppqsflhe_tpu_torch.ops.cuda_ntt import BUTTERFLY, MXU
from test_torch_compiled import HOST_SYNCS, _refuse

N = 1 << 10
KINDS = ("ternary", "discrete_gaussian", "uniform_rns", "uniform_signed")
CONFIGS = {MXU: ("fourstep", MXU), BUTTERFLY: ("fourstep", BUTTERFLY),
           "radix2": ("radix2", "xla")}
JAX_IMPL = {"fourstep": "mxu", "radix2": "xla"}
SEED_A = bytes(range(16))


# ---------------------------------------------------------------------------
# The samplers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch", [1, 7])
def test_batched_samplers_distribution(batch):
    """One call over (B, n): the shape asked for, and over all of it the
    moments, support, symmetry and ranges of the one-entry checks."""
    gen = torch.Generator().manual_seed(batch)
    shape = (batch, 60000 // batch)
    t = sampling.ternary(gen, shape)
    assert t.shape == shape and t.dtype == torch.int32
    t = t.numpy()
    assert set(np.unique(t)) == {-1, 0, 1}
    assert all(abs(np.mean(t == v) - 1 / 3) < 0.01 for v in (-1, 0, 1))
    g = sampling.discrete_gaussian(gen, shape)
    assert g.shape == shape and g.dtype == torch.int32
    g = g.numpy()
    assert abs(g.mean()) < 0.05 and abs(g.std() - sampling.SIGMA) < 0.05
    assert np.abs(g).max() <= len(sampling._cdt_thresholds(sampling.SIGMA))
    assert abs(np.mean(g > 0) - np.mean(g < 0)) < 0.02
    moduli = [97, (1 << 59) + 21]
    u = sampling.uniform_rns(gen, moduli, shape)
    assert u.shape == (batch, 2, shape[1]) and u.dtype == torch.int64
    u = u.numpy()
    assert u[:, 0].min() >= 0 and u[:, 0].max() < 97 and u[:, 1].max() < moduli[1]
    assert abs(np.mean(u[:, 0]) - 48) < 1.0
    assert abs(np.mean(u[:, 1] / moduli[1]) - 0.5) < 0.01
    f = sampling.uniform_signed(gen, shape, 20)
    assert f.shape == shape and f.dtype == torch.int64
    f = f.numpy()
    assert f.min() >= -(1 << 20) and f.max() <= 1 << 20
    assert abs(f.mean()) < 0.01 * (1 << 20) and abs(f.std() / (1 << 20) - 3 ** -0.5) < 0.01
    assert not sampling.uniform_signed(gen, shape, 0).any()


def test_cdt_count_equals_the_comparison():
    """#{thresholds ≤ u} by ``searchsorted`` on the sign-flipped table
    equals the (len(u), T) comparison it replaced and a numpy uint64 count,
    on 0, every threshold − 1, every threshold, 2^64 − 1 and 10^5 random
    patterns; the table is uploaded once per (σ, device)."""
    thr = sampling._cdt_thresholds(sampling.SIGMA)
    ends = np.array([0, 2**64 - 1], dtype=np.uint64)
    edges = np.concatenate([ends[:1], thr - np.uint64(1), thr, ends[1:]])
    rand = np.random.default_rng(3).integers(0, 2**64 - 1, 10**5, dtype=np.uint64,
                                             endpoint=True)
    u_np = np.concatenate([edges, rand])
    u = torch.from_numpy(u_np.view(np.int64))
    table = sampling._cdt_table(sampling.SIGMA, torch.device("cpu"))
    assert table is sampling._cdt_table(sampling.SIGMA, torch.device("cpu"))
    got = torch.searchsorted(table, u ^ INT64_MIN, right=True)
    thr_t = torch.from_numpy(thr.view(np.int64))
    old = ((u ^ INT64_MIN)[:, None] >= (thr_t ^ INT64_MIN)[None, :]).sum(1)
    assert torch.equal(got, old)
    np.testing.assert_array_equal(got.numpy(), (u_np[:, None] >= thr[None, :]).sum(1))
    assert got[0] == 0 and got[-len(rand) - 1] == len(thr)


# ---------------------------------------------------------------------------
# The worlds: a port scheme per order (PREMode INDCCA), its JAX twin
# ---------------------------------------------------------------------------

def _port_scheme(backend, impl):
    p = CkksParams.generate(n=N, mult_depth=2, scale_bits=40, dnum=2, ntt_backend=backend,
                            ntt_impl=impl)
    return CkksScheme(dataclasses.replace(p, pre_mode="INDCCA"), device="cpu")


@pytest.fixture(scope="module")
def worlds():
    """Per configuration: the port's scheme with two key pairs, a rekey,
    a batch of two plaintexts and their ciphertexts, and the JAX scheme on
    the same chain with the same keys and data."""
    jschemes, out = {}, {}
    for name, (backend, impl) in CONFIGS.items():
        sch = _port_scheme(backend, impl)
        gen = torch.Generator().manual_seed(17)
        sk, pk = sch.keygen(gen)
        sk2, pk2 = sch.keygen(gen)
        rng = np.random.default_rng(18)
        vs = [rng.uniform(-1, 1, sch.encoder.slots) * 0.5 for _ in range(2)]
        pt = sch.make_plaintext(vs)
        ct = sch.encrypt(pk, pt, gen)
        rk = ev.ksk_to_mont(sch.ctx, sch.rekey_gen(sk, pk2, gen))
        if backend not in jschemes:
            jp = JaxParams(**{**dataclasses.asdict(sch.params), "ntt_impl": JAX_IMPL[backend]})
            jschemes[backend] = JaxScheme(jp)
        J = lambda t: jnp.asarray(convert.residues_np(t))
        out[name] = dict(
            sch=sch, sk=sk, pk=pk, sk2=sk2, pk2=pk2, vs=vs, pt=pt, ct=ct, rk=rk,
            js=jschemes[backend], jsk=JaxSk(s_eval=J(sk.s_eval), s_int=sk.s_int),
            jpk=JaxPk(J(pk.data)), jpk2=JaxPk(J(pk2.data)),
            jpts=[JaxPt(J(pt.data[i]), pt.scale) for i in range(2)],
            jcts=[JaxCt(J(ct.data[i]), ct.scale) for i in range(2)],
            jrk=JaxKsk(data=J(rk.data), mont=True))
    return out


# ---------------------------------------------------------------------------
# Draws: numpy-seeded on the port's side, queued for the JAX samplers
# ---------------------------------------------------------------------------

class Draws:
    """The port's samplers patched to keep their shape, dtype and device
    but return numpy-seeded values (logged per kind, in call order); the
    JAX samplers patched to pop the same values from per-kind queues in
    the order the JAX functions draw them."""

    def __init__(self, monkeypatch, seed):
        self.rng = np.random.default_rng(seed)
        self.log = {k: [] for k in KINDS}
        self.queue = {k: [] for k in KINDS}
        for kind in KINDS:
            monkeypatch.setattr(sampling, kind, self._port(kind, getattr(sampling, kind)))
            monkeypatch.setattr(jsampling, kind, self._jax(kind))

    def _values(self, kind, like, args):
        rng, shape = self.rng, tuple(like.shape)
        if kind == "ternary":
            return rng.integers(-1, 2, shape, dtype=np.int32)
        if kind == "discrete_gaussian":
            return np.rint(rng.normal(0.0, sampling.SIGMA, shape)).astype(np.int32)
        if kind == "uniform_signed":
            bound = 1 << args[1]
            return rng.integers(-bound, bound + 1, shape, dtype=np.int64)
        return np.stack([rng.integers(0, int(q), shape[:-2] + shape[-1:], dtype=np.int64)
                         for q in args[0]], axis=-2)

    def _port(self, kind, real):
        def draw(gen, *args, **kwargs):
            like = real(gen, *args, **kwargs)
            v = self._values(kind, like, args)
            self.log[kind].append(v)
            return torch.from_numpy(v).to(like.device)
        return draw

    def _jax(self, kind):
        dtype = {"ternary": jnp.int32, "discrete_gaussian": jnp.int32, "uniform_signed": jnp.int64}
        def draw(*args, **kwargs):
            v = self.queue[kind].pop(0)
            return jnp.asarray(v.view(np.uint64)) if kind == "uniform_rns" else \
                jnp.asarray(v, dtype[kind])
        return draw

    def feed_jax(self):
        """The port's logged draws as the JAX samplers' queues: one row per
        JAX call, per entry (or digit) in order; a pk encryption's Gaussian
        (2, M, N) interleaves e0 and e1 of each entry, as the JAX function
        draws them."""
        for kind, arrays in self.log.items():
            for v in arrays:
                if kind == "discrete_gaussian" and v.ndim == 3:
                    v = v.transpose(1, 0, 2)
                rows = v.reshape((-1,) + v.shape[-2:]) if kind == "uniform_rns" else \
                    v.reshape(-1, v.shape[-1])
                self.queue[kind] += list(rows)
            arrays.clear()

    def calls(self) -> dict:
        return {k: len(v) for k, v in self.log.items() if v}


def _np(x):
    """Residues of a port result (tensor, ciphertext, key or tuple) or a
    JAX one, as one list of numpy arrays."""
    if isinstance(x, (tuple, list)):
        return [a for o in x for a in _np(o)]
    if isinstance(x, torch.Tensor):
        return [convert.residues_np(x)]
    if hasattr(x, "s_eval"):
        return _np(x.s_eval)
    if hasattr(x, "data"):
        return _np(x.data)
    return [np.asarray(x)]


def _tensors(x) -> list:
    """The tensors of a port result (tensor, ciphertext, key or tuple)."""
    if isinstance(x, (tuple, list)):
        return [t for o in x for t in _tensors(o)]
    return [x if isinstance(x, torch.Tensor) else x.data]


def _stack(jax_results):
    """Per-entry JAX results → the batch's residues."""
    per = [_np(r) for r in jax_results]
    return [np.stack(parts) for parts in zip(*per)]


def _q(w, name):
    """A secret's eval stack over the Q limbs: the keyed target of a KSK."""
    return w[name].s_eval[: w["sch"].params.num_q]


KEY = jax.random.PRNGKey(0)
# each randomized operation: (the port's call, the JAX calls on the same
# draws, the draws of each kind the port makes)
OPS = {
    "keygen": (lambda w: w["sch"].keygen(torch.Generator().manual_seed(1)),
               lambda w: _np(jrlwe.keygen(w["js"].ctx, KEY))),
    "encrypt": (lambda w: w["sch"].encrypt(w["pk"], w["pt"], torch.Generator()),
                lambda w: _stack([jrlwe.encrypt(w["js"].ctx, w["jpk"], p, KEY)
                                  for p in w["jpts"]])),
    "encrypt_sk": (lambda w: rlwe.encrypt_sk(w["sch"].ctx, w["sk"], w["pt"], torch.Generator(),
                                             [SEED_A, SEED_A[::-1]]),
                   lambda w: _stack([jrlwe.encrypt_sk(w["js"].ctx, w["jsk"], p, KEY, sd)
                                     for p, sd in zip(w["jpts"], [SEED_A, SEED_A[::-1]])])),
    "encrypt_zero": (lambda w: rlwe.encrypt_zero(w["sch"].ctx, w["pk"], 2, torch.Generator(),
                                                 30, lead=(2,), device="cpu"),
                     lambda w: _stack([jrlwe.encrypt_zero(w["js"].ctx, w["jpk"], 2, KEY, 30)
                                       for _ in range(2)])),
    "re_encrypt_indcca": (lambda w: w["sch"].re_encrypt(w["ct"], w["rk"], w["pk2"],
                                                        torch.Generator()),
                          lambda w: _stack([w["js"].re_encrypt(c, w["jrk"], w["jpk2"], KEY)
                                            for c in w["jcts"]])),
    "keyswitch_key_gen_pk": (
        lambda w: ev.keyswitch_key_gen(w["sch"].ctx, _q(w, "sk"), torch.Generator(),
                                       pk_to=w["pk2"]),
        lambda w: _np(jev.keyswitch_key_gen(w["js"].ctx, w["jsk"].s_eval[:3], KEY,
                                            pk_to=w["jpk2"]))),
    "keyswitch_key_gen_sk": (
        lambda w: ev.keyswitch_key_gen(w["sch"].ctx, _q(w, "sk2"), torch.Generator(),
                                       sk_to=w["sk"]),
        lambda w: _np(jev.keyswitch_key_gen(
            w["js"].ctx, jnp.asarray(convert.residues_np(_q(w, "sk2"))), KEY,
            sk_to=w["jsk"]))),
    "keyswitch_key_gen_seeded": (
        lambda w: ev.keyswitch_key_gen(w["sch"].ctx, _q(w, "sk2"), torch.Generator(),
                                       sk_to=w["sk"], a_seed=SEED_A),
        lambda w: _np(jev.keyswitch_key_gen(
            w["js"].ctx, jnp.asarray(convert.residues_np(_q(w, "sk2"))), KEY,
            sk_to=w["jsk"], a_seed=SEED_A))),
    "relin_key_gen": (lambda w: w["sch"].relin_key_gen(w["sk"], torch.Generator()),
                      lambda w: _np(w["js"].relin_key_gen(w["jsk"], KEY))),
    "rotation_key_gen": (lambda w: list(w["sch"].rotation_key_gen(w["sk"], [1, 3],
                                                                   torch.Generator()).values()),
                         lambda w: _np(list(w["js"].rotation_key_gen(w["jsk"], [1, 3],
                                                                     KEY).values()))),
    "conjugation_key_gen": (lambda w: w["sch"].conjugation_key_gen(w["sk"], torch.Generator()),
                            lambda w: _np(w["js"].conjugation_key_gen(w["jsk"], KEY))),
    "rekey_gen": (lambda w: w["sch"].rekey_gen(w["sk"], w["pk2"], torch.Generator()),
                  lambda w: _np(w["js"].rekey_gen(w["jsk"], w["jpk2"], KEY))),
}


# the operations whose JAX side is a method of the JAX scheme
SCHEME_OPS = ("re_encrypt_indcca", "relin_key_gen", "rotation_key_gen", "conjugation_key_gen",
              "rekey_gen")


@pytest.mark.parametrize("op", list(OPS))
@pytest.mark.parametrize("config", list(CONFIGS))
def test_randomized_op_bit_equal_to_jax_on_the_same_draws(worlds, monkeypatch, config, op):
    """The port's operation on numpy-seeded draws equals the JAX function
    (called directly, a JAX scheme method under ``jax.disable_jit``) fed
    the same draws, residue for residue; every queued draw is consumed."""
    w = worlds[config]
    port, jax_fn = OPS[op]
    draws = Draws(monkeypatch, seed=len(op))
    got = _np(port(w))
    assert all(len(v) == 1 for v in draws.log.values() if v) or op == "rotation_key_gen"
    draws.feed_jax()
    # the JAX scheme's methods jit their bodies, which would bake the
    # queued draws into a cached program: run them unjitted
    with jax.disable_jit() if op in SCHEME_OPS else contextlib.nullcontext():
        want = jax_fn(w)
    assert not any(draws.queue.values()), {k: len(v) for k, v in draws.queue.items()}
    assert len(got) == len(want)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x)


# ---------------------------------------------------------------------------
# One sampler call of each kind, whatever the batch
# ---------------------------------------------------------------------------

def _batch_ops(w, B):
    """Each randomized operation at batch ``B`` (the key generators have no
    batch: their draws are per digit)."""
    sch, ctx = w["sch"], w["sch"].ctx
    gen = torch.Generator().manual_seed(B)
    pt = sch.make_plaintext([w["vs"][i % 2] for i in range(B)])
    ct = Ciphertext(w["ct"].data[torch.arange(B) % 2], w["ct"].scale)
    seeds = [bytes([i % 256]) * 16 for i in range(B)]
    sigma = th.shamir_share_secret(ctx, w["sk"], 3, 2, gen)[0]
    return {
        "encrypt": lambda: sch.encrypt(w["pk"], pt, gen),
        "encrypt_sk": lambda: rlwe.encrypt_sk(ctx, w["sk"], pt, gen, seeds),
        "encrypt_zero": lambda: rlwe.encrypt_zero(ctx, w["pk"], 3, gen, 30, (B,), "cpu"),
        "re_encrypt_indcca": lambda: sch.re_encrypt(ct, w["rk"], w["pk2"], gen),
        "partial_decrypt": lambda: th.partial_decrypt(ctx, w["sk"], ct, gen),
        "partial_decrypt_t": lambda: th.partial_decrypt_t(ctx, sigma, ct, (1, 2), 1, gen),
        "keygen": lambda: sch.keygen(gen),
        "rekey_gen": lambda: sch.rekey_gen(w["sk"], w["pk2"], gen),
        "relin_key_gen": lambda: sch.relin_key_gen(w["sk"], gen),
        "conjugation_key_gen": lambda: sch.conjugation_key_gen(w["sk"], gen),
        "partial_keygen": lambda: th.partial_keygen(ctx, w["pk"].data[1], gen),
        "shamir_share_secret": lambda: th.shamir_share_secret(ctx, w["sk"], 5, 4, gen),
    }


# the sampler calls of each operation, by kind
CALLS = {
    "encrypt": {"ternary": 1, "discrete_gaussian": 1},
    "encrypt_sk": {"discrete_gaussian": 1},
    "encrypt_zero": {"ternary": 1, "discrete_gaussian": 1, "uniform_signed": 1},
    "re_encrypt_indcca": {"ternary": 1, "discrete_gaussian": 1, "uniform_signed": 1},
    "partial_decrypt": {"uniform_signed": 1},
    "partial_decrypt_t": {"uniform_signed": 1},
    "keygen": {"ternary": 1, "uniform_rns": 1, "discrete_gaussian": 1},
    "rekey_gen": {"ternary": 1, "discrete_gaussian": 1},
    "relin_key_gen": {"uniform_rns": 1, "discrete_gaussian": 1},
    "conjugation_key_gen": {"uniform_rns": 1, "discrete_gaussian": 1},
    "partial_keygen": {"ternary": 1, "discrete_gaussian": 1},
    "shamir_share_secret": {"uniform_rns": 1},
}


@pytest.mark.parametrize("batch", [1, 27])
def test_one_sampler_call_per_kind(worlds, monkeypatch, batch):
    """With the samplers patched to count, every randomized operation calls
    each sampler kind once, at B = 1 and B = 27 alike."""
    ops = _batch_ops(worlds[MXU], batch)
    draws = Draws(monkeypatch, seed=batch)
    for name, fn in ops.items():
        fn()
        assert draws.calls() == CALLS[name], (name, draws.calls())
        for v in draws.log.values():
            v.clear()


# ---------------------------------------------------------------------------
# No host sync in a warm body
# ---------------------------------------------------------------------------

def _bodies(w):
    """Each randomized body on draws made beforehand (the seeded masks
    expanded on the host beforehand too)."""
    sch, ctx = w["sch"], w["sch"].ctx
    gen = torch.Generator().manual_seed(5)
    L, dev = sch.params.num_q, torch.device("cpu")
    kd = rlwe.keygen_draws(ctx, gen, dev)
    ed = rlwe.encrypt_draws(ctx, gen, (2,), dev)
    zd = rlwe.zero_draws(ctx, gen, (2,), dev, sch.params.pre_flood_bits)
    a_sk = rlwe.expand_a_batch(ctx, [SEED_A, SEED_A], L, dev)
    e_sk = sampling.discrete_gaussian(gen, (2, N), device=dev)
    pk_d = ev.ksk_draws(ctx, gen, dev, pk_path=True)
    sk_d = ev.ksk_draws(ctx, gen, dev, pk_path=False)
    seeded = ev.ksk_draws(ctx, gen, dev, pk_path=False, a_seed=SEED_A)
    target = w["sk2"].s_eval[:L]
    return {
        "keygen": lambda: rlwe.keygen_body(ctx, *kd),
        "encrypt": lambda: rlwe.encrypt_body(ctx, w["pk"], w["pt"], *ed),
        "encrypt_sk": lambda: rlwe.encrypt_sk_body(ctx, w["sk"].s_eval, w["pt"], a_sk, e_sk),
        "encrypt_zero": lambda: rlwe.encrypt_zero_body(ctx, w["pk"], L, *zd),
        "re_encrypt_indcca": lambda: ev.re_encrypt_indcca(ctx, w["ct"], w["rk"], w["pk2"], *zd),
        "ksk pk": lambda: ev.ksk_body(ctx, target, w["pk2"].data, True, *pk_d),
        "ksk sk": lambda: ev.ksk_body(ctx, target, w["sk"].s_eval, False, *sk_d),
        "ksk seeded": lambda: ev.ksk_body(ctx, target, w["sk"].s_eval, False, *seeded),
    }


@pytest.mark.parametrize("config", list(CONFIGS))
def test_randomized_bodies_have_no_host_sync_once_warm(worlds, monkeypatch, config):
    """After one warm-up call each, every randomized body runs with every
    host sync patched to raise and gives the warm-up's residues (keygen's
    host copy of the secret is outside its body)."""
    calls = _bodies(worlds[config])
    warm = {k: _tensors(f()) for k, f in calls.items()}
    for owner, name in HOST_SYNCS:
        monkeypatch.setattr(owner, name, _refuse(name))
    steady = {k: _tensors(f()) for k, f in calls.items()}
    monkeypatch.undo()
    for k in calls:
        assert all(torch.equal(a, b) for a, b in zip(warm[k], steady[k])), k
