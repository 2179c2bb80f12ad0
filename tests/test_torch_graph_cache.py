"""The scheme's per-op graph cache (``CkksScheme._graph``, the counterpart of
the JAX scheme's ``_jit``) on the CPU, where no CUDA graph is captured:

- every cached operation (add, sub, add_plain, mult_plain, mult_scalar,
  mult, rescale, rotate, conjugate, INDCPA re_encrypt, decrypt) on a CPU
  scheme at N=2^10 gives the JAX ``CkksScheme``'s result bit for bit on the
  same inputs (numpy-seeded values, keys made by the port, carried over by
  ``convert``), in both four-step implementations and on the radix-2 order;
- no cached operation's body, and neither the rotation bench's units nor
  the multikey round, makes a host sync once warm (the patch of
  ``tests/test_torch_compiled.py``);
- the cache's bookkeeping, with stand-ins for the capture and the card
  (``scheme._on_card``, ``graphs.Graph``, ``graphs.warm_up``): its keys,
  the WARMUP eager calls, one capture per key, inputs copied into static
  buffers (so keys of one shape share a graph), results cloned, the bypass
  inside ``graphs.eager()`` and during a capture, none on a context that
  runs collectives, and a failed capture raising with no eager fallback;
- the randomized operations' bookkeeping: the seven JAX keys (one per
  Galois element), the seeded keygen never cached, the WARMUP eager calls
  then one capture, draws and keys copied in (two public keys of one shape
  share a graph), every result the eager body on the same draws, cloned,
  and their static buffers (``decrypt_core``'s too) zeroed after a call.

The capture and replay on the card, bit-equal to the eager operations, are
``chip_smoke.py``'s phases 16 and 17."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppqsflhe_tpu.ckks.params import CkksParams as JaxParams
from ppqsflhe_tpu.ckks.scheme import CkksScheme as JaxScheme
from ppqsflhe_tpu.ckks.types import Ciphertext as JaxCt
from ppqsflhe_tpu.ckks.types import KeySwitchKey as JaxKsk
from ppqsflhe_tpu.ckks.types import Plaintext as JaxPt
from ppqsflhe_tpu.ckks.types import SecretKey as JaxSk
from ppqsflhe_tpu_torch import convert
from ppqsflhe_tpu_torch.bench import multikey as mk
from ppqsflhe_tpu_torch.bench import rotations
from ppqsflhe_tpu_torch.ckks import eval as ev
from ppqsflhe_tpu_torch.ckks import rlwe
from ppqsflhe_tpu_torch.ckks import scheme as scheme_mod
from ppqsflhe_tpu_torch.ckks.params import CkksContext, CkksParams
from ppqsflhe_tpu_torch.ckks.scheme import CkksScheme
from ppqsflhe_tpu_torch.ckks.types import Ciphertext
from ppqsflhe_tpu_torch.ops.cuda_ntt import BUTTERFLY, MXU
from ppqsflhe_tpu_torch.utils import graphs
from test_torch_compiled import HOST_SYNCS, _refuse

N = 1 << 10
CONFIGS = {MXU: ("fourstep", MXU), BUTTERFLY: ("fourstep", BUTTERFLY),
           "radix2": ("radix2", "xla")}
# the JAX scheme for each order: every four-step implementation gives the
# same evaluations, so one JAX scheme ("mxu", the quickest to compile)
# serves both of the port's
JAX_IMPL = {"fourstep": "mxu", "radix2": "xla"}
C_SCALAR = 0.37


def _make(backend: str, impl: str):
    """A port scheme on the CPU with keys, two ciphertexts of numpy-seeded
    values and a plaintext."""
    sch = CkksScheme(CkksParams.generate(n=N, mult_depth=2, scale_bits=40, dnum=2,
                                         ntt_backend=backend, ntt_impl=impl), device="cpu")
    gen = torch.Generator().manual_seed(11)
    sk, pk = sch.keygen(gen)
    _, pk2 = sch.keygen(gen)
    rng = np.random.default_rng(12)
    vs = [rng.uniform(-1, 1, sch.encoder.slots) * 0.5 for _ in range(3)]
    return dict(
        sch=sch, sk=sk, pk=pk, vs=vs, ct1=sch.encrypt_values(pk, vs[0], gen),
        ct2=sch.encrypt_values(pk, vs[1], gen), pt=sch.make_plaintext(vs[2]),
        relin=sch.relin_key_gen(sk, gen), rot=sch.rotation_key_gen(sk, [1], gen),
        conj=sch.conjugation_key_gen(sk, gen),
        rekey=ev.ksk_to_mont(sch.ctx, sch.rekey_gen(sk, pk2, gen)))


@pytest.fixture(scope="module")
def worlds():
    out = {}
    for name, (backend, impl) in CONFIGS.items():
        w = _make(backend, impl)
        # the four-step implementations share their inputs: the residues
        # are the same in either
        if backend == "fourstep" and "fourstep" in out:
            src = out["fourstep"]
            w.update({k: src[k] for k in ("sk", "pk", "ct1", "ct2", "pt", "relin", "rot",
                                          "conj", "rekey", "vs")})
        out.setdefault(backend, w)
        out[name] = w
    return out


def _jct(ct):
    return JaxCt(jnp.asarray(convert.residues_np(ct.data)), ct.scale)


def _jksk(k):
    return JaxKsk(data=jnp.asarray(convert.residues_np(k.data)), mont=k.mont)


# each cached operation on the port's scheme and on the JAX scheme, by name
OPS = {
    "add": (lambda s, w: s.add(w["ct1"], w["ct2"]), lambda j, w: j.add(w["jct1"], w["jct2"])),
    "sub": (lambda s, w: s.sub(w["ct1"], w["ct2"]), lambda j, w: j.sub(w["jct1"], w["jct2"])),
    "add_plain": (lambda s, w: s.add_plain(w["ct1"], w["pt"]),
                  lambda j, w: j.add_plain(w["jct1"], w["jpt"])),
    "mult_plain": (lambda s, w: s.mult_plain(w["ct1"], w["pt"]),
                   lambda j, w: j.mult_plain(w["jct1"], w["jpt"])),
    "mult_plain_no_rescale": (lambda s, w: s.mult_plain(w["ct1"], w["pt"], False),
                              lambda j, w: j.mult_plain(w["jct1"], w["jpt"], False)),
    "mult_scalar": (lambda s, w: s.mult_scalar(w["ct1"], C_SCALAR),
                    lambda j, w: j.mult_scalar(w["jct1"], C_SCALAR)),
    "mult_scalar_no_rescale": (lambda s, w: s.mult_scalar(w["ct1"], -0.5, False),
                               lambda j, w: j.mult_scalar(w["jct1"], -0.5, False)),
    "mult": (lambda s, w: s.mult(w["ct1"], w["ct2"], w["relin"]),
             lambda j, w: j.mult(w["jct1"], w["jct2"], w["jrelin"])),
    "rescale": (lambda s, w: s.rescale(w["ct1"]), lambda j, w: j.rescale(w["jct1"])),
    "rotate": (lambda s, w: s.rotate(w["ct1"], 1, w["rot"]),
               lambda j, w: j.rotate(w["jct1"], 1, w["jrot"])),
    "conjugate": (lambda s, w: s.conjugate(w["ct1"], w["conj"]),
                  lambda j, w: j.conjugate(w["jct1"], w["jconj"])),
    "re_encrypt": (lambda s, w: s.re_encrypt(w["ct1"], w["rekey"]),
                   lambda j, w: j.re_encrypt(w["jct1"], w["jrekey"])),
}


@pytest.fixture(scope="module")
def jax_results(worlds):
    """The JAX scheme's result of each operation on each order, computed
    once (lazily) from the port's inputs."""
    cache = {}

    def get(backend, op):
        if (backend, "scheme") not in cache:
            w = worlds[backend]
            jp = JaxParams(**{**dataclasses.asdict(w["sch"].params),
                              "ntt_impl": JAX_IMPL[backend]})
            js = JaxScheme(jp)
            jw = dict(jct1=_jct(w["ct1"]), jct2=_jct(w["ct2"]),
                      jpt=JaxPt(jnp.asarray(convert.residues_np(w["pt"].data)), w["pt"].scale),
                      jrelin=_jksk(w["relin"]), jrot={1: _jksk(w["rot"][1])},
                      jconj=_jksk(w["conj"]), jrekey=_jksk(w["rekey"]),
                      jsk=JaxSk(s_eval=jnp.asarray(convert.residues_np(w["sk"].s_eval)),
                                s_int=w["sk"].s_int))
            cache[(backend, "scheme")] = (js, jw)
        js, jw = cache[(backend, "scheme")]
        if (backend, op) not in cache:
            if op == "decrypt":
                cache[(backend, op)] = js.decrypt(jw["jsk"], jw["jct1"])
            else:
                r = OPS[op][1](js, jw)
                cache[(backend, op)] = (np.asarray(r.data), r.scale)
        return cache[(backend, op)]
    return get


@pytest.mark.parametrize("op", list(OPS))
@pytest.mark.parametrize("config", list(CONFIGS))
def test_cached_op_bit_equal_to_jax(worlds, jax_results, config, op):
    """The scheme's operation (on the CPU: the eager body the cache would
    capture) gives the JAX scheme's residues and scale."""
    w = worlds[config]
    got = OPS[op][0](w["sch"], w)
    want, scale = jax_results(CONFIGS[config][0], op)
    np.testing.assert_array_equal(convert.residues_np(got.data), want)
    assert got.scale == scale


@pytest.mark.parametrize("config", list(CONFIGS))
def test_cached_decrypt_bit_equal_to_jax(worlds, jax_results, config):
    """``decrypt`` (the cached ``decrypt_core``, then the host decode) gives
    the JAX scheme's slot values bit for bit, and the payload within 1e-6."""
    w = worlds[config]
    got = w["sch"].decrypt(w["sk"], w["ct1"])
    want = jax_results(CONFIGS[config][0], "decrypt")
    np.testing.assert_array_equal(got, np.asarray(want))
    assert np.abs(got - w["vs"][0]).max() < 1e-6


def _cached_calls(w):
    """Each cached operation's body as the cache would run it."""
    sch = w["sch"]
    calls = {name: (lambda f=f: f(sch, w)) for name, (f, _) in OPS.items()}
    calls["decrypt_core"] = lambda: rlwe.decrypt_to_coeffs(sch.ctx, w["sk"].s_eval, w["ct1"])
    return calls


def _outs(r):
    return [r] if isinstance(r, torch.Tensor) else [t.data for t in r] \
        if isinstance(r, list) else [r.data]


@pytest.mark.parametrize("config", list(CONFIGS))
def test_cached_ops_have_no_host_sync_once_warm(worlds, monkeypatch, config):
    """After one warm-up call each (the cache warms up the same way), every
    cached operation's body runs with every host sync patched to raise and
    gives the warm-up's residues."""
    calls = _cached_calls(worlds[config])
    warm = {k: _outs(f()) for k, f in calls.items()}
    for owner, name in HOST_SYNCS:
        monkeypatch.setattr(owner, name, _refuse(name))
    steady = {k: _outs(f()) for k, f in calls.items()}
    monkeypatch.undo()
    for k in calls:
        assert all(torch.equal(a, b) for a, b in zip(warm[k], steady[k])), k


def test_rotation_units_and_multikey_round_have_no_host_sync(worlds, monkeypatch):
    """The rotation bench's three units and the multikey round (both
    schedules) at N=2^10, warm, run with every host sync patched to raise."""
    w = worlds[MXU]
    sch = w["sch"]
    keys = {**w["rot"], **sch.rotation_key_gen(w["sk"], [2, 4], torch.Generator().manual_seed(3))}
    keys = {r: ev.ksk_to_mont(sch.ctx, k) for r, k in keys.items()}
    units = rotations.units(sch, w["ct1"], keys, [1, 2, 4])
    rng = np.random.default_rng(5)
    vecs = [[rng.uniform(-1, 1, 64), rng.uniform(-1, 1, 3)] for _ in range(4)]
    mw = mk.prep(sch, vecs, torch.Generator().manual_seed(6))
    staged = {lazy: mk.stage(mw.stacks, mk.inbound_level(sch, lazy)) for lazy in (4, 0)}
    runs = {**{f"rotations {k}": f for k, f in units.items()},
            **{f"multikey lazy={lazy}": (lambda lazy=lazy: list(mk.server_round(
                sch, staged[lazy], mw.rk_to, mw.rk_from, lazy))) for lazy in (4, 0)}}
    warm = {k: _outs(f()) for k, f in runs.items()}
    for owner, name in HOST_SYNCS:
        monkeypatch.setattr(owner, name, _refuse(name))
    steady = {k: _outs(f()) for k, f in runs.items()}
    monkeypatch.undo()
    for k in runs:
        assert all(torch.equal(a, b) for a, b in zip(warm[k], steady[k])), k


def test_compiled_units_refuse_cpu(worlds):
    """The rotation bench's compiled unit and the compiled multikey round
    refuse a CPU scheme: there is no eager path behind them."""
    w = worlds[MXU]
    with pytest.raises(RuntimeError, match="CUDA graph"):
        rotations.CompiledUnit(w["sch"], "hoisted", w["ct1"], w["rot"], [1])
    with pytest.raises(RuntimeError, match="CUDA graph"):
        mk.CompiledMultikeyRound(w["sch"], [w["rekey"]], [w["rekey"]], 4,
                                 (2,) + tuple(w["ct1"].data.shape), w["ct1"].scale)


# ---------------------------------------------------------------------------
# The cache's bookkeeping with stand-ins for the card and the capture
# ---------------------------------------------------------------------------

class StandInGraph:
    """A capture that records the function and "replays" it eagerly into
    the static outputs, as a CUDA graph writes its static buffers."""

    captures = []

    def __init__(self, fn, what, generator=None):
        self.fn, self.what = fn, what
        with graphs.eager():
            self.output = fn()
        StandInGraph.captures.append(what)

    def replay(self):
        with graphs.eager():
            fresh = self.fn()
        for dst, src in zip(graphs._tensors(self.output), graphs._tensors(fresh)):
            dst.copy_(src)
        return self.output


@pytest.fixture
def stand_in(monkeypatch):
    """The scheme believes its tensors are on the card; captures and
    warm-ups are the stand-ins. Returns the warm-up log."""
    warmed = []

    def warm_up(fn, device, n=1):
        with graphs.eager():
            for _ in range(n):
                out = fn()
        warmed.append(str(device))
        return out

    StandInGraph.captures = []
    monkeypatch.setattr(scheme_mod, "_on_card", lambda t: True)
    monkeypatch.setattr(graphs, "Graph", StandInGraph)
    monkeypatch.setattr(graphs, "warm_up", warm_up)
    return warmed


def _fresh_cts(sch, k, gen, nlimbs=None):
    """``k`` ciphertexts of uniform residues (fresh inputs)."""
    L = nlimbs or sch.params.num_q
    out = []
    for _ in range(k):
        d = torch.stack([torch.randint(0, q, (2, sch.params.n), generator=gen)
                         for q in sch.ctx.moduli_qp[:L]], dim=1)
        out.append(Ciphertext(d, sch.params.scale))
    return out


def test_warmup_capture_replay_and_clones(worlds, stand_in):
    """A key's first WARMUP calls run eagerly (warm-ups), the next captures
    once, every later call replays; each result equals the eager operation
    on its inputs and is the caller's own: a later call changes none."""
    sch = CkksScheme(worlds[MXU]["sch"].params, device="cpu")
    gen = torch.Generator().manual_seed(1)
    pairs = [tuple(_fresh_cts(sch, 2, gen)) for _ in range(scheme_mod.WARMUP + 3)]
    got = []
    for i, (a, b) in enumerate(pairs):
        got.append(sch.add(a, b))
        assert len(stand_in) == min(i + 1, scheme_mod.WARMUP)
        assert len(StandInGraph.captures) == (0 if i < scheme_mod.WARMUP else 1)
    assert len(sch._graphs) == 1
    op = next(iter(sch._graphs.values()))
    assert "add" in op.what and "add" in StandInGraph.captures[0]
    for r, (a, b) in zip(got, pairs):
        want = ev.add(sch.ctx, a, b)
        assert torch.equal(r.data, want.data) and r.scale == want.scale
        assert r.data.data_ptr() != op.graph.output.data.data_ptr()
    # an input that is the static buffer is used in place
    again = sch.add(Ciphertext(op.static[0], sch.params.scale), pairs[0][1])
    assert torch.equal(again.data, ev.add(sch.ctx, pairs[-1][0], pairs[0][1]).data)


def test_cache_keys(worlds, stand_in):
    """Distinct keys for r, rescale_after, c, shape, scale and mont; one key
    (one graph) for two different key-switch keys of one shape, each call
    switching under its own key."""
    w = worlds[MXU]
    sch = CkksScheme(w["sch"].params, device="cpu")
    gen = torch.Generator().manual_seed(2)
    ct, ct2 = _fresh_cts(sch, 2, gen)
    rots = sch.rotation_key_gen(w["sk"], [1, 2], gen)

    def keys_after(fn):
        before = set(sch._graphs)
        fn()
        return set(sch._graphs) - before

    k_r1 = keys_after(lambda: sch.rotate(ct, 1, rots))
    k_r2 = keys_after(lambda: sch.rotate(ct, 2, rots))
    assert len(k_r1) == len(k_r2) == 1 and k_r1 != k_r2
    assert len(keys_after(lambda: sch.mult_plain(ct, w["pt"], True))) == 1
    assert len(keys_after(lambda: sch.mult_plain(ct, w["pt"], False))) == 1
    assert len(keys_after(lambda: sch.mult_scalar(ct, 0.5))) == 1
    assert len(keys_after(lambda: sch.mult_scalar(ct, 0.25))) == 1
    assert len(keys_after(lambda: sch.mult_scalar(ct, 0.25, False))) == 1
    # shape: one limb fewer; scale: another scale; mont: the same key in
    # Montgomery form
    assert len(keys_after(lambda: sch.rotate(Ciphertext(ct.data[:, :2], ct.scale), 1,
                                             rots))) == 1
    assert len(keys_after(lambda: sch.rotate(Ciphertext(ct.data, 2.0 * ct.scale), 1,
                                             rots))) == 1
    mont = ev.ksk_to_mont(sch.ctx, rots[1])
    assert len(keys_after(lambda: sch.rotate(ct, 1, mont))) == 1
    # two rekeys of one shape share one key: past the warm-up each call
    # copies its own key in
    rk_a, rk_b = w["rekey"], ev.ksk_to_mont(sch.ctx, sch.rekey_gen(
        w["sk"], sch.keygen(gen)[1], gen))
    assert not torch.equal(rk_a.data, rk_b.data)
    for i in range(scheme_mod.WARMUP + 3):
        rk = (rk_a, rk_b)[i % 2]
        got = sch.re_encrypt(ct2, rk)
        assert torch.equal(got.data, ev.re_encrypt(sch.ctx, ct2, rk).data)
    re_keys = [k for k in sch._graphs if k[0] == "re_encrypt"]
    assert len(re_keys) == 1 and sch._graphs[re_keys[0]].graph is not None
    assert re_keys[0][2] == ("KeySwitchKey", tuple(rk_a.data.shape), torch.int64, "cpu", True)
    assert re_keys[0][1][-1] == ct2.scale


def test_bypass_inside_eager_and_capture_and_on_collective_contexts(worlds, stand_in,
                                                                     monkeypatch):
    """No entry is made inside ``graphs.eager()`` (every whole-program
    warm-up), while the current stream captures, on a context whose
    ``per_op_graphs`` is off, or for a tensor not on the card."""
    w = worlds[MXU]
    sch = CkksScheme(w["sch"].params, device="cpu")
    a, b = _fresh_cts(sch, 2, torch.Generator().manual_seed(3))
    with graphs.eager():
        for _ in range(scheme_mod.WARMUP + 2):
            assert torch.equal(sch.add(a, b).data, ev.add(sch.ctx, a, b).data)
    assert not sch._graphs and not stand_in
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        m.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
        assert graphs.bypass()
        sch.add(a, b)
    assert not sch._graphs
    sch.ctx.per_op_graphs = False
    sch.add(a, b)
    assert not sch._graphs
    sch.ctx.per_op_graphs = True
    monkeypatch.setattr(scheme_mod, "_on_card", lambda t: False)
    sch.add(a, b)
    assert not sch._graphs and not graphs.bypass()


def test_failed_capture_raises_naming_the_op(worlds, monkeypatch):
    """With the real capture on a CPU build (no CUDA graphs here), the call
    that captures raises ``RuntimeError`` naming the operation and its key;
    it never falls back to the eager body."""
    sch = CkksScheme(worlds[MXU]["sch"].params, device="cpu")
    a, b = _fresh_cts(sch, 2, torch.Generator().manual_seed(4))

    def warm_up(fn, device, n=1):
        with graphs.eager():
            return fn()

    monkeypatch.setattr(scheme_mod, "_on_card", lambda t: True)
    monkeypatch.setattr(graphs, "warm_up", warm_up)
    for _ in range(scheme_mod.WARMUP):
        sch.sub(a, b)
    with pytest.raises(RuntimeError, match=r"capture of the CkksScheme operation \('sub'"):
        sch.sub(a, b)


def test_sharded_context_runs_eagerly():
    """The sharded context's transforms run collectives: the scheme never
    caches a graph on it."""
    from ppqsflhe_tpu_torch.parallel.sharded_scheme import ShardedEvalContext

    assert ShardedEvalContext.per_op_graphs is False
    assert CkksContext.per_op_graphs is True


def test_inner_product_composes_cached_ops(worlds, stand_in):
    """``inner_product`` runs through the cached mult, rotate and add (one
    entry per rotation), as the JAX scheme composes its jitted ops."""
    w = worlds[MXU]
    sch = CkksScheme(w["sch"].params, device="cpu")
    gen = torch.Generator().manual_seed(7)
    rots = sch.rotation_key_gen(w["sk"], [1 << i for i in range(9)], gen)
    rng = np.random.default_rng(7)
    u1, u2 = (rng.uniform(-1, 1, sch.encoder.slots) * 0.1 for _ in range(2))
    c1, c2 = (sch.encrypt_values(w["pk"], u, gen) for u in (u1, u2))
    keys_made = set(sch._graphs)            # the key generators' and encrypt's
    ip = sch.inner_product(c1, c2, w["relin"], rots)
    assert abs(sch.decrypt(w["sk"], ip)[:4] - np.dot(u1, u2)).max() < 1e-3
    new = set(sch._graphs) - keys_made
    ops = sorted({k[0] if isinstance(k[0], str) else k[0][0] for k in new})
    assert ops == ["add", "decrypt_core", "mult", "rotate"]
    assert len([k for k in new if k[0][0] == "rotate"]) == 9


# ---------------------------------------------------------------------------
# The randomized operations: draws outside the cache, bodies through it
# ---------------------------------------------------------------------------

def _indcca_scheme(w):
    return CkksScheme(dataclasses.replace(w["sch"].params, pre_mode="INDCCA"), device="cpu")


def _twin(gen: torch.Generator) -> torch.Generator:
    """A generator in ``gen``'s state: it makes the draws ``gen`` is about
    to make."""
    return torch.Generator(gen.device).set_state(gen.get_state())


def test_randomized_cache_keys(worlds, stand_in):
    """keygen, relin_key_gen, rot_key_gen (one key per Galois element),
    conj_key_gen, rekey_gen, encrypt and INDCCA re_encrypt each cache under
    the JAX scheme's key; the seeded keygen is never cached, as the JAX
    scheme leaves it unjitted."""
    w = worlds[MXU]
    sch = _indcca_scheme(w)
    gen = torch.Generator().manual_seed(8)
    sk, pk = sch.keygen(gen)
    sch.relin_key_gen(sk, gen)
    sch.rotation_key_gen(sk, [1, 2], gen)
    sch.conjugation_key_gen(sk, gen)
    rk = ev.ksk_to_mont(sch.ctx, sch.rekey_gen(sk, w["pk"], gen))
    ct = sch.encrypt(pk, w["pt"], gen)
    sch.re_encrypt(ct, rk, w["pk"], gen)
    g1, g2 = (ev.rot_to_galois(r, N) for r in (1, 2))
    assert {k[0] for k in sch._graphs} == {
        "keygen", "relin_key_gen", ("rot_key_gen", g1), ("rot_key_gen", g2), "conj_key_gen",
        "rekey_gen", "encrypt", ("re_encrypt", "INDCCA")}
    before = set(sch._graphs)
    for _ in range(scheme_mod.WARMUP + 2):
        sk_s, pk_s = sch.keygen(gen, a_seed=bytes(16))
    assert set(sch._graphs) == before
    assert torch.equal(pk_s.data[1], rlwe.expand_a(sch.ctx, bytes(16), len(sch.ctx.moduli_qp),
                                                   "cpu"))


def test_randomized_warmup_capture_copies_draws_and_keys(worlds, stand_in):
    """encrypt under two public keys of one shape, alternately: WARMUP
    eager calls, then one capture, then replays, one graph for both keys;
    each result is the eager body on the same draws (a twin generator
    makes them again) under its own key, and stays so after later calls.
    INDCCA re_encrypt and keygen (a tuple of results) the same way."""
    w = worlds[MXU]
    sch = _indcca_scheme(w)
    ctx = sch.ctx
    gen = torch.Generator().manual_seed(9)
    pks = [w["pk"], sch.keygen(gen)[1]]
    stand_in.clear()
    StandInGraph.captures = []
    calls = scheme_mod.WARMUP + 3
    kept = []
    for i in range(calls):
        pk = pks[i % 2]
        draws = rlwe.encrypt_draws(ctx, _twin(gen), w["pt"].data.shape[:-2], "cpu")
        kept.append((sch.encrypt(pk, w["pt"], gen), rlwe.encrypt_body(ctx, pk, w["pt"], *draws)))
        assert len(stand_in) == min(i + 1, scheme_mod.WARMUP)
        assert len(StandInGraph.captures) == (0 if i < scheme_mod.WARMUP else 1)
    (key,) = [k for k in sch._graphs if k[0] == "encrypt"]
    op = sch._graphs[key]
    assert "encrypt" in StandInGraph.captures[0]
    for got, want in kept:
        assert torch.equal(got.data, want.data) and got.scale == want.scale
        assert got.data.data_ptr() != op.graph.output.data.data_ptr()
    assert not torch.equal(kept[0][0].data, kept[2][0].data)    # fresh draws each call

    rks = [ev.ksk_to_mont(ctx, sch.rekey_gen(w["sk"], pk, gen)) for pk in pks]
    ct = kept[0][0]
    for i in range(calls):
        rk, pk = rks[i % 2], pks[i % 2]
        draws = rlwe.zero_draws(ctx, _twin(gen), ct.data.shape[:-3], "cpu",
                                sch.params.pre_flood_bits)
        got = sch.re_encrypt(ct, rk, pk, gen)
        assert torch.equal(got.data, ev.re_encrypt_indcca(ctx, ct, rk, pk, *draws).data)
    assert sch._graphs[next(k for k in sch._graphs if k[0] == ("re_encrypt", "INDCCA"))].graph

    pairs = []
    for _ in range(calls):
        draws = rlwe.keygen_draws(ctx, _twin(gen), "cpu")
        pairs.append((sch.keygen(gen), rlwe.keygen_body(ctx, *draws), draws[0]))
    for (sk, pk), (s_eval, pk_data), s_int in pairs:
        assert torch.equal(sk.s_eval, s_eval) and torch.equal(pk.data, pk_data)
        assert np.array_equal(sk.s_int, s_int.numpy())
    op = sch._graphs[next(k for k in sch._graphs if k[0] == "keygen")]
    assert pairs[-1][0][0].s_eval.data_ptr() != op.graph.output[0].data_ptr()


def test_randomized_ops_keep_no_secret_in_the_cache(worlds, stand_in):
    """Once captured, every operation that reads a secret key, draws or a
    plaintext (the seven randomized keys and ``decrypt_core``) zeroes its
    static inputs and outputs after each call; a deterministic one
    (``add``) keeps them."""
    w = worlds[MXU]
    sch = _indcca_scheme(w)
    gen = torch.Generator().manual_seed(10)
    for _ in range(scheme_mod.WARMUP + 2):
        sk, pk = sch.keygen(gen)
        sch.relin_key_gen(sk, gen)
        sch.rotation_key_gen(sk, [1], gen)
        sch.conjugation_key_gen(sk, gen)
        rk = ev.ksk_to_mont(sch.ctx, sch.rekey_gen(sk, w["pk"], gen))
        ct = sch.encrypt(pk, w["pt"], gen)
        sch.decrypt(w["sk"], sch.re_encrypt(ct, rk, w["pk"], gen))
        sch.add(ct, ct)
    assert len(sch._graphs) == 9
    for key, op in sch._graphs.items():
        assert op.graph is not None and op.replays == 2, key
        held = [*op.static, *graphs._tensors(op.graph.output)]
        assert any(bool(t.any()) for t in held) == (key[0] == "add"), key
