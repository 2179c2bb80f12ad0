"""Multikey aggregation in the port against the JAX package at N=256 on
``generate(n=256, mult_depth=2, scale_bits=40, dnum=2)`` (radix-2, the JAX
default and its cheapest compile): ``multikey.aggregate_local`` and the
bench's ``server_round`` (``ppqsflhe_tpu_torch/bench/multikey.py``) give
the residues of the JAX composition of ``bench_multikey.py:194-234`` bit
for bit, on keys, rekeys (Montgomery form) and ciphertexts the JAX package
made. The JAX round is composed of ``ev.keyswitch`` and ``modadd``: the
bench's scans become loops, and one PRE (vmapped over the batch) is jitted
per level, since the round run op by op takes over 40 s here. C=4 (÷C free
as scale metadata) and C=3 (``mult_scalar``), B=3 ciphertexts per client,
the lazy-4 and the full-level schedules. The bench's payloads have the
LSTM export's layout: 154 ciphertexts and 1,091,101 values per client. Its
prep and check run on the CPU with the port's own keys and decrypt below
1e-3."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppqsflhe_tpu.ckks import eval as jev
from ppqsflhe_tpu.ckks import multikey as jmk
from ppqsflhe_tpu.ckks.params import CkksParams as JaxParams
from ppqsflhe_tpu.ckks.scheme import CkksScheme as JaxScheme
from ppqsflhe_tpu.ckks.types import Ciphertext as JaxCt
from ppqsflhe_tpu.ckks.types import KeySwitchKey as JaxKsk
from ppqsflhe_tpu.core.modarith import modadd as jax_modadd
from ppqsflhe_tpu_torch import convert
from ppqsflhe_tpu_torch.bench import multikey as mk
from ppqsflhe_tpu_torch.ckks import multikey
from ppqsflhe_tpu_torch.ckks.scheme import CkksScheme
from ppqsflhe_tpu_torch.ckks.types import Ciphertext

N = 256
B = 3
C_MAX = 4


_RE_ENC = {}


def _re_enc(js, d_stack, rk, l):
    """The bench's PRE of a (B, 2, l, N) stack under one rekey: a vmapped
    keyswitch plus modadd, jitted once per level."""
    if l not in _RE_ENC:
        ctx = js.ctx
        q, _, _ = ctx.limb_consts(ctx.q_idx(l))

        def one(d, k):
            d0, d1 = jev.keyswitch(ctx, d[1], JaxKsk(data=k, mont=True), l)
            return jnp.stack([jax_modadd(d[0], d0, q), d1])

        _RE_ENC[l] = jax.jit(jax.vmap(one, in_axes=(0, None)))
    return _RE_ENC[l](d_stack, rk)


def _jax_server_round(js, stacks, k_to, k_from, scale, lazy):
    """bench_multikey.py's server_round (:194-234) with its scans as loops:
    ``stacks`` (C, B, 2, l_in, N) at the inbound level, hub = client C−1."""
    C = stacks.shape[0]
    ctx = js.ctx
    re_enc = lambda d, rk, l: _re_enc(js, d, rk, l)

    l_in = stacks.shape[-2]
    q, _, _ = ctx.limb_consts(ctx.q_idx(l_in))
    acc = stacks[C - 1]
    for i in range(C - 1):
        acc = jax.vmap(lambda a, b: jax_modadd(a, b, q))(acc, re_enc(stacks[i], k_to[i], l_in))
    if lazy >= 2 and (C & (C - 1)) == 0:
        avg = acc
    else:
        avg = jax.vmap(lambda a: jev.mult_scalar(ctx, JaxCt(a, scale), 1.0 / C).data)(acc)
    if lazy >= 4 and avg.shape[-2] > 1:
        avg = avg[..., :-1, :]
    return avg, jnp.stack([re_enc(avg, rk, avg.shape[-2]) for rk in k_from])


@pytest.fixture(scope="module")
def world():
    """C_MAX clients' JAX keys, Montgomery rekeys into the hub (the last
    client) and back, and B encryptions each, crossed into the port."""
    jp = JaxParams.generate(n=N, mult_depth=2, scale_bits=40, dnum=2)
    js = JaxScheme(jp)
    ctx, L = js.ctx, jp.num_q
    k0 = jax.random.PRNGKey(99)
    keys = [js.keygen(jax.random.fold_in(k0, i)) for i in range(C_MAX)]
    rng = np.random.default_rng(4)
    vecs = [[rng.uniform(-1, 1, js.encoder.slots) for _ in range(B)] for _ in range(C_MAX)]
    stacks = np.stack([np.stack([np.asarray(js.encrypt(
        pk, js.make_plaintext(v), jax.random.fold_in(k0, 3000 + 10 * i + b)).data)
        for b, v in enumerate(vecs[i])]) for i, (_, pk) in enumerate(keys)])
    scale = js.params.scale
    sch = CkksScheme(convert.params(dataclasses.asdict(jp)), device="cpu")

    def rekeys(C):
        """(JAX Montgomery data, port keys) into and out of hub C−1."""
        hub = C - 1
        mont = lambda sk, pk, k: np.asarray(jev.ksk_to_mont(ctx, jev.keyswitch_key_gen(
            ctx, sk.s_eval[:L], jax.random.fold_in(k0, k), pk_to=pk)).data)
        to = [mont(keys[i][0], keys[hub][1], 1000 + i) for i in range(hub)]
        back = [mont(keys[hub][0], keys[i][1], 2000 + i) for i in range(hub)]
        port = lambda ks: [convert.keyswitch_key(k, mont=True, device="cpu") for k in ks]
        return to, back, port(to), port(back)

    return dict(js=js, sch=sch, keys=keys, vecs=vecs, stacks=stacks, scale=scale,
                rekeys={C: rekeys(C) for C in (3, 4)})


def test_aggregate_local_bit_equal(world):
    js, sch, stacks, scale = world["js"], world["sch"], world["stacks"], world["scale"]
    for scale_by_count in (True, False):
        got = multikey.aggregate_local(
            sch.ctx, [convert.ciphertext(s, scale, device="cpu") for s in stacks[:3]],
            scale_by_count)
        for b in range(B):
            want = jmk.aggregate_local(js.ctx, [JaxCt(jnp.asarray(s[b]), scale)
                                                for s in stacks[:3]], scale_by_count)
            assert np.array_equal(convert.residues_np(got.data[b]), np.asarray(want.data))
            assert got.scale == want.scale


@pytest.mark.parametrize("lazy", [4, 0])
@pytest.mark.parametrize("C", [4, 3])
def test_server_round_bit_equal(world, C, lazy):
    js, sch, scale = world["js"], world["sch"], world["scale"]
    j_to, j_from, p_to, p_from = world["rekeys"][C]
    l_in = mk.inbound_level(sch, lazy)
    host = world["stacks"][:C, :, :, :l_in]                # clients 0 … C−1, hub last
    j_avg, j_outs = _jax_server_round(js, jnp.asarray(host), j_to, j_from, scale, lazy)
    staged = mk.stage(convert.ciphertext(world["stacks"][:C], scale, device="cpu"), l_in)
    avg, outs = mk.server_round(sch, staged, p_to, p_from, lazy)
    assert np.array_equal(convert.residues_np(avg.data), np.asarray(j_avg))
    assert np.array_equal(convert.residues_np(outs.data), np.asarray(j_outs))
    free = lazy >= 2 and C == 4
    assert avg.scale == (scale * C if free else scale) == outs.scale
    level = l_in - int(not free)
    assert avg.nlimbs == (level - 1 if lazy >= 4 and level > 1 else level)
    jsk = world["keys"][C - 1][0]
    sk_hub = convert.secret_key(np.asarray(jsk.s_eval), np.asarray(jsk.s_int), device="cpu")
    mean = np.mean(world["vecs"][:C], axis=0)
    for b in range(B):
        got = sch.decrypt(sk_hub, Ciphertext(avg.data[b], avg.scale))
        assert np.abs(got - mean[b]).max() < mk.ERR_GATE


def test_payloads_layout():
    vecs, n_params = mk.payloads(seed=3, n_clients=2)
    assert n_params == 1_091_101
    assert len(vecs) == 2 and all(len(v) == 154 for v in vecs)
    sizes = [v.size for v in vecs[0]]
    assert sum(sizes) - 2 * len(mk.LSTM_SHAPES) == n_params
    assert max(sizes) == 8192 and sizes[:2] == [1, 1]
    assert all(np.abs(v).max() <= 1 for v in vecs[1])
    again, _ = mk.payloads(seed=3, n_clients=2)
    assert all(np.array_equal(a, b) for a, b in zip(again[1], vecs[1]))
    assert not np.array_equal(vecs[0][2], vecs[1][2])


@pytest.mark.parametrize("lazy", [4, 0])
def test_prep_round_and_check_on_port_keys(world, lazy):
    """The bench's prep (keys, Montgomery rekeys, one encryption stack),
    round and check at N=256 on the CPU: every error below 1e-3."""
    sch = world["sch"]
    rng = np.random.default_rng(8)
    vecs = [[rng.uniform(-1, 1, 40), np.array([0.25]), rng.uniform(-1, 1, 128)]
            for _ in range(4)]
    w = mk.prep(sch, vecs, torch.Generator().manual_seed(1))
    assert tuple(w.stacks.data.shape) == (4, 3, 2, sch.params.num_q, N)
    assert len(w.rk_to) == len(w.rk_from) == 3 and w.rk_to[0].mont
    avg, outs = mk.server_round(sch, mk.stage(w.stacks, mk.inbound_level(sch, lazy)),
                                w.rk_to, w.rk_from, lazy)
    errs = mk.check(sch, w, vecs, avg, outs)
    assert set(errs) == {"hub", "client 0", "client 2"}
    assert max(errs.values()) < mk.ERR_GATE, errs


def test_aggregate_sharded_fold_divergence(tmp_path):
    """A recorded divergence where the reference is wrong: the JAX
    ``multikey._psum_mod`` (``ppqsflhe_tpu/ckks/multikey.py:29-37``) folds a
    raw sum by "−8q if ≥ 8q, then −q if ≥ q" four times, which leaves a sum
    in [6q, 8q) at [q, 3q). On 8 clients, one a device of the virtual mesh
    (N=2^12, depth 1, uniform residues from numpy seed 0), the JAX
    ``aggregate_sharded`` (average off) leaves residues ≥ q, congruent mod q
    to the sum; the port's, one client a rank of an 8-rank gloo job
    (``tests/torch_dist_worker.py``'s ``agg_fold``), is the sum mod q
    exactly, every residue in [0, q)."""
    from jax.sharding import Mesh

    from ppqsflhe_tpu.ckks.params import CkksContext as JaxContext
    from ppqsflhe_tpu_torch.parallel import multihost

    clients, n = 8, 1 << 12
    jp = JaxParams.generate(n=n, mult_depth=1, scale_bits=40, dnum=2)
    q = np.array(jp.q_moduli, np.uint64)[:, None]
    rng = np.random.default_rng(0)
    stack = np.stack([np.stack([rng.integers(0, qi, (1, 2, n), dtype=np.uint64) for qi in q[:, 0]],
                               axis=-2) for _ in range(clients)])     # (8, B=1, 2, l=2, N)
    want = stack.sum(axis=0, dtype=np.uint64) % q                     # 8 residues < 2^60: exact
    got_jax = np.asarray(jmk.aggregate_sharded(
        JaxContext(jp), jnp.asarray(stack), Mesh(np.array(jax.devices()[:clients]), ("client",)),
        jp.scale, clients, average=False).data)
    assert (got_jax >= q).sum() > 0 and (got_jax < 3 * q).all()
    np.testing.assert_array_equal(got_jax % q, want)
    np.savez(tmp_path / "in.npz", stack=stack.view(np.int64),
             params=json.dumps(convert.params_fields(convert.params(dataclasses.asdict(jp)))))
    multihost.spawn_ranks(["tests/torch_dist_worker.py", "agg_fold", str(tmp_path / "in.npz"),
                           str(tmp_path)], clients, "cpu", timeout=300)
    for r in range(clients):
        got = np.load(tmp_path / f"rank{r}.npz")["agg"].view(np.uint64)
        np.testing.assert_array_equal(got, want)
        assert (got < q).all()
