"""The port's mesh parallelism (``parallel/``, ``ops/sharded_ntt.py``, the
mesh variants of multikey and threshold) against the JAX package's
replicated functions at N=2^12 (n1 = n2 = 64), on 2- and 4-rank ``gloo``
jobs on the CPU.

Each world size runs once per module: ``tests/torch_dist_worker.py`` as D
processes (torch, numpy and the port only), inputs and results as ``.npz``
files; the parent stitches the ranks' shards and compares them, bit for
bit, with the JAX package run eagerly (its ``shard_map`` versions compile
for more than 15 s each; its cheap ``aggregate_sharded`` runs on the
8-device CPU mesh). Keys and ciphertexts are made by the port in the
parent and cross over as numpy residues. The threshold decryption's noise
comes from torch generators, which JAX cannot replay: it is held bit-equal
to the port's own single-device partials and fusion from the same
generators, and by its decrypt error against the JAX function's.
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from ppqsflhe_tpu.ckks import eval as jev
from ppqsflhe_tpu.ckks import multikey as jmk
from ppqsflhe_tpu.ckks import threshold as jth
from ppqsflhe_tpu.ckks.params import CkksParams as JaxParams
from ppqsflhe_tpu.ckks.params import CkksContext as JaxContext
from ppqsflhe_tpu.ckks.types import Ciphertext as JaxCt
from ppqsflhe_tpu.ckks.types import KeySwitchKey as JaxKsk
from ppqsflhe_tpu.core.modarith import modadd as jmodadd
from ppqsflhe_tpu_torch import convert
from ppqsflhe_tpu_torch.ckks import threshold as th
from ppqsflhe_tpu_torch.ckks.rlwe import decode_coeffs
from ppqsflhe_tpu_torch.ckks.scheme import CkksScheme
from ppqsflhe_tpu_torch.ckks.types import Ciphertext
from ppqsflhe_tpu_torch.ops import sharded_ntt
from ppqsflhe_tpu_torch.parallel import mesh as pm
from ppqsflhe_tpu_torch.parallel import multihost
from ppqsflhe_tpu_torch.parallel.sharded_scheme import eval_unshard

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_dist_worker import ROTS, SUBSETS  # noqa: E402

N = 1 << 12
B = 2                 # ciphertexts per client
AGG_CLIENTS = 8       # clients of the aggregation, parties of the threshold key
FLOOD_SEED = 500
WORKER_TIMEOUT_S = 300
# the threshold decryption's slot error, RMS against σ = √(P·N/6)·2^30/Δ
# (8 parties; ckks/threshold.py): the port's and the JAX function's within
# 0.9–1.1 σ, and the port's RMS within 10% of the JAX one's on the same
# ciphertext (2048 slots of 1-σ noise spread the RMS by ~2%)
SIGMA_BAND = (0.9, 1.1)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The inputs, made by the port from seeds; the JAX params they share."""
    jp = JaxParams.generate(n=N, mult_depth=2, scale_bits=40, dnum=2,
                            ntt_backend="fourstep", ntt_impl="mxu")
    fields = dataclasses.asdict(jp)
    sch = CkksScheme(convert.params(fields), device="cpu")
    ctx = sch.ctx
    gen = torch.Generator().manual_seed(21)
    sk1, pk1 = sch.keygen(gen)
    sk2, pk2 = sch.keygen(gen)
    rng = np.random.default_rng(22)
    slots = sch.encoder.slots
    vecs = [[rng.uniform(-1, 1, slots) for _ in range(B)] for _ in range(2)]
    cts = [sch.encrypt_values(pk, v, gen) for pk, v in ((pk1, vecs[0]), (pk2, vecs[1]))]
    stacks = torch.stack([c.data for c in cts])
    agg_vecs = [[rng.uniform(-1, 1, slots) for _ in range(B)] for _ in range(AGG_CLIENTS)]
    agg_stack = torch.stack([sch.encrypt_values(pk2, v, gen).data for v in agg_vecs])
    crs = th.common_random_poly(ctx, seed=77, device="cpu")
    parties = [th.partial_keygen(ctx, crs, torch.Generator().manual_seed(200 + i))
               for i in range(AGG_CLIENTS)]
    th_vec = rng.uniform(-1, 1, slots)
    th_ct = sch.encrypt_values(th.joint_public_key(ctx, crs, [b for _, b in parties]),
                               th_vec, gen)
    x_ntt = np.stack([rng.integers(0, q, (B, N), dtype=np.uint64) for q in ctx.moduli_qp],
                     axis=1)
    keys = {"rk12": sch.rekey_gen(sk1, pk2, gen).data,
            "rk21": sch.rekey_gen(sk2, pk1, gen).data,
            "conj": sch.conjugation_key_gen(sk2, gen).data}
    keys.update({f"rot{k}": v.data for k, v in sch.rotation_key_gen(sk2, ROTS, gen).items()})
    arrays = dict(
        params=json.dumps(convert.params_fields(sch.params)),
        stacks=stacks.numpy(), scale=np.array(cts[0].scale),
        agg_stack=agg_stack.numpy(), crs=crs.numpy(),
        b_shares=torch.stack([b for _, b in parties]).numpy(),
        s_shares=torch.stack([s.s_eval for s, _ in parties]).numpy(),
        th_ct=th_ct.data.numpy(), th_scale=np.array(th_ct.scale),
        flood_seed=np.array(FLOOD_SEED), x_ntt=x_ntt.view(np.int64),
        **{k: v.numpy() for k, v in keys.items()})
    path = tmp_path_factory.mktemp("parallel") / "inputs.npz"
    np.savez(path, **arrays)
    return dict(arrays, jp=jp, sch=sch, path=path, vecs=vecs, agg_vecs=agg_vecs,
                th_vec=th_vec, parties=parties, th_cipher=th_ct, sk2=sk2)


@pytest.fixture(scope="module", params=[2, 4], ids=["2 ranks", "4 ranks"])
def ranks(request, world, tmp_path_factory):
    """Every rank's results of one D-rank job."""
    D = request.param
    out = tmp_path_factory.mktemp(f"ranks{D}")
    multihost.spawn_ranks(["tests/torch_dist_worker.py", "parallel", str(world["path"]),
                           str(out)], D, "cpu", timeout=WORKER_TIMEOUT_S)
    return D, [dict(np.load(out / f"rank{r}.npz")) for r in range(D)]


@pytest.fixture(scope="module")
def jref(world):
    """The JAX package's replicated results, run eagerly."""
    jp = world["jp"]
    ctx = JaxContext(jp)
    u = lambda a: jnp.asarray(np.asarray(a).view(np.uint64))
    x = u(world["x_ntt"])
    all_idx = tuple(range(len(ctx.moduli_qp)))
    ref = {"ntt": np.asarray(ctx.ntt(x, all_idx)), "intt": np.asarray(ctx.intt(x, all_idx))}
    for i, idx in enumerate(SUBSETS):
        ref[f"ctx_ntt_{i}"] = np.asarray(ctx.ntt(x[..., list(idx), :], idx))
        ref[f"ctx_intt_{i}"] = np.asarray(ctx.intt(x[..., list(idx), :], idx))
    stacks, scale = u(world["stacks"]), float(world["scale"])
    key = lambda name: JaxKsk(data=u(world[name]))
    L = jp.num_q

    def reenc(d, k, l):
        q, _, _ = ctx.limb_consts(ctx.q_idx(l))
        d0, d1 = jev.keyswitch(ctx, d[..., 1, :, :], k, l)
        return jnp.stack([jmodadd(d[..., 0, :, :], d0, q), d1], axis=-3)

    per_ct = lambda f, batch: jnp.stack([f(JaxCt(batch[b], scale)) for b in range(B)])
    ref["reenc"] = np.asarray(jnp.stack([reenc(stacks[0, b], key("rk12"), L)
                                         for b in range(B)]))
    avg = [jev.mult_scalar(ctx, jev.add(ctx, JaxCt(ref["reenc"][b], scale),
                                        JaxCt(stacks[1, b], scale)), 0.5) for b in range(B)]
    ref["avg"] = np.asarray(jnp.stack([a.data for a in avg]))
    ref["back"] = np.asarray(jnp.stack([reenc(a.data, key("rk21"), a.nlimbs) for a in avg]))
    rot = {k: key(f"rot{k}") for k in ROTS}
    for k in ROTS:
        ref[f"rot_{k}"] = np.asarray(per_ct(lambda c: jev.rotate(ctx, c, k, rot[k]).data,
                                            stacks[1]))
    ref["conj"] = np.asarray(per_ct(lambda c: jev.conjugate(ctx, c, key("conj")).data,
                                    stacks[1]))
    hoisted = [jev.rotate_hoisted(ctx, JaxCt(stacks[1, b], scale), list(ROTS), rot)
               for b in range(B)]
    for i, k in enumerate(ROTS):
        ref[f"hoisted_{k}"] = np.asarray(jnp.stack([h[i].data for h in hoisted]))
    agg = u(world["agg_stack"])
    mesh = Mesh(np.array(jax.devices()[:4]), ("client",))
    ref["agg_avg"] = np.asarray(jmk.aggregate_sharded(ctx, agg, mesh, scale, AGG_CLIENTS).data)
    ref["agg_sum"] = np.asarray(jmk.aggregate_sharded(ctx, agg, mesh, scale, AGG_CLIENTS,
                                                      average=False).data)
    ref["agg_local"] = np.stack([np.asarray(jmk.aggregate_local(
        ctx, [JaxCt(agg[i, b], scale) for i in range(AGG_CLIENTS)]).data) for b in range(B)])
    b_shares = [u(b) for b in world["b_shares"]]
    ref["joint_pk"] = np.asarray(jth.joint_public_key(ctx, u(world["crs"]), b_shares).data)
    th_ct = JaxCt(u(world["th_ct"]), float(world["th_scale"]))
    coeffs = jth.partial_decrypt_psum(ctx, th_ct, u(world["s_shares"]),
                                      jax.random.split(jax.random.PRNGKey(9), AGG_CLIENTS),
                                      mesh)
    ref["pdec_jax"] = np.asarray(coeffs)
    return ref


def _eval_full(parts, world):
    ctx = world["sch"].ctx
    return eval_unshard([torch.from_numpy(p) for p in parts], ctx.fntt.n1, ctx.fntt.n2).numpy()


def _u(a):
    return np.asarray(a).view(np.uint64)


def _sigma(world):
    n, parties = world["jp"].n, AGG_CLIENTS
    return (parties * n / 6) ** 0.5 * 2.0 ** th.DEFAULT_SMUDGING_BITS / world["th_cipher"].scale


def test_all_to_all_tiled_order(ranks):
    """gloo's exchange, packed and unpacked, gives each rank the blocks of
    every rank in source order (the one-process model of the exchange)."""
    D, res = ranks
    assert all(bool(r["a2a_ok"]) for r in res)


def test_sharded_ntt_equals_jax_fourstep(ranks, world, jref):
    """ShardedNtt forward equals the JAX four-step transform (kernel order)
    bit for bit, the inverse too, and the round trip is exact."""
    D, res = ranks
    ctx = world["sch"].ctx
    n1, n2, L = ctx.fntt.n1, ctx.fntt.n2, len(ctx.moduli_qp)
    fwd = np.concatenate([r["ntt"] for r in res], -1).reshape(B, L, N)
    np.testing.assert_array_equal(_u(fwd), jref["ntt"])
    back = np.concatenate([r["ntt_back"] for r in res], -1).reshape(B, L, N)
    np.testing.assert_array_equal(back, world["x_ntt"])
    inv = np.concatenate([r["intt"] for r in res], -1).reshape(B, L, N)
    np.testing.assert_array_equal(_u(inv), jref["intt"])
    assert (n1, n2) == (64, 64)


def test_context_transforms_equal_jax(ranks, world, jref):
    """ShardedEvalContext.ntt / intt equal the JAX context's at every limb
    subset the round transforms."""
    D, res = ranks
    ctx = world["sch"].ctx
    for i, idx in enumerate(SUBSETS):
        fwd = _eval_full([r[f"ctx_ntt_{i}"] for r in res], world)
        np.testing.assert_array_equal(_u(fwd), jref[f"ctx_ntt_{i}"])
        inv = np.concatenate([r[f"ctx_intt_{i}"].reshape(B, len(idx), ctx.fntt.n1, -1)
                              for r in res], -1).reshape(B, len(idx), N)
        np.testing.assert_array_equal(_u(inv), jref[f"ctx_intt_{i}"])


def test_aggregate_sharded_equals_jax(ranks, world, jref):
    """aggregate_sharded equals the JAX aggregate_sharded (average on and
    off) on every rank, the average equals aggregate_local, and it decrypts
    to the mean (1e-4, the JAX test's gate)."""
    D, res = ranks
    for r in res:
        np.testing.assert_array_equal(_u(r["agg_avg"]), jref["agg_avg"])
        np.testing.assert_array_equal(_u(r["agg_sum"]), jref["agg_sum"])
    for b in range(B):
        np.testing.assert_array_equal(jref["agg_avg"][b], jref["agg_local"][b])
    sch = world["sch"]
    ct = Ciphertext(torch.from_numpy(res[0]["agg_avg"][0]), float(world["scale"]))
    want = np.mean([v[0] for v in world["agg_vecs"]], axis=0)
    sk2 = world["sk2"]
    assert np.abs(sch.decrypt(sk2, ct) - want).max() < 1e-4


def test_re_encrypt_and_round_equal_jax(ranks, world, jref):
    """re_encrypt_sharded on the coef mesh, and fedavg_round_sharded on
    client × coef meshes (2 × 2 at 4 ranks; 1 × 2 and 2 × 1 at 2), equal the
    JAX replicated re-encryption and round bit for bit."""
    D, res = ranks
    np.testing.assert_array_equal(_u(_eval_full([r["reenc"] for r in res], world)),
                                  jref["reenc"])
    layouts = ((1, 2), (2, 1)) if D == 2 else ((2, D // 2),)
    for nc, nd in layouts:
        for part in ("avg", "back"):
            for c in range(nc):       # every client block holds the whole result
                parts = [res[c * nd + k][f"round_{nc}x{nd}_{part}"] for k in range(nd)]
                np.testing.assert_array_equal(_u(_eval_full(parts, world)), jref[part])


def test_rotations_equal_jax(ranks, world, jref):
    """rotate_sharded, conjugate_sharded and rotate_hoisted_sharded on the
    coef mesh equal the JAX rotate / conjugate / rotate_hoisted."""
    D, res = ranks
    for name in [f"rot_{k}" for k in ROTS] + ["conj"] + [f"hoisted_{k}" for k in ROTS]:
        np.testing.assert_array_equal(_u(_eval_full([r[name] for r in res], world)),
                                      jref[name])


def test_joint_public_key_sharded_bitequal(ranks, jref):
    D, res = ranks
    for r in res:
        np.testing.assert_array_equal(_u(r["joint_pk"]), jref["joint_pk"])


def test_partial_decrypt_psum(ranks, world, jref):
    """Bit-equal to the port's single-device partial decryptions and fusion
    from the same generators; its slot error, and the JAX function's on the
    same ciphertext, within SIGMA_BAND of σ, and within 10% of each other."""
    D, res = ranks
    ctx, ct = world["sch"].ctx, world["th_cipher"]
    partials = [th.partial_decrypt(ctx, s, ct, torch.Generator().manual_seed(FLOOD_SEED + i))
                for i, (s, _) in enumerate(world["parties"])]
    want = th.fuse_partial_decryptions(ctx, ct, partials).numpy()
    for r in res:
        np.testing.assert_array_equal(r["pdec"], want)
    enc = world["sch"].encoder
    rms = {}
    for name, coeffs in (("port", torch.from_numpy(want)),
                         ("jax", torch.from_numpy(jref["pdec_jax"].view(np.int64).copy()))):
        got = decode_coeffs(ctx, coeffs, ct, enc)
        rms[name] = float(np.sqrt(np.mean((np.asarray(got) - world["th_vec"]) ** 2)))
    sigma = _sigma(world)
    for name, v in rms.items():
        assert SIGMA_BAND[0] * sigma < v < SIGMA_BAND[1] * sigma, (name, v / sigma)
    assert abs(rms["port"] / rms["jax"] - 1) < 0.1, rms


def test_collective_counts(ranks):
    """One all-to-all per sharded NTT or iNTT call, one all-reduce per
    round; the round's eleven transforms where the hub's coef ranks skip its
    PRE (PRE l=3: 5, ÷2 + rescale: 2, PRE back l=2: 4)."""
    D, res = ranks
    for r in res:
        assert int(r["ntt_a2a_ops"]) == 1
        assert int(r["ctx_a2a_ops"]) == 2
    layouts = ((1, 2), (2, 1)) if D == 2 else ((2, D // 2),)
    for nc, nd in layouts:
        for k, r in enumerate(res):
            assert int(r[f"round_{nc}x{nd}_reduce_ops"]) == 1
            hub = k // nd == nc - 1
            want = 6 if (nc == 2 and hub) else 11
            assert int(r[f"round_{nc}x{nd}_a2a_ops"]) == want


@pytest.mark.parametrize("terms", range(2, 17))
def test_fold_mod_exact(terms):
    """The modular fold of a raw int64 sum of ``terms`` residues q − 1 on a
    60-bit prime (the sum passes 2^63 from 8 terms on; 16 terms, psum_mod's
    most, reach 16q − 16) gives terms·(q−1) mod q."""
    q = JaxParams.generate(n=N, mult_depth=2, scale_bits=40, dnum=2).q_moduli[0]
    assert q.bit_length() == 60
    qt = torch.tensor([[q], [q - 2]], dtype=torch.int64)
    x = (qt - 1).expand(2, 4).contiguous()
    s = torch.zeros_like(x)
    for _ in range(terms):
        s = s + x                                  # wraps as uint64 addition does
    got = pm.fold_mod(s, qt)
    want = [terms * (int(v) - 1) % int(v) for v in qt[:, 0]]
    assert got[:, 0].tolist() == want
    assert got.tolist() == [[want[0]] * 4, [want[1]] * 4]


def test_shard_limits(monkeypatch):
    """The coef axis takes every D the JAX classes take, any D dividing n1
    and n2 (kernels 4 and 5 take shards narrower than a 16-wide tile, and
    m = 8 and 16): 8 ranks at N=2^12 (n1 = n2 = 64), 16 at N=2^14, one at
    N=2^8. It raises where the JAX classes raise, for a D that does not
    divide n1 or n2. The modular psum takes 16 ranks and refuses 17 (a group
    of 17 stood in for by the world size it reports): a raw sum of 17
    residues can reach 16q, past the fold by 8q, 4q, 2q and q."""
    for n1, n2, D in ((64, 64, 4), (128, 128, 8), (256, 256, 8), (64, 64, 8),
                      (128, 128, 16), (16, 16, 1), (8, 16, 8), (64, 64, 64), (256, 256, 256)):
        sharded_ntt.check_shards(n1, n2, D)
    for n1, n2, D in ((64, 64, 3), (64, 64, 128), (16, 32, 32), (8, 8, 16), (64, 64, 0)):
        with pytest.raises(ValueError, match="must divide"):
            sharded_ntt.check_shards(n1, n2, D)
    with pytest.raises(ValueError, match="n1, n2 in"):
        sharded_ntt.check_shards(4, 8, 1)
    assert pm.MAX_PSUM_SHARDS == 16
    q = torch.ones(1, dtype=torch.int64)
    monkeypatch.setattr(pm.dist, "get_world_size", lambda group=None: 17)
    with pytest.raises(ValueError, match="16 shards"):
        pm.psum_mod(torch.zeros(1, dtype=torch.int64), q, None)
