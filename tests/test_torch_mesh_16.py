"""Sixteen ranks, and a coef axis as wide as n1 = n2 = 64 at N = 2^12.

One 16-rank ``gloo`` job runs ``tests/torch_dist_worker.py``'s ``mesh_16``
scenario (torch, numpy and the port only): ``psum_mod`` over 16 ranks (the
most the fold by 8q, 4q, 2q and q takes; sixteen clients or threshold
parties, one a rank), against Python's integer sum mod q;
``threshold.joint_public_key_sharded`` with 16 parties, one a rank, against
the JAX package's ``joint_public_key`` of the 16 shares; and ``ShardedNtt``
on a coef axis of 16 (shards of 4 columns and 4 rows), stitched, against
the JAX ``FourStepNtt`` (``implementation="xla"``, jitted) over the QP
chain. A coef axis of 64 (one column and one row a shard) is held to the
same JAX transform in one process: the ranks' stage A on their column
blocks, the one-process model of the tiled all-to-all
(``mesh.exchange_tiled``, equal to gloo's exchange at 2, 4, 8 and 16 ranks
in the tests), stage B, since 64 CPU ranks of torch would take ~14 GB."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppqsflhe_tpu.ckks import threshold as jth
from ppqsflhe_tpu.ckks.params import CkksContext as JaxContext
from ppqsflhe_tpu.ckks.params import CkksParams as JaxParams
from ppqsflhe_tpu.ops.pallas_ntt import FourStepNtt as JaxFourStepNtt
from ppqsflhe_tpu_torch import convert
from ppqsflhe_tpu_torch.ckks import threshold as th
from ppqsflhe_tpu_torch.ckks.params import CkksContext
from ppqsflhe_tpu_torch.ops.cuda_mxu_ntt import CudaMxuNtt
from ppqsflhe_tpu_torch.ops.sharded_ntt import check_shards
from ppqsflhe_tpu_torch.ops.streamed_ntt import stage_a_plain, stage_b_plain
from ppqsflhe_tpu_torch.parallel import mesh as pm
from ppqsflhe_tpu_torch.parallel import multihost

N = 1 << 12
RANKS = 16
WORKER_TIMEOUT_S = 300


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The inputs, made from seeds, every rank's results and the JAX
    package's references."""
    jp = JaxParams.generate(n=N, mult_depth=2, scale_bits=40, dnum=2)
    params = convert.params(dataclasses.asdict(jp))
    ctx = CkksContext(params)
    qp = ctx.moduli_qp
    rng = np.random.default_rng(16)
    q_col = np.array(qp, np.uint64)[:, None]
    terms = np.stack([rng.integers(0, 1 << 60, (len(qp), 64), dtype=np.uint64) % q_col
                      for _ in range(RANKS)])
    terms[:, :, :8] = q_col - np.uint64(1)          # the largest sum: 16·(q − 1)
    crs = th.common_random_poly(ctx, seed=1616, device="cpu")
    b = torch.stack([th.partial_keygen(ctx, crs, torch.Generator().manual_seed(400 + i))[1]
                     for i in range(RANKS)])
    x = rng.integers(0, 1 << 60, (2, len(qp), N), dtype=np.uint64) % q_col
    y = rng.integers(0, 1 << 60, (2, len(qp), N), dtype=np.uint64) % q_col
    tmp = tmp_path_factory.mktemp("mesh16")
    np.savez(tmp / "inputs.npz", params=json.dumps(convert.params_fields(params)),
             terms=terms.view(np.int64), crs=crs.numpy(), b=b.numpy(), x=x.view(np.int64),
             y=y.view(np.int64))
    multihost.spawn_ranks(["tests/torch_dist_worker.py", "mesh_16", str(tmp / "inputs.npz"),
                           str(tmp)], RANKS, "cpu", timeout=WORKER_TIMEOUT_S)
    res = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(RANKS)]

    jctx = JaxContext(jp)
    u = lambda a: jnp.asarray(np.asarray(a).view(np.uint64))
    joint = jth.joint_public_key(jctx, u(crs.numpy()), [u(bi) for bi in b.numpy()])
    jx = JaxFourStepNtt(N, jctx.moduli_qp, jctx.basis.psis)
    want_ntt = jax.jit(lambda a: jx.ntt(a, implementation="xla"))(jnp.asarray(x))
    want_intt = jax.jit(lambda a: jx.intt(a, implementation="xla"))(jnp.asarray(y))
    return dict(ctx=ctx, qp=qp, terms=terms, x=x, y=y, res=res,
                joint_pk=np.asarray(joint.data), ntt=np.asarray(want_ntt),
                intt=np.asarray(want_intt))


def test_psum_mod_exact_at_16_ranks(world):
    """psum_mod over 16 ranks equals Python's integer sum mod q on every
    rank, the 16·(q − 1) columns included (a raw sum past 2^63)."""
    want = np.array([[sum(int(t) for t in col) % int(q) for col in row.T]
                     for q, row in zip(world["qp"], world["terms"].transpose(1, 0, 2))],
                    dtype=np.uint64)
    assert int(world["terms"][:, 0, 0].astype(object).sum()) >= 1 << 63
    for r in world["res"]:
        np.testing.assert_array_equal(r["psum"].view(np.uint64), want)


def test_joint_public_key_sharded_16_parties(world):
    """joint_public_key_sharded with one party a rank over 16 ranks equals
    the JAX package's joint_public_key of the 16 shares on every rank."""
    for r in world["res"]:
        np.testing.assert_array_equal(r["joint_pk"].view(np.uint64), world["joint_pk"])


@pytest.mark.parametrize("forward", [True, False], ids=["ntt", "intt"])
def test_coef16_shards_stitch_to_the_replicated_transform(world, forward):
    """ShardedNtt on a 16-rank coef axis (4 columns and 4 rows a shard),
    stitched, equals the JAX four-step transform over the QP chain bit for
    bit."""
    parts = [r["ntt" if forward else "intt"] for r in world["res"]]
    assert parts[0].shape[-2:] == (64, 4)
    got = np.concatenate(parts, -1).view(np.uint64)
    np.testing.assert_array_equal(got.reshape(2, len(world["qp"]), N),
                                  world["ntt" if forward else "intt"])


@pytest.mark.parametrize("forward", [True, False], ids=["ntt", "intt"])
def test_coef64_shards_stitch_to_the_replicated_transform(world, forward):
    """A 64-rank coef axis (one column, one row a shard) in one process:
    every rank's stage A at col0 = rank, the tiled exchange, every rank's
    stage B, stitched, equals the JAX four-step transform over the QP chain
    bit for bit."""
    D, ctx = 64, world["ctx"]
    check_shards(64, 64, D)
    chain = CudaMxuNtt(N, world["qp"], ctx.basis.psis).tables.streamed
    limbs = [chain.limb(i) for i in range(len(world["qp"]))]
    src = _t(world["x" if forward else "y"])
    xm = src.reshape(2, len(limbs), 64, 64)
    ys = [stage_a_plain(xm[..., k:k + 1].contiguous(), limbs, forward, k) for k in range(D)]
    zs = [stage_b_plain(t.contiguous(), limbs, forward) for t in pm.exchange_tiled(ys, 2, 3)]
    assert zs[0].shape[-1] == 1
    got = torch.cat(zs, -1).reshape(2, len(limbs), N).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, world["ntt" if forward else "intt"])
