"""The rest of the port's scheme surface against the JAX package at N=256 on
``generate(n=256, mult_depth=2, scale_bits=40, dnum=2)`` (radix-2, the JAX
default, as tests/test_ckks.py runs it): ``eval.sub``, ``negate``,
``add_plain``, ``mult_plain`` and ``mult_scalar(rescale_after=False)`` give
the JAX package's residues bit for bit on ciphertexts it made (one at a
time and as a batch), the scheme's ``mult_plain`` / ``mult_scalar`` in both
rescale modes too, ``decode`` agrees to 1e-12, and ``ckks/noise.py`` gives
the same integer noise, bits and report on the same ciphertext and key.
The twins of tests/test_ckks.py:54,84,342 and tests/test_noise.py:17,32
hold the port's decrypted values at those tests' tolerances."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ppqsflhe_tpu.ckks import eval as jev
from ppqsflhe_tpu.ckks import noise as jnoise
from ppqsflhe_tpu.ckks.params import CkksParams as JaxParams
from ppqsflhe_tpu.ckks.scheme import CkksScheme as JaxScheme
from ppqsflhe_tpu.ckks.types import Ciphertext as JaxCt
from ppqsflhe_tpu_torch import convert
from ppqsflhe_tpu_torch.ckks import eval as ev
from ppqsflhe_tpu_torch.ckks import noise
from ppqsflhe_tpu_torch.ckks.scheme import CkksScheme
from ppqsflhe_tpu_torch.ckks.types import Ciphertext, Plaintext

N = 256
B = 3


@pytest.fixture(scope="module")
def world():
    jp = JaxParams.generate(n=N, mult_depth=2, scale_bits=40, dnum=2)
    js = JaxScheme(jp)
    sch = CkksScheme(convert.params(dataclasses.asdict(jp)), device="cpu")
    jsk, jpk = js.keygen(jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    vs = [rng.uniform(-1, 1, js.encoder.slots) for _ in range(B + 1)]
    jcts = [js.encrypt_values(jpk, v, jax.random.PRNGKey(10 + i)) for i, v in enumerate(vs)]
    jpt = js.make_plaintext(vs[-1])
    return dict(
        js=js, sch=sch, jsk=jsk, vs=vs, jcts=jcts, jpt=jpt,
        sk=convert.secret_key(np.asarray(jsk.s_eval), np.asarray(jsk.s_int), device="cpu"),
        cts=[convert.ciphertext(np.asarray(c.data), c.scale, device="cpu") for c in jcts],
        batch=convert.ciphertext(np.stack([np.asarray(c.data) for c in jcts[:B]]),
                                 jcts[0].scale, device="cpu"),
        pt=Plaintext(convert.residues(np.asarray(jpt.data), "cpu"), jpt.scale))


def _same(got: Ciphertext, want: JaxCt) -> None:
    assert np.array_equal(convert.residues_np(got.data), np.asarray(want.data))
    assert got.scale == want.scale


@pytest.mark.parametrize("op", ["sub", "negate", "add_plain", "mult_plain"])
def test_linear_ops_bit_equal(world, op):
    """Each op on one ciphertext and on the stacked batch gives the JAX
    residues (the batch entry by entry)."""
    js, sch, jcts, cts = world["js"], world["sch"], world["jcts"], world["cts"]
    jf = {"sub": lambda a: jev.sub(js.ctx, a, jcts[B]),
          "negate": lambda a: jev.negate(js.ctx, a),
          "add_plain": lambda a: jev.add_plain(js.ctx, a, world["jpt"]),
          "mult_plain": lambda a: jev.mult_plain(js.ctx, a, world["jpt"])}[op]
    pf = {"sub": lambda a: ev.sub(sch.ctx, a, cts[B]),
          "negate": lambda a: ev.negate(sch.ctx, a),
          "add_plain": lambda a: ev.add_plain(sch.ctx, a, world["pt"]),
          "mult_plain": lambda a: ev.mult_plain(sch.ctx, a, world["pt"])}[op]
    _same(pf(cts[0]), jf(jcts[0]))
    got = pf(world["batch"])
    for i in range(B):
        _same(Ciphertext(got.data[i], got.scale), jf(jcts[i]))


@pytest.mark.parametrize("rescale_after", [True, False])
@pytest.mark.parametrize("c", [0.5, -0.3])
def test_mult_scalar_bit_equal(world, c, rescale_after):
    """``mult_scalar`` encodes at q_last and rescales (default) or encodes
    at Δ and keeps the limb (``rescale_after=False``), as the JAX op does."""
    js, sch = world["js"], world["sch"]
    want = jev.mult_scalar(js.ctx, world["jcts"][1], c, rescale_after)
    got = sch.mult_scalar(world["cts"][1], c, rescale_after=rescale_after)
    _same(got, want)
    assert got.nlimbs == world["cts"][1].nlimbs - int(rescale_after)
    batch = sch.mult_scalar(world["batch"], c, rescale_after=rescale_after)
    _same(Ciphertext(batch.data[1], batch.scale), want)


@pytest.mark.parametrize("rescale_after", [True, False])
def test_scheme_mult_plain_bit_equal(world, rescale_after):
    js, sch = world["js"], world["sch"]
    want = js.mult_plain(world["jcts"][2], world["jpt"], rescale_after=rescale_after)
    _same(sch.mult_plain(world["cts"][2], world["pt"], rescale_after=rescale_after), want)


def test_add_sub_decrypt(world):
    """Twin of tests/test_ckks.py:54 on the port's scheme."""
    sch, sk, cts, vs = world["sch"], world["sk"], world["cts"], world["vs"]
    np.testing.assert_allclose(sch.decrypt(sk, sch.add(cts[0], cts[1])), vs[0] + vs[1],
                               atol=1e-6)
    np.testing.assert_allclose(sch.decrypt(sk, sch.sub(cts[0], cts[1])), vs[0] - vs[1],
                               atol=1e-6)
    np.testing.assert_allclose(sch.decrypt(sk, sch.add_plain(cts[0], world["pt"])),
                               vs[0] + vs[B], atol=1e-6)


def test_mult_plain_decrypt(world):
    """Twin of tests/test_ckks.py:84: Enc(v1) × Pt(v2), rescaled, within
    1e-5 of v1·v2; the port's own plaintext gives the same residues as
    the JAX one."""
    sch, sk, vs = world["sch"], world["sk"], world["vs"]
    pt = sch.make_plaintext(vs[B])
    assert torch.equal(pt.data, world["pt"].data)
    out = sch.mult_plain(world["cts"][0], pt)
    np.testing.assert_allclose(sch.decrypt(sk, out), vs[0] * vs[B], atol=1e-5)
    half = sch.mult_scalar(world["cts"][0], 0.5, rescale_after=False)
    assert np.isclose(half.scale, world["cts"][0].scale * sch.params.scale)
    np.testing.assert_allclose(sch.decrypt(sk, sch.rescale(half)), 0.5 * vs[0], atol=1e-6)


def test_mult_scale_mismatch_raises(world):
    """Twin of tests/test_ckks.py:342: a Δ² operand against a fresh Δ one
    makes ``mult`` raise."""
    sch, sk, cts = world["sch"], world["sk"], world["cts"]
    rk = sch.relin_key_gen(sk, torch.Generator().manual_seed(40))
    bad = sch.mult_plain(cts[1], sch.make_plaintext(np.ones(sch.encoder.slots)),
                         rescale_after=False)
    assert bad.scale > cts[0].scale * 1e6
    with pytest.raises(ValueError, match="scale mismatch"):
        sch.mult(cts[0], bad, rk)


def test_decode_agrees(world):
    js, sch = world["js"], world["sch"]
    rng = np.random.default_rng(5)
    coeffs = rng.integers(-2 ** 45, 2 ** 45, N).astype(np.float64)
    for num in (None, 7):
        want = js.decode(coeffs, js.params.scale, num)
        got = sch.decode(coeffs, sch.params.scale, num)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("which", ["fresh", "aggregated"])
def test_noise_equal(world, which):
    """noise_coeffs equal as integers, noise_bits and budget_report equal,
    on a fresh ciphertext and on (ct0 + ct1) × 0.5."""
    js, sch, vs = world["js"], world["sch"], world["vs"]
    if which == "fresh":
        jct, ct, want = world["jcts"][0], world["cts"][0], vs[0]
    else:
        jct = jev.mult_scalar(js.ctx, jev.add(js.ctx, world["jcts"][0], world["jcts"][1]), 0.5)
        ct = sch.mult_scalar(sch.add(world["cts"][0], world["cts"][1]), 0.5)
        want = (vs[0] + vs[1]) / 2
    je = jnoise.noise_coeffs(js, world["jsk"], jct, want)
    pe = noise.noise_coeffs(sch, world["sk"], ct, want)
    assert [int(x) for x in pe] == [int(x) for x in je]
    assert noise.noise_bits(sch, world["sk"], ct, want) == jnoise.noise_bits(
        js, world["jsk"], jct, want)
    assert noise.budget_report(sch, world["sk"], ct, want) == jnoise.budget_report(
        js, world["jsk"], jct, want)


def test_fresh_ciphertext_noise(world):
    """Twin of tests/test_noise.py:17 on keys and a ciphertext the port made."""
    sch = world["sch"]
    gen = torch.Generator().manual_seed(0)
    sk, pk = sch.keygen(gen)
    v = np.random.default_rng(0).uniform(-1, 1, sch.encoder.slots)
    ct = sch.encrypt_values(pk, v, gen)
    nb = noise.noise_bits(sch, sk, ct, v)
    assert 0 < nb < 25, nb
    rep = noise.budget_report(sch, sk, ct, v)
    assert rep["budget_bits"] > 30
    assert rep["nlimbs"] == sch.params.num_q
    err = float(np.abs(sch.decrypt(sk, ct) - v).max())
    assert err < 2.0 ** (rep["predicted_slot_error_log2"] + 4)


def test_noise_grows_through_the_server_round(world):
    """Twin of tests/test_noise.py:32: PRE + FedAvg stays far from both
    walls, on the port's keys."""
    from ppqsflhe_tpu_torch.ckks import eval as pev

    sch = world["sch"]
    gen = torch.Generator().manual_seed(10)
    sk1, pk1 = sch.keygen(gen)
    sk2, pk2 = sch.keygen(gen)
    rk12 = pev.ksk_to_mont(sch.ctx, sch.rekey_gen(sk1, pk2, gen))
    rng = np.random.default_rng(1)
    v1, v2 = rng.uniform(-1, 1, sch.encoder.slots), rng.uniform(-1, 1, sch.encoder.slots)
    ct1, ct2 = sch.encrypt_values(pk1, v1, gen), sch.encrypt_values(pk2, v2, gen)
    fresh = noise.noise_bits(sch, sk2, ct2, v2)
    agg = sch.mult_scalar(sch.add(sch.re_encrypt(ct1, rk12), ct2), 0.5)
    rep = noise.budget_report(sch, sk2, agg, (v1 + v2) / 2)
    assert rep["noise_bits"] > 0
    assert rep["budget_bits"] > 20, rep
    assert rep["noise_bits"] < fresh + 25, (rep, fresh)
