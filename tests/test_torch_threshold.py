"""The port's threshold CKKS (``ckks/threshold.py``) against the JAX package
at N=256 on ``generate(n=256, mult_depth=2, scale_bits=40, dnum=2)``.

The arithmetic helpers, fed the JAX functions' own samples, give the JAX
residues bit for bit: the public share, the decryption share with and
without the lead, the fusion, the Shamir rows given the coefficients, σ
aggregation, ``lagrange_at_zero`` and the t-of-N decryption share. Then the
twins of tests/test_threshold.py:54-105 and 140-195 run the protocol on the
port's own draws at those tests' tolerances (0.08 N-of-N, 0.2 t-of-N), and a
mixed round — one JAX party, two port parties, one joint key — decrypts to
0.08."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppqsflhe_tpu.ckks import rlwe as jrlwe
from ppqsflhe_tpu.ckks import threshold as jth
from ppqsflhe_tpu.ckks.params import CkksParams as JaxParams
from ppqsflhe_tpu.ckks.scheme import CkksScheme as JaxScheme
from ppqsflhe_tpu.core import sampling as jsampling
from ppqsflhe_tpu_torch import convert
from ppqsflhe_tpu_torch.ckks import multikey
from ppqsflhe_tpu_torch.ckks import threshold as th
from ppqsflhe_tpu_torch.ckks.rlwe import decode_coeffs
from ppqsflhe_tpu_torch.ckks.scheme import CkksScheme
from ppqsflhe_tpu_torch.ckks.types import Ciphertext

N = 256
N_PARTIES = 3
T = lambda a: convert.residues(np.asarray(a), "cpu")     # JAX residues → port tensor
S = lambda v: torch.from_numpy(np.asarray(v).astype(np.int64))   # JAX small ints → tensor


def _eq(got: torch.Tensor, want) -> bool:
    return np.array_equal(convert.residues_np(got), np.asarray(want))


@pytest.fixture(scope="module")
def jw():
    """The JAX side: CRS, three parties' shares from JAX keys, the joint
    key, one ciphertext under it; and the port's scheme over the same
    chain."""
    jp = JaxParams.generate(n=N, mult_depth=2, scale_bits=40, dnum=2)
    js = JaxScheme(jp)
    a = jth.common_random_poly(js.ctx, seed=42)
    keys = [jax.random.PRNGKey(100 + i) for i in range(N_PARTIES)]
    parts = [jth.partial_keygen(js.ctx, a, k) for k in keys]
    pk = jth.joint_public_key(js.ctx, a, [b for _, b in parts])
    v = np.random.default_rng(1).uniform(-1, 1, js.encoder.slots)
    ct = jrlwe.encrypt(js.ctx, pk, js.make_plaintext(v), jax.random.PRNGKey(5))
    sch = CkksScheme(convert.params(dataclasses.asdict(jp)), device="cpu")
    return dict(js=js, sch=sch, a=a, keys=keys, parts=parts, pk=pk, ct=ct, v=v,
                pct=convert.ciphertext(np.asarray(ct.data), ct.scale, device="cpu"))


def _psk(jsk):
    return convert.secret_key(np.asarray(jsk.s_eval), np.asarray(jsk.s_int), device="cpu")


# -- the arithmetic, given JAX's samples -------------------------------------

def test_public_share_bit_equal(jw):
    js, sch = jw["js"], jw["sch"]
    assert _eq(th.common_random_poly(sch.ctx, 42, "cpu"), jw["a"])
    for key, (jsk, jb) in zip(jw["keys"], jw["parts"]):
        k_s, k_e = jax.random.split(key)
        s_int = jsampling.ternary(k_s, N)
        e_int = jsampling.discrete_gaussian(k_e, N, js.params.sigma)
        sk, b = th.public_share(sch.ctx, T(jw["a"]), S(s_int), S(e_int))
        assert _eq(b, jb) and _eq(sk.s_eval, jsk.s_eval)
        assert np.array_equal(sk.s_int, np.asarray(jsk.s_int))
    pk = th.joint_public_key(sch.ctx, T(jw["a"]), [T(b) for _, b in jw["parts"]])
    assert _eq(pk.data, jw["pk"].data)


@pytest.mark.parametrize("lead", [False, True])
def test_decryption_share_bit_equal(jw, lead):
    """One ciphertext, and a batch of two with a flood each."""
    js, sch = jw["js"], jw["sch"]
    jsk = jw["parts"][1][0]
    key = jax.random.PRNGKey(7)
    want = jth.partial_decrypt(js.ctx, jsk, jw["ct"], key, 30, lead=lead)
    flood = jsampling.uniform_signed(key, N, 30)
    assert _eq(th.decryption_share(sch.ctx, jw["pct"], _psk(jsk).s_eval, S(flood), lead), want)
    k2 = jax.random.PRNGKey(8)
    want2 = jth.partial_decrypt(js.ctx, jsk, jw["ct"], k2, 30, lead=lead)
    batch = Ciphertext(torch.stack([jw["pct"].data] * 2), jw["pct"].scale)
    floods = torch.stack([S(flood), S(jsampling.uniform_signed(k2, N, 30))])
    got = th.decryption_share(sch.ctx, batch, _psk(jsk).s_eval, floods, lead)
    assert _eq(got[0], want) and _eq(got[1], want2)


@pytest.mark.parametrize("include_c0", [True, False])
def test_fusion_bit_equal(jw, include_c0):
    js, sch = jw["js"], jw["sch"]
    keys = jax.random.split(jax.random.PRNGKey(10), N_PARTIES)
    partials = [jth.partial_decrypt(js.ctx, sk, jw["ct"], k, lead=(i == 0 and not include_c0))
                for i, ((sk, _), k) in enumerate(zip(jw["parts"], keys))]
    want = jth.fuse_partial_decryptions(js.ctx, jw["ct"], partials, include_c0=include_c0)
    got = th.fuse_partial_decryptions(sch.ctx, jw["pct"], [T(p) for p in partials],
                                      include_c0=include_c0)
    assert _eq(got, want)
    out = decode_coeffs(sch.ctx, got, jw["pct"], sch.encoder)
    np.testing.assert_allclose(out, jw["v"], atol=0.08)


@pytest.mark.parametrize("t", [1, 3])
def test_shamir_rows_bit_equal(jw, t):
    """Rows given JAX's coefficients uniform_rns(fold_in(key, m)), and σ
    aggregation over every party's rows."""
    js, sch = jw["js"], jw["sch"]
    n_parties = 4
    rows_j, rows_p = [], []
    for i, (jsk, _) in enumerate(jw["parts"]):
        key = jax.random.PRNGKey(600 + i)
        want = jth.shamir_share_secret(js.ctx, jsk, n_parties, t, key)
        coeffs = [T(jsampling.uniform_rns(jax.random.fold_in(key, m), js.ctx.moduli_qp, N))
                  for m in range(t - 1)]
        stack = (torch.stack(coeffs) if coeffs else
                 torch.zeros((0, len(sch.ctx.moduli_qp), N), dtype=torch.int64))
        got = th.shamir_rows(sch.ctx, _psk(jsk).s_eval, stack, n_parties)
        assert _eq(got, want)
        rows_j.append(want)
        rows_p.append(got)
    for j in range(n_parties):
        want = jth.aggregate_received_shares(js.ctx, jnp.stack([r[j] for r in rows_j]))
        got = th.aggregate_received_shares(sch.ctx, torch.stack([r[j] for r in rows_p]))
        assert _eq(got, want)


def test_lagrange_and_t_share_bit_equal(jw):
    js, sch = jw["js"], jw["sch"]
    for v in (1, 7 ** 9, 16 ** 8):
        assert _eq(th._const_residues(sch.ctx, v, "cpu"), jth._const_residues(js.ctx, v))
    for pset in ([1, 2], [3, 1], [2, 4, 5]):
        for j in pset:
            assert _eq(th.lagrange_at_zero(sch.ctx, pset, j, "cpu"),
                       jth.lagrange_at_zero(js.ctx, pset, j))
    sigma = jw["parts"][2][0].s_eval          # any residue vector will do as σ_j
    key = jax.random.PRNGKey(31)
    for lead in (False, True):
        want = jth.partial_decrypt_t(js.ctx, sigma, jw["ct"], [1, 3], 3, key, 30, lead=lead)
        flood = S(jsampling.uniform_signed(key, N, 30))
        got = th.decryption_share(
            sch.ctx, jw["pct"], th.scaled_sigma(sch.ctx, T(sigma), [1, 3], 3, jw["pct"].nlimbs),
            flood, lead)
        assert _eq(got, want)
    with pytest.raises(ValueError, match="not in the participating set"):
        th.partial_decrypt_t(sch.ctx, T(sigma), jw["pct"], [1, 2], 3,
                             torch.Generator().manual_seed(0))


def test_smudging_semantics_and_derivation(jw):
    """Twin of tests/test_threshold.py's bound check: the same noise bound
    and derived flood as the JAX functions."""
    js, sch = jw["js"], jw["sch"]
    assert th.DEFAULT_SMUDGING_BITS == jth.DEFAULT_SMUDGING_BITS == 30
    assert th.decryption_noise_bits(sch.ctx) == jth.decryption_noise_bits(js.ctx)
    assert th.flood_bits_for_ss(sch.ctx, 30) == jth.flood_bits_for_ss(js.ctx, 30)
    ref_nb = max(1, math.ceil(math.log2(3 * 6 * 3.19 * math.sqrt(2 * (1 << 14) / 3))))
    assert th.flood_bits_for_ss(sch.ctx, 30, noise_bits=ref_nb) > 40


# -- the protocol on the port's own draws ------------------------------------

@pytest.fixture(scope="module")
def joint(jw):
    sch = jw["sch"]
    gen = torch.Generator().manual_seed(100)
    a = th.common_random_poly(sch.ctx, 42, "cpu")
    parts = [th.partial_keygen(sch.ctx, a, gen) for _ in range(N_PARTIES)]
    return a, [s for s, _ in parts], th.joint_public_key(sch.ctx, a, [b for _, b in parts])


def rand_vec(sch, seed):
    return np.random.default_rng(seed).uniform(-1, 1, sch.encoder.slots)


def test_crs_deterministic(jw):
    ctx = jw["sch"].ctx
    a1, a2 = th.common_random_poly(ctx, 7, "cpu"), th.common_random_poly(ctx, 7, "cpu")
    assert torch.equal(a1, a2)
    assert not torch.equal(a1, th.common_random_poly(ctx, 8, "cpu"))


def test_joint_encrypt_threshold_decrypt(jw, joint):
    sch = jw["sch"]
    _, shares, pk = joint
    gen = torch.Generator().manual_seed(5)
    v = rand_vec(sch, 1)
    out = th.threshold_decrypt(sch.ctx, sch.encrypt_values(pk, v, gen), shares, gen,
                               sch.encoder)
    np.testing.assert_allclose(out, v, atol=0.08)
    vs = [rand_vec(sch, 2 + i) for i in range(3)]
    outs = th.threshold_decrypt(sch.ctx, sch.encrypt_values(pk, vs, gen), shares, gen,
                                sch.encoder)
    for o, w in zip(outs, vs):
        np.testing.assert_allclose(o, w, atol=0.08)


def test_no_single_share_decrypts(jw, joint):
    sch = jw["sch"]
    _, shares, pk = joint
    gen = torch.Generator().manual_seed(7)
    v = rand_vec(sch, 2)
    out = th.threshold_decrypt(sch.ctx, sch.encrypt_values(pk, v, gen), shares[:-1], gen,
                               sch.encoder)
    assert np.abs(out - v).max() > 1.0


def test_lead_main_fusion_split(jw, joint):
    sch = jw["sch"]
    _, shares, pk = joint
    gen = torch.Generator().manual_seed(9)
    v = rand_vec(sch, 3)
    ct = sch.encrypt_values(pk, v, gen)
    partials = [th.partial_decrypt(sch.ctx, shares[0], ct, gen, lead=True)]
    partials += [th.partial_decrypt(sch.ctx, s, ct, gen) for s in shares[1:]]
    coeffs = th.fuse_partial_decryptions(sch.ctx, ct, partials, include_c0=False)
    np.testing.assert_allclose(decode_coeffs(sch.ctx, coeffs, ct, sch.encoder), v, atol=0.08)


def test_threshold_fedavg_round(jw, joint):
    """The PRE-free round: every client encrypts under the joint key,
    ``multikey.aggregate_local`` (add, ×1/N, rescale), joint decryption."""
    sch = jw["sch"]
    _, shares, pk = joint
    gen = torch.Generator().manual_seed(20)
    vecs = [rand_vec(sch, 10 + i) for i in range(N_PARTIES)]
    agg = multikey.aggregate_local(sch.ctx, [sch.encrypt_values(pk, v, gen) for v in vecs])
    out = th.threshold_decrypt(sch.ctx, agg, shares, gen, sch.encoder)
    np.testing.assert_allclose(out, np.mean(vecs, axis=0), atol=0.08)


def _sigmas(sch, shares, n_parties, t, gen):
    outgoing = [th.shamir_share_secret(sch.ctx, s, n_parties, t, gen) for s in shares]
    return {j: th.aggregate_received_shares(
        sch.ctx, torch.stack([outgoing[i][j - 1] for i in range(len(shares))]))
        for j in range(1, n_parties + 1)}


def test_t_of_n_decryption(jw, joint):
    sch = jw["sch"]
    _, shares, pk = joint
    gen = torch.Generator().manual_seed(500)
    v = np.linspace(-1, 1, sch.encoder.slots)
    ct = sch.encrypt_values(pk, v, gen)
    sigmas = _sigmas(sch, shares, N_PARTIES, 2, gen)
    for party_set in ([1, 2], [1, 3], [2, 3]):
        got = th.threshold_decrypt_t(sch.ctx, ct, sigmas, party_set, gen, sch.encoder)
        np.testing.assert_allclose(got, v, atol=0.2)
    bad = th.threshold_decrypt_t(sch.ctx, ct, sigmas, [2], gen, sch.encoder)
    assert np.abs(bad - v).max() > 1.0


def test_t_of_n_after_homomorphic_fedavg(jw, joint):
    sch = jw["sch"]
    _, shares, pk = joint
    gen = torch.Generator().manual_seed(800)
    v1, v2 = np.linspace(-1, 1, sch.encoder.slots), np.linspace(1, -1, sch.encoder.slots)
    avg = sch.mult_scalar(sch.add(sch.encrypt_values(pk, v1, gen),
                                  sch.encrypt_values(pk, v2, gen)), 0.5)
    sigmas = _sigmas(sch, shares, N_PARTIES, 2, gen)
    got = th.threshold_decrypt_t(sch.ctx, avg, sigmas, [3, 1], gen, sch.encoder)
    np.testing.assert_allclose(got, (v1 + v2) / 2, atol=0.2)


def test_mixed_party_round(jw):
    """One JAX party and two port parties on the shared CRS make one joint
    key; the port encrypts under it, the JAX party decrypts its share in
    the JAX package and the port parties theirs, and the fusion decodes to
    0.08."""
    js, sch = jw["js"], jw["sch"]
    jsk, jb = jw["parts"][0]                          # the JAX party (seed 42's CRS)
    a = th.common_random_poly(sch.ctx, 42, "cpu")
    gen = torch.Generator().manual_seed(77)
    port_parts = [th.partial_keygen(sch.ctx, a, gen) for _ in range(2)]
    pk = th.joint_public_key(sch.ctx, a, [T(jb)] + [b for _, b in port_parts])
    v = rand_vec(sch, 77)
    ct = sch.encrypt_values(pk, v, gen)
    jct = type(jw["ct"])(jnp.asarray(convert.residues_np(ct.data)), ct.scale)
    partials = [T(jth.partial_decrypt(js.ctx, jsk, jct, jax.random.PRNGKey(78)))]
    partials += [th.partial_decrypt(sch.ctx, sk, ct, gen) for sk, _ in port_parts]
    out = decode_coeffs(sch.ctx, th.fuse_partial_decryptions(sch.ctx, ct, partials), ct,
                        sch.encoder)
    np.testing.assert_allclose(out, v, atol=0.08)
