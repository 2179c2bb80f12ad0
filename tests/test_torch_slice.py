"""The port's whole slice against the JAX package: keys and ciphertexts made
by the JAX package cross over through ``convert``, and the port's
``server_round`` must give the same residues, bit for bit, as the same round
run by the JAX package (bench.py's ``server_round``) in all five schedules.
Decryption crosses both ways. Decrypted values are held to 1e-6 absolute at
Δ = 2^40 (the fresh-encryption noise is ~1e-8 there)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppqsflhe_tpu.ckks import eval as jev
from ppqsflhe_tpu.ckks.params import CkksParams as JaxParams
from ppqsflhe_tpu.ckks.scheme import CkksScheme as JaxScheme
from ppqsflhe_tpu.ckks.types import Ciphertext as JaxCt
from ppqsflhe_tpu.ckks.types import KeySwitchKey as JaxKsk
from ppqsflhe_tpu.core.modarith import modadd as jax_modadd
from ppqsflhe_tpu.fl.api import _encrypt_batch
from ppqsflhe_tpu_torch import convert
from ppqsflhe_tpu_torch.ckks import eval as ev
from ppqsflhe_tpu_torch.ckks.params import CkksParams
from ppqsflhe_tpu_torch.ckks.scheme import CkksScheme
from ppqsflhe_tpu_torch.ckks.types import Ciphertext
from ppqsflhe_tpu_torch.core import sampling
from ppqsflhe_tpu_torch.fl.api import aggregate_batch, change_cipher_domain_batch, server_round

N = 1 << 11
B = 2          # ciphertexts per client
TOL = 1e-6


def _jax_server_round(sch, s1, s2, k12, k21, scale, lazy):
    """bench.py's server_round (bench.py:178-222) for lazy ∈ {0, …, 4}."""
    L_full = sch.params.num_q
    drop = min(2 if lazy == 2 else min(lazy, 1), L_full - 1)

    def re_enc(d, rk):
        l = d.shape[1]
        q, _, _ = sch.ctx.limb_consts(sch.ctx.q_idx(l))
        d0, d1 = jev.keyswitch(sch.ctx, d[1], JaxKsk(data=rk, mont=True), l)
        return jnp.stack([jax_modadd(d[0], d0, q), d1])

    def agg_pair(d1, d2):
        if drop:
            d1, d2 = d1[:, : L_full - drop], d2[:, : L_full - drop]
        s = jev.add(sch.ctx, JaxCt(re_enc(d1, k12), scale), JaxCt(d2, scale))
        if lazy >= 4:
            avg = JaxCt(s.data[:, :-1], scale)
        elif lazy >= 2:
            avg = s                             # ÷2 is free: scale ×= 2 outside
        else:
            avg = jev.mult_scalar(sch.ctx, s, 0.5)
        return avg.data, re_enc(avg.data, k21)

    return jax.vmap(agg_pair)(s1, s2)


@pytest.fixture(scope="module")
def world():
    jp = JaxParams.generate(n=N, mult_depth=2, scale_bits=40, dnum=2,
                            ntt_backend="fourstep", ntt_impl="mxu")
    js = JaxScheme(jp)
    sch = CkksScheme(convert.params(dataclasses.asdict(jp)), device="cpu")
    k0 = jax.random.PRNGKey(3)
    jsk1, jpk1 = js.keygen(jax.random.fold_in(k0, 1))
    jsk2, jpk2 = js.keygen(jax.random.fold_in(k0, 2))
    sk1 = convert.secret_key(np.asarray(jsk1.s_eval), np.asarray(jsk1.s_int), device="cpu")
    sk2 = convert.secret_key(np.asarray(jsk2.s_eval), np.asarray(jsk2.s_int), device="cpu")
    pk1, pk2 = (convert.public_key(np.asarray(k.data), device="cpu") for k in (jpk1, jpk2))
    # rekeys from the crossed-over JAX keys; both rounds get the same ones
    gen = torch.Generator().manual_seed(5)
    rk12 = ev.ksk_to_mont(sch.ctx, sch.rekey_gen(sk1, pk2, gen))
    rk21 = ev.ksk_to_mont(sch.ctx, sch.rekey_gen(sk2, pk1, gen))
    rng = np.random.default_rng(9)
    v1 = [rng.uniform(-1, 1, js.encoder.slots) for _ in range(B)]
    v2 = [rng.uniform(-1, 1, js.encoder.slots) for _ in range(B)]
    jc1 = _encrypt_batch(js, jpk1, v1, jax.random.fold_in(k0, 5))
    jc2 = _encrypt_batch(js, jpk2, v2, jax.random.fold_in(k0, 6))
    scale = jc1[0].scale
    s1 = np.stack([np.asarray(c.data) for c in jc1])
    s2 = np.stack([np.asarray(c.data) for c in jc2])
    return dict(js=js, sch=sch, jsk1=jsk1, jsk2=jsk2, jpk1=jpk1, sk1=sk1, sk2=sk2, pk1=pk1,
                rk12=rk12, rk21=rk21, v1=v1, v2=v2, s1=s1, s2=s2, scale=scale,
                want=(np.array(v1) + np.array(v2)) / 2)


def _max_err(sch, sk, cts, want):
    return max(float(np.abs(sch.decrypt(sk, Ciphertext(cts.data[i], cts.scale)) - want[i]).max())
               for i in range(cts.data.shape[0]))


@pytest.mark.parametrize("lazy", [4, 0, 1, 2, 3],
                         ids=["lazy4", "full_level", "lazy1", "lazy2", "lazy3"])
def test_server_round_bitequal_to_jax(world, lazy):
    w = world
    js, sch = w["js"], w["sch"]
    k12, k21 = (jnp.asarray(convert.residues_np(k.data)) for k in (w["rk12"], w["rk21"]))
    want_avg, want_back = jax.jit(
        lambda a, b, c, d: _jax_server_round(js, a, b, c, d, w["scale"], lazy))(
        jnp.asarray(w["s1"]), jnp.asarray(w["s2"]), k12, k21)
    c1 = convert.ciphertext(w["s1"], w["scale"], device="cpu")
    c2 = convert.ciphertext(w["s2"], w["scale"], device="cpu")
    avg, back = server_round(sch, c1, c2, w["rk12"], w["rk21"], lazy)
    np.testing.assert_array_equal(convert.residues_np(avg.data), np.asarray(want_avg))
    np.testing.assert_array_equal(convert.residues_np(back.data), np.asarray(want_back))
    # bench.py decrypts at scale·2 wherever ÷2 is scale metadata (lazy ≥ 2)
    assert avg.scale == back.scale == (2 * w["scale"] if lazy >= 2 else w["scale"])
    assert back.nlimbs == {0: 2, 1: 1, 2: 1, 3: 2, 4: 1}[lazy]
    assert _max_err(sch, w["sk2"], avg, w["want"]) < TOL
    assert _max_err(sch, w["sk1"], back, w["want"]) < TOL


def test_jax_ciphertexts_decrypt_in_port(world):
    w = world
    cts = convert.ciphertext(w["s1"], w["scale"], device="cpu")
    assert _max_err(w["sch"], w["sk1"], cts, w["v1"]) < TOL


def test_port_ciphertexts_decrypt_in_jax(world):
    w = world
    vals = np.random.default_rng(4).uniform(-1, 1, 64)
    ct = w["sch"].encrypt_values(w["pk1"], vals, torch.Generator().manual_seed(8))
    d = convert.to_numpy(ct)
    got = np.asarray(w["js"].decrypt(w["jsk1"], JaxCt(jnp.asarray(d["data"]), d["scale"]), num=64))
    assert np.abs(got - vals).max() < TOL


def test_port_rekey_decrypts_in_jax(world):
    """A ciphertext the port re-encrypted to client 2 decrypts under the JAX
    package's secret key of client 2."""
    w = world
    cts = convert.ciphertext(w["s1"][:1], w["scale"], device="cpu")
    moved = change_cipher_domain_batch(w["sch"], w["rk12"], cts)
    d = convert.to_numpy(Ciphertext(moved.data[0], moved.scale))
    got = np.asarray(w["js"].decrypt(w["jsk2"], JaxCt(jnp.asarray(d["data"]), d["scale"])))
    assert np.abs(got - w["v1"][0]).max() < TOL


def test_port_only_round_n4096():
    """The port end to end on its own keys at N=2^12: keygen, rekeys,
    encryption, both schedules, decrypt against the plaintext mean."""
    sch = CkksScheme(CkksParams.generate(n=1 << 12, mult_depth=2, scale_bits=40, dnum=2),
                     device="cpu")
    gen = torch.Generator().manual_seed(1)
    sk1, pk1 = sch.keygen(gen)
    sk2, pk2 = sch.keygen(gen)
    rk12 = ev.ksk_to_mont(sch.ctx, sch.rekey_gen(sk1, pk2, gen))
    rk21 = ev.ksk_to_mont(sch.ctx, sch.rekey_gen(sk2, pk1, gen))
    rng = np.random.default_rng(2)
    v1 = [rng.uniform(-1, 1, sch.encoder.slots) for _ in range(2)]
    v2 = [rng.uniform(-1, 1, sch.encoder.slots) for _ in range(2)]
    c1, c2 = sch.encrypt_values(pk1, v1, gen), sch.encrypt_values(pk2, v2, gen)
    want = (np.array(v1) + np.array(v2)) / 2
    for lazy in (4, 0):
        avg, back = server_round(sch, c1, c2, rk12, rk21, lazy)
        assert _max_err(sch, sk2, avg, want) < TOL
        assert _max_err(sch, sk1, back, want) < TOL
    # aggregate alone: the lazy path only applies to power-of-two client counts
    three = aggregate_batch(sch, [c1, c1, c1], lazy=True)
    assert three.nlimbs == 2 and three.scale == c1.scale
    assert _max_err(sch, sk1, three, v1) < TOL


def test_encoder_and_exact_decode_match_reference(world):
    """The copied encoder gives the JAX encoder's integers, and the port's
    exact (CRT) decode agrees with its limb-0 fast path."""
    from ppqsflhe_tpu_torch.ckks import rlwe

    js, sch = world["js"], world["sch"]
    vals = [np.random.default_rng(6).uniform(-1, 1, js.encoder.slots) for _ in range(2)]
    np.testing.assert_array_equal(sch.encoder.encode_batch(vals, 2.0**40),
                                  js.encoder.encode_batch(vals, 2.0**40))
    ct = Ciphertext(convert.residues(world["s1"][0], "cpu"), world["scale"])
    coeffs = rlwe.decrypt_to_coeffs(sch.ctx, world["sk1"].s_eval, ct)
    fast = rlwe.decode_coeffs(sch.ctx, coeffs, ct, sch.encoder, num=32)
    exact = rlwe.decode_coeffs(sch.ctx, coeffs, ct, sch.encoder, num=32, exact=True)
    np.testing.assert_allclose(exact, fast, atol=1e-12)
    assert np.abs(exact - world["v1"][0][:32]).max() < TOL


def test_convert_round_trips_and_refuses_other_orders():
    """Both evaluation orders and the FLEXIBLEAUTOEXT chain round-trip
    through the JAX fields; an unknown order is refused."""
    p = CkksParams.generate(n=1 << 10)
    assert convert.params(convert.params_fields(p)) == p
    r2 = CkksParams.generate(n=1 << 10, ntt_backend="radix2")
    assert convert.params(convert.params_fields(r2)) == r2
    with pytest.raises(ValueError, match="ntt_backend"):
        convert.params(dict(convert.params_fields(p), ntt_backend="radix4"))
    fx = CkksParams.generate(n=1 << 10, extra_mod_bits=20)
    fields = convert.params_fields(fx)
    assert fields["flexible_ext"] and convert.params(fields) == fx
    assert JaxParams(**fields) == JaxParams.generate(n=1 << 10, extra_mod_bits=20,
                                                     ntt_backend="fourstep",
                                                     ntt_impl=fx.ntt_impl)
    data = np.random.default_rng(0).integers(0, 1 << 63, (2, 3, 8), dtype=np.uint64) * 2 + 1
    ct = convert.ciphertext(data, 3.0, device="cpu")
    assert np.array_equal(convert.to_numpy(ct)["data"], data)
    ksk = convert.to_numpy(convert.keyswitch_key(data[None], mont=True, device="cpu"))
    assert ksk["mont"] and np.array_equal(ksk["data"], data[None])
    sk = convert.to_numpy(convert.secret_key(data[0], np.array([1, -1, 0], np.int8),
                                             device="cpu"))
    assert np.array_equal(sk["s_eval"], data[0]) and list(sk["s_int"]) == [1, -1, 0]


def test_samplers_distribution():
    gen = torch.Generator().manual_seed(0)
    n = 60000
    t = sampling.ternary(gen, n).numpy()
    assert set(np.unique(t)) == {-1, 0, 1}
    assert all(abs(np.mean(t == v) - 1 / 3) < 0.01 for v in (-1, 0, 1))
    g = sampling.discrete_gaussian(gen, n).numpy()
    assert g.dtype == np.int32
    assert abs(g.mean()) < 0.05 and abs(g.std() - sampling.SIGMA) < 0.05
    assert np.abs(g).max() <= len(sampling._cdt_thresholds(sampling.SIGMA))
    assert abs(np.mean(g > 0) - np.mean(g < 0)) < 0.02        # symmetric (5σ)
    u = sampling.uniform_rns(gen, [97, (1 << 59) + 21], n).numpy()
    assert u[0].min() >= 0 and u[0].max() < 97 and u[1].max() < (1 << 59) + 21
    assert abs(np.mean(u[0]) - 48) < 1.0
