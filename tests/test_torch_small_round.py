"""``bench.py``'s server round at N = 2^8 (n1 = n2 = 16: kernel 1's m = 16
instances on the card) against the JAX package on the CPU, in both
schedules: on keys and ciphertexts the JAX package made, the port's
``server_round`` equals the same round composed from the JAX package bit
for bit (exact residues, tolerance 0) and decrypts to the mean within 1e-6
at Δ = 2^40."""

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
from ppqsflhe_tpu_torch.ckks.scheme import CkksScheme
from ppqsflhe_tpu_torch.ckks.types import Ciphertext
from ppqsflhe_tpu_torch.fl.api import server_round

N_ROUND = 1 << 8
B = 2            # ciphertexts per client
TOL = 1e-6


def _jax_server_round(sch, s1, s2, k12, k21, scale, lazy):
    """bench.py's server_round (bench.py:178-222) for lazy ∈ {0, 4}."""
    L_full = sch.params.num_q
    drop = min(lazy, 1, L_full - 1)

    def re_enc(d, rk):
        q, _, _ = sch.ctx.limb_consts(sch.ctx.q_idx(d.shape[1]))
        d0, d1 = jev.keyswitch(sch.ctx, d[1], JaxKsk(data=rk, mont=True), d.shape[1])
        return jnp.stack([jax_modadd(d[0], d0, q), d1])

    def agg_pair(d1, d2):
        if drop:
            d1, d2 = d1[:, : L_full - drop], d2[:, : L_full - drop]
        s = jev.add(sch.ctx, JaxCt(re_enc(d1, k12), scale), JaxCt(d2, scale))
        avg = JaxCt(s.data[:, :-1], scale) if lazy else jev.mult_scalar(sch.ctx, s, 0.5)
        return avg.data, re_enc(avg.data, k21)

    return jax.vmap(agg_pair)(s1, s2)


@pytest.fixture(scope="module")
def world():
    jp = JaxParams.generate(n=N_ROUND, mult_depth=2, scale_bits=40, dnum=2,
                            ntt_backend="fourstep", ntt_impl="mxu")
    js = JaxScheme(jp)
    sch = CkksScheme(convert.params(dataclasses.asdict(jp)), device="cpu")
    k0 = jax.random.PRNGKey(13)
    jsk1, jpk1 = js.keygen(jax.random.fold_in(k0, 1))
    jsk2, jpk2 = js.keygen(jax.random.fold_in(k0, 2))
    sk1 = convert.secret_key(np.asarray(jsk1.s_eval), np.asarray(jsk1.s_int), device="cpu")
    sk2 = convert.secret_key(np.asarray(jsk2.s_eval), np.asarray(jsk2.s_int), device="cpu")
    pk1, pk2 = (convert.public_key(np.asarray(k.data), device="cpu") for k in (jpk1, jpk2))
    gen = torch.Generator().manual_seed(15)
    rk12 = ev.ksk_to_mont(sch.ctx, sch.rekey_gen(sk1, pk2, gen))
    rk21 = ev.ksk_to_mont(sch.ctx, sch.rekey_gen(sk2, pk1, gen))
    rng = np.random.default_rng(19)
    v1 = [rng.uniform(-1, 1, js.encoder.slots) for _ in range(B)]
    v2 = [rng.uniform(-1, 1, js.encoder.slots) for _ in range(B)]
    jc1 = _encrypt_batch(js, jpk1, v1, jax.random.fold_in(k0, 5))
    jc2 = _encrypt_batch(js, jpk2, v2, jax.random.fold_in(k0, 6))
    return dict(js=js, sch=sch, sk1=sk1, sk2=sk2, rk12=rk12, rk21=rk21, scale=jc1[0].scale,
                s1=np.stack([np.asarray(c.data) for c in jc1]),
                s2=np.stack([np.asarray(c.data) for c in jc2]),
                want=(np.array(v1) + np.array(v2)) / 2)


def _max_err(sch, sk, cts, want):
    return max(float(np.abs(sch.decrypt(sk, Ciphertext(cts.data[i], cts.scale)) - want[i]).max())
               for i in range(cts.data.shape[0]))


@pytest.mark.parametrize("lazy", [4, 0], ids=["lazy4", "full_level"])
def test_server_round_at_n256_equals_jax(world, lazy):
    """bench.py's round at N = 2^8 (n1 = n2 = 16) on the JAX package's keys
    and ciphertexts: the port's ``server_round`` equals the JAX composition
    bit for bit and decrypts to the mean."""
    w = world
    k12, k21 = (jnp.asarray(convert.residues_np(k.data)) for k in (w["rk12"], w["rk21"]))
    want_avg, want_back = jax.jit(
        lambda a, b, c, d: _jax_server_round(w["js"], a, b, c, d, w["scale"], lazy))(
        jnp.asarray(w["s1"]), jnp.asarray(w["s2"]), k12, k21)
    c1 = convert.ciphertext(w["s1"], w["scale"], device="cpu")
    c2 = convert.ciphertext(w["s2"], w["scale"], device="cpu")
    avg, back = server_round(w["sch"], c1, c2, w["rk12"], w["rk21"], lazy)
    np.testing.assert_array_equal(convert.residues_np(avg.data), np.asarray(want_avg))
    np.testing.assert_array_equal(convert.residues_np(back.data), np.asarray(want_back))
    assert _max_err(w["sch"], w["sk2"], avg, w["want"]) < TOL
    assert _max_err(w["sch"], w["sk1"], back, w["want"]) < TOL
