"""The butterfly configuration of the server round against the JAX package:
the port's ``server_round`` with ``ntt_impl="pallas"`` (every NTT through
kernel 6's plain version) gives, bit for bit, the residues of the JAX round
with ``ntt_impl="xla"`` (kernel 6's own plain body, ``pallas_ntt.py:10-11``;
a Mosaic call cannot run on the CPU) in both schedules, at N=256. Keys and
ciphertexts come from the JAX package's digit-matmul scheme: every four-step
implementation gives the same evaluations."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppqsflhe_tpu.ckks.params import CkksParams as JaxParams
from ppqsflhe_tpu.ckks.scheme import CkksScheme as JaxScheme
from ppqsflhe_tpu.fl.api import _encrypt_batch
from ppqsflhe_tpu_torch import convert
from ppqsflhe_tpu_torch.ckks import eval as ev
from ppqsflhe_tpu_torch.ckks.scheme import CkksScheme
from ppqsflhe_tpu_torch.ckks.types import Ciphertext
from ppqsflhe_tpu_torch.fl.api import server_round
from ppqsflhe_tpu_torch.ops.cuda_ntt import BUTTERFLY
from test_torch_slice import _jax_server_round

TOL = 1e-6


@pytest.fixture(scope="module")
def bfly_world():
    """Keys and ciphertexts from the JAX package at N=256, its scheme with
    ntt_impl="xla", and the port's scheme in the butterfly configuration."""
    jp = JaxParams.generate(n=256, mult_depth=2, scale_bits=40, dnum=2,
                            ntt_backend="fourstep", ntt_impl="mxu")
    js = JaxScheme(jp)
    jx = JaxScheme(dataclasses.replace(jp, ntt_impl="xla"))
    sch = CkksScheme(convert.params(dataclasses.asdict(jp) | {"ntt_impl": "pallas"}),
                     device="cpu")
    k0 = jax.random.PRNGKey(4)
    jsk1, jpk1 = js.keygen(jax.random.fold_in(k0, 1))
    jsk2, jpk2 = js.keygen(jax.random.fold_in(k0, 2))
    sk1, sk2 = (convert.secret_key(np.asarray(k.s_eval), np.asarray(k.s_int), device="cpu")
                for k in (jsk1, jsk2))
    pk1, pk2 = (convert.public_key(np.asarray(k.data), device="cpu") for k in (jpk1, jpk2))
    gen = torch.Generator().manual_seed(6)
    rk12 = ev.ksk_to_mont(sch.ctx, sch.rekey_gen(sk1, pk2, gen))
    rk21 = ev.ksk_to_mont(sch.ctx, sch.rekey_gen(sk2, pk1, gen))
    rng = np.random.default_rng(10)
    v1 = [rng.uniform(-1, 1, js.encoder.slots) for _ in range(2)]
    v2 = [rng.uniform(-1, 1, js.encoder.slots) for _ in range(2)]
    jc1 = _encrypt_batch(js, jpk1, v1, jax.random.fold_in(k0, 5))
    jc2 = _encrypt_batch(js, jpk2, v2, jax.random.fold_in(k0, 6))
    return dict(jx=jx, sch=sch, sk1=sk1, sk2=sk2, rk12=rk12, rk21=rk21, scale=jc1[0].scale,
                s1=np.stack([np.asarray(c.data) for c in jc1]),
                s2=np.stack([np.asarray(c.data) for c in jc2]),
                want=(np.array(v1) + np.array(v2)) / 2)


@pytest.mark.parametrize("lazy", [4, 0], ids=["lazy4", "full_level"])
def test_butterfly_round_bitequal_to_jax(bfly_world, lazy):
    """The N=256 round in the butterfly configuration gives the JAX round's
    residues in both schedules (the JAX side run eagerly: its XLA four-step
    transform compiles slowly under jit), and decrypts to the mean."""
    w = bfly_world
    assert w["sch"].params.ntt_impl == BUTTERFLY
    k12, k21 = (jnp.asarray(convert.residues_np(k.data)) for k in (w["rk12"], w["rk21"]))
    want_avg, want_back = _jax_server_round(w["jx"], jnp.asarray(w["s1"]), jnp.asarray(w["s2"]),
                                            k12, k21, w["scale"], lazy)
    c1 = convert.ciphertext(w["s1"], w["scale"], device="cpu")
    c2 = convert.ciphertext(w["s2"], w["scale"], device="cpu")
    avg, back = server_round(w["sch"], c1, c2, w["rk12"], w["rk21"], lazy)
    np.testing.assert_array_equal(convert.residues_np(avg.data), np.asarray(want_avg))
    np.testing.assert_array_equal(convert.residues_np(back.data), np.asarray(want_back))
    for sk, ct in ((w["sk2"], avg), (w["sk1"], back)):
        for i in range(ct.data.shape[0]):
            got = w["sch"].decrypt(sk, Ciphertext(ct.data[i], ct.scale))
            assert np.abs(got - w["want"][i]).max() < TOL
