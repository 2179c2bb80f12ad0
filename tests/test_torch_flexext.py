"""FLEXIBLEAUTOEXT (``flexible_ext``) in the port against the JAX package.

``CkksParams.generate(extra_mod_bits=20)`` must give the JAX chain bit for
bit (the special primes covering the largest digit), fresh full-level
plaintexts must encode at Δ·q_ext to the JAX residues, and the automatic
drop of the extension limb before ``mult``, ``mult_scalar`` and
``mult_plain`` must give the JAX scheme's residues on the same (JAX-made)
ciphertexts. The twins of ``tests/test_ckks.py::test_flexext_*`` hold the
decrypted values to that file's gates. The key switch on the 4-tower chain
(L=4, LK=6, the 20-bit limb beside the 60- and 40-bit ones) is bit-equal to
the JAX ``ev.keyswitch`` in both evaluation orders. All at N=256 on the
CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppqsflhe_tpu.ckks import eval as jev
from ppqsflhe_tpu.ckks import serialize as jser
from ppqsflhe_tpu.ckks.params import CkksParams as JaxParams
from ppqsflhe_tpu.ckks.scheme import CkksScheme as JaxScheme
from ppqsflhe_tpu.ckks.types import Ciphertext as JaxCt
from ppqsflhe_tpu.ckks.types import KeySwitchKey as JaxKsk
from ppqsflhe_tpu_torch import convert
from ppqsflhe_tpu_torch.ckks import eval as ev
from ppqsflhe_tpu_torch.ckks import serialize as ser
from ppqsflhe_tpu_torch.ckks.params import CkksParams
from ppqsflhe_tpu_torch.ckks.scheme import CkksScheme
from ppqsflhe_tpu_torch.ckks.types import KeySwitchKey

N = 256


def _u(t):
    return convert.residues_np(t.data if hasattr(t, "data") else t)


def _ct(jct):
    return convert.ciphertext(np.asarray(jct.data), jct.scale, device="cpu")


@pytest.fixture(scope="module")
def world():
    """The JAX test's scheme (radix-2 at N=256), its keys crossed over, and
    two JAX encryptions of uniform(−1, 1) vectors."""
    jp = JaxParams.generate(n=N, mult_depth=2, scale_bits=40, dnum=2, extra_mod_bits=20)
    js = JaxScheme(jp)
    sch = CkksScheme(convert.params(dataclasses.asdict(jp)), device="cpu")
    jsk, jpk = js.keygen(jax.random.PRNGKey(90))
    jrk = js.relin_key_gen(jsk, jax.random.PRNGKey(93))
    rng = np.random.default_rng(92)
    v1, v2 = (rng.uniform(-1, 1, js.encoder.slots) for _ in range(2))
    jc1 = js.encrypt_values(jpk, v1, jax.random.PRNGKey(94))
    jc2 = js.encrypt_values(jpk, v2, jax.random.PRNGKey(95))
    return dict(js=js, sch=sch, jsk=jsk, jpk=jpk, jrk=jrk, v1=v1, v2=v2, jc1=jc1, jc2=jc2,
                sk=convert.secret_key(np.asarray(jsk.s_eval), np.asarray(jsk.s_int), "cpu"),
                pk=convert.public_key(np.asarray(jpk.data), "cpu"),
                rk=convert.keyswitch_key(np.asarray(jrk.data), jrk.mont, "cpu"))


@pytest.mark.parametrize("n,depth,dnum", [(256, 2, 2), (1 << 12, 2, 2), (1 << 14, 2, 2),
                                          (1 << 14, 3, 3)])
def test_generate_extra_prime_bit_equal(n, depth, dnum):
    jp = JaxParams.generate(n=n, mult_depth=depth, scale_bits=40, dnum=dnum,
                            extra_mod_bits=20)
    p = CkksParams.generate(n=n, mult_depth=depth, scale_bits=40, dnum=dnum, extra_mod_bits=20)
    assert p.flexible_ext and jp.flexible_ext
    assert (p.q_moduli, p.p_moduli) == (jp.q_moduli, jp.p_moduli)
    assert p.q_moduli[-1].bit_length() == 20 and p.num_q == depth + 2
    # the special primes cover the largest digit of the extended chain
    alpha = -(-p.num_q // dnum)
    digits = [p.q_moduli[i:i + alpha] for i in range(0, p.num_q, alpha)]
    assert sum(q.bit_length() for q in p.p_moduli) >= max(
        sum(q.bit_length() for q in d) for d in digits)
    assert convert.params(convert.params_fields(p)) == p
    assert not CkksParams.generate(n=n, mult_depth=depth, dnum=dnum).flexible_ext


def test_params_document_round_trips(world):
    """The CC document of a FLEXIBLEAUTOEXT chain re-emits byte for byte
    and loads in both packages."""
    jp = world["js"].params
    d = jser.params_to_dict(jp)
    assert d["flexible_ext"] is True
    p = ser.params_from_dict(d)
    assert p.flexible_ext and ser.params_to_dict(p) == d
    assert jser.params_from_dict(ser.params_to_dict(p)) == jp


def test_make_plaintext_bit_equal(world):
    """Full level at Δ·q_ext, lower levels at Δ, both at the largest
    magnitude the JAX tests encode (|v| = 1 in every slot) and on uniform
    values."""
    js, sch = world["js"], world["sch"]
    slots = js.encoder.slots
    for v in (world["v1"], np.ones(slots), -np.ones(slots), np.array([0.5, -1.0, 1.0])):
        for l in (None, 3, 2, 1):
            jpt, pt = js.make_plaintext(v, l), sch.make_plaintext(v, l)
            np.testing.assert_array_equal(_u(pt), np.asarray(jpt.data))
            assert pt.scale == jpt.scale
    assert sch.make_plaintext(world["v1"]).scale == 2.0**40 * sch.params.q_moduli[-1]
    assert sch.make_plaintext(world["v1"], 3).scale == 2.0**40


def test_flexext_fresh_roundtrip(world):
    """Twin of tests/test_ckks.py::test_flexext_fresh_roundtrip: the port's
    own encryption at the extension level, and the JAX one, decrypt."""
    sch = world["sch"]
    ct = sch.encrypt_values(world["pk"], world["v1"], torch.Generator().manual_seed(91))
    assert ct.nlimbs == 4 and ct.scale > 2.0**55        # Δ·q_ext
    np.testing.assert_allclose(sch.decrypt(world["sk"], ct), world["v1"], atol=1e-6)
    np.testing.assert_allclose(sch.decrypt(world["sk"], _ct(world["jc1"])), world["v1"],
                               atol=1e-6)
    got = world["js"].decrypt(world["jsk"], JaxCt(jnp.asarray(_u(ct)), ct.scale))
    np.testing.assert_allclose(np.asarray(got), world["v1"], atol=1e-6)


def test_flexext_depth2(world):
    """Twin of test_flexext_depth2: mult drops the extension limb of both
    operands, multiplies and rescales; mult_scalar takes the second level.
    Both bit-equal to the JAX scheme."""
    js, sch = world["js"], world["sch"]
    jprod = js.mult(world["jc1"], world["jc2"], world["jrk"])
    prod = sch.mult(_ct(world["jc1"]), _ct(world["jc2"]), world["rk"])
    assert prod.nlimbs == 2 and prod.scale == jprod.scale
    np.testing.assert_array_equal(_u(prod), np.asarray(jprod.data))
    jout = js.mult_scalar(jprod, 0.25)
    out = sch.mult_scalar(prod, 0.25)
    assert out.nlimbs == 1 and out.scale == jout.scale
    np.testing.assert_array_equal(_u(out), np.asarray(jout.data))
    np.testing.assert_allclose(sch.decrypt(world["sk"], out), world["v1"] * world["v2"] * 0.25,
                               atol=1e-3)


def test_flexext_fedavg(world):
    """Twin of test_flexext_fedavg: add at the extension level, then
    EvalMult(·, 0.5) drops it."""
    js, sch = world["js"], world["sch"]
    javg = js.mult_scalar(js.add(world["jc1"], world["jc2"]), 0.5)
    avg = sch.mult_scalar(sch.add(_ct(world["jc1"]), _ct(world["jc2"])), 0.5)
    assert avg.nlimbs == 2 and avg.scale == javg.scale
    np.testing.assert_array_equal(_u(avg), np.asarray(javg.data))
    np.testing.assert_allclose(sch.decrypt(world["sk"], avg), (world["v1"] + world["v2"]) / 2,
                               atol=1e-5)


def test_flexext_mult_plain(world):
    """mult_plain drops the extension limb first too; a plaintext below the
    full level is encoded at Δ."""
    js, sch = world["js"], world["sch"]
    jpt, pt = js.make_plaintext(world["v2"], 3), sch.make_plaintext(world["v2"], 3)
    jout = js.mult_plain(world["jc1"], jpt)
    out = sch.mult_plain(_ct(world["jc1"]), pt)
    assert out.nlimbs == 2 and out.scale == jout.scale
    np.testing.assert_array_equal(_u(out), np.asarray(jout.data))
    np.testing.assert_allclose(sch.decrypt(world["sk"], out), world["v1"] * world["v2"],
                               atol=1e-4)
    # below the extension level nothing is dropped
    low = sch.mult_scalar(_ct(world["jc1"]), 1.0)
    assert sch._maybe_drop_ext(low) is low


@pytest.mark.parametrize("backend,impl", [("fourstep", "mxu"), ("radix2", "xla")])
def test_keyswitch_4tower_bit_equal(backend, impl):
    """The key switch at full level on the 4-tower chain (60/40/40 + 20-bit;
    two digits {q0, q1}, {q2, q3}; LK = 6) with a Montgomery-form key, as
    bench_kernels.py:134-221 runs it, bit-equal to the JAX ev.keyswitch."""
    jp = JaxParams.generate(n=N, mult_depth=2, scale_bits=40, dnum=2, extra_mod_bits=20,
                            ntt_backend=backend, ntt_impl=impl)
    js = JaxScheme(jp)
    sch = CkksScheme(convert.params(dataclasses.asdict(jp)), device="cpu")
    L, LK = jp.num_q, len(js.ctx.moduli_qp)
    nd = len(js.ctx.digit_groups)
    assert (L, LK, nd) == (4, 6, 2) and sch.ctx.digit_groups == ((0, 1), (2, 3))
    rng = np.random.default_rng(0)
    qs = np.array(jp.q_moduli, np.uint64)
    c = rng.integers(0, 1 << 59, size=(3, L, N), dtype=np.uint64) % qs[None, :, None]
    rk = rng.integers(0, 1 << 59, size=(nd, 2, LK, N), dtype=np.uint64) \
        % np.array(js.ctx.moduli_qp, np.uint64)[None, None, :, None]
    jrk = jev.ksk_to_mont(js.ctx, JaxKsk(data=jnp.asarray(rk)))
    want = jax.jit(jax.vmap(lambda ci: jnp.stack(jev.keyswitch(js.ctx, ci, jrk, L))))(
        jnp.asarray(c))
    prk = ev.ksk_to_mont(sch.ctx, KeySwitchKey(data=convert.residues(rk, "cpu")))
    np.testing.assert_array_equal(_u(prk.data), np.asarray(jrk.data))
    d0, d1 = ev.keyswitch(sch.ctx, convert.residues(c, "cpu"), prk, L)
    np.testing.assert_array_equal(_u(torch.stack([d0, d1], dim=1)), np.asarray(want))
