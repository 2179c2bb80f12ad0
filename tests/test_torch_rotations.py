"""The port's rotation path against the JAX package on a small four-step
("mxu") chain: keys and ciphertexts made by the JAX package cross over
through ``convert``, and the port's Galois permutations, ``rotate``,
``rotate_hoisted``, ``rotate_sum_hoisted``, ``conjugate`` and ``mult`` with
relinearization must give the JAX package's residues bit for bit. Keys the
port generates must decrypt correctly in both packages. Decrypted values are
held to the JAX package's own gates (tests/test_ckks.py): 1e-4 for a
rotation or product at N=256, 1e-3 for a rotation sum and the inner product.
The JAX side runs eagerly (its ``ckks.eval``/``ckks.rlwe`` functions, not the
scheme's per-op jit), which keeps this file's compile time short.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppqsflhe_tpu.ckks import eval as jev
from ppqsflhe_tpu.ckks import rlwe as jrlwe
from ppqsflhe_tpu.ckks.params import CkksParams as JaxParams
from ppqsflhe_tpu.ckks.scheme import CkksScheme as JaxScheme
from ppqsflhe_tpu.ckks.types import Ciphertext as JaxCt
from ppqsflhe_tpu.ckks.types import KeySwitchKey as JaxKsk
from ppqsflhe_tpu_torch import convert
from ppqsflhe_tpu_torch.ckks import eval as ev
from ppqsflhe_tpu_torch.ckks.scheme import CkksScheme
from ppqsflhe_tpu_torch.ckks.types import Ciphertext

N = 256
ROTS = [1, 2, 5, -3]
TOL = 1e-4


@pytest.fixture(scope="module")
def world():
    jp = JaxParams.generate(n=N, mult_depth=2, scale_bits=40, dnum=2,
                            ntt_backend="fourstep", ntt_impl="mxu")
    js = JaxScheme(jp)
    sch = CkksScheme(convert.params(dataclasses.asdict(jp)), device="cpu")
    ctx, L = js.ctx, jp.num_q
    k0 = jax.random.PRNGKey(11)
    jsk, jpk = jrlwe.keygen(ctx, jax.random.fold_in(k0, 1))

    def galois_key(g, i):
        s_g = jev.automorphism(ctx, jsk.s_eval[:L], g)
        return jev.keyswitch_key_gen(ctx, s_g, jax.random.fold_in(k0, i), sk_to=jsk)

    jrot = {r: galois_key(jev.rot_to_galois(r, N), 10 + i) for i, r in enumerate(ROTS)}
    jconj = galois_key(2 * N - 1, 3)
    s = jsk.s_eval[:L]
    jrelin = jev.keyswitch_key_gen(ctx, jrlwe._poly_mul(ctx, s, s, tuple(range(L))),
                                   jax.random.fold_in(k0, 4), sk_to=jsk)
    rng = np.random.default_rng(12)
    v1, v2 = (rng.uniform(-1, 1, js.encoder.slots) for _ in range(2))
    jc1, jc2 = (jrlwe.encrypt(ctx, jpk, js.make_plaintext(v), jax.random.fold_in(k0, i))
                for i, v in ((5, v1), (6, v2)))
    return dict(
        js=js, sch=sch, jsk=jsk, jpk=jpk, jrot=jrot, jconj=jconj, jrelin=jrelin,
        jc1=jc1, jc2=jc2, v1=v1, v2=v2,
        sk=convert.secret_key(np.asarray(jsk.s_eval), np.asarray(jsk.s_int), device="cpu"),
        pk=convert.public_key(np.asarray(jpk.data), device="cpu"),
        rot=convert.rotation_keys({r: np.asarray(k.data) for r, k in jrot.items()},
                                  device="cpu"),
        conj=convert.keyswitch_key(np.asarray(jconj.data), device="cpu"),
        relin=convert.keyswitch_key(np.asarray(jrelin.data), device="cpu"),
        c1=convert.ciphertext(np.asarray(jc1.data), jc1.scale, device="cpu"),
        c2=convert.ciphertext(np.asarray(jc2.data), jc2.scale, device="cpu"))


def _same(port_ct, jax_ct):
    np.testing.assert_array_equal(convert.residues_np(port_ct.data), np.asarray(jax_ct.data))
    assert port_ct.scale == jax_ct.scale


def _to_jax(ct):
    d = convert.to_numpy(ct)
    return JaxCt(data=jnp.asarray(d["data"]), scale=d["scale"])


def _jdec(w, ct):
    return np.asarray(jrlwe.decrypt(w["js"].ctx, w["jsk"], ct, w["js"].encoder))


def test_galois_perm_matches_reference(world):
    """The kernel-order-corrected permutation equals the JAX context's for
    rotations, a negative rotation and conjugation, and is cached."""
    js, ctx = world["js"], world["sch"].ctx
    gs = [ev.rot_to_galois(r, N) for r in (1, 2, 7, -3, 64)] + [2 * N - 1]
    for g in gs:
        np.testing.assert_array_equal(ctx.galois_perm(g, "cpu").numpy(), js.ctx.galois_perm(g))
        assert ctx.galois_perm(g, "cpu") is ctx.galois_perm(g, "cpu")
    assert ev.rot_to_galois(-3, N) == jev.rot_to_galois(-3, N)
    np.testing.assert_array_equal(ev._galois_perm(N, 5), jev._galois_perm(N, 5))


def test_rotate_bitequal_to_jax(world):
    w = world
    for r in ROTS:
        got = w["sch"].rotate(w["c1"], r, w["rot"])
        _same(got, jev.rotate(w["js"].ctx, w["jc1"], r, w["jrot"][r]))
        assert np.abs(w["sch"].decrypt(w["sk"], got) - np.roll(w["v1"], -r)).max() < TOL


def test_rotate_hoisted_bitequal_to_jax_and_plain(world):
    w = world
    got = w["sch"].rotate_hoisted(w["c1"], ROTS, w["rot"])
    want = jev.rotate_hoisted(w["js"].ctx, w["jc1"], ROTS, w["jrot"])
    for r, g, j in zip(ROTS, got, want):
        _same(g, j)
        assert torch.equal(g.data, w["sch"].rotate(w["c1"], r, w["rot"]).data)


def test_rotate_sum_hoisted_bitequal_to_jax(world):
    w = world
    got = w["sch"].rotate_sum_hoisted(w["c1"], ROTS, w["rot"])
    _same(got, jev.rotate_sum_hoisted(w["js"].ctx, w["jc1"], ROTS, w["jrot"]))
    want = sum(np.roll(w["v1"], -r) for r in ROTS)
    assert np.abs(w["sch"].decrypt(w["sk"], got) - want).max() < 1e-3


def test_conjugate_bitequal_to_jax(world):
    w = world
    got = w["sch"].conjugate(w["c1"], w["conj"])
    _same(got, jev.conjugate(w["js"].ctx, w["jc1"], w["jconj"]))
    assert np.abs(w["sch"].decrypt(w["sk"], got) - w["v1"]).max() < TOL   # real: conj == id


def test_mult_relinearize_bitequal_to_jax(world):
    w = world
    got = w["sch"].mult(w["c1"], w["c2"], w["relin"])
    _same(got, jev.mult(w["js"].ctx, w["jc1"], w["jc2"], w["jrelin"]))
    assert got.num_components == 2 and got.nlimbs == w["c1"].nlimbs - 1
    assert np.abs(w["sch"].decrypt(w["sk"], got) - w["v1"] * w["v2"]).max() < TOL
    # without a relin key: three components, decrypted with (1, s, s²)
    raw = ev.mult(w["sch"].ctx, w["c1"], w["c2"])
    assert raw.num_components == 3
    assert np.abs(w["sch"].decrypt(w["sk"], raw) - w["v1"] * w["v2"]).max() < TOL


def test_batched_ciphertexts_ride_through(world):
    """A leading batch dimension gives each ciphertext's own result."""
    w = world
    both = Ciphertext(torch.stack([w["c1"].data, w["c2"].data]), w["c1"].scale)
    got = w["sch"].rotate(both, 2, w["rot"])
    for i, c in enumerate((w["c1"], w["c2"])):
        assert torch.equal(got.data[i], w["sch"].rotate(c, 2, w["rot"]).data)
    hoisted = w["sch"].rotate_hoisted(both, [1, 5], w["rot"])
    for r, h in zip([1, 5], hoisted):
        assert torch.equal(h.data[1], w["sch"].rotate(w["c2"], r, w["rot"]).data)


def test_port_keys_decrypt_in_both_packages(world):
    """Rotation, conjugation and relin keys that the port generates from the
    crossed-over secret work in the port and, carried back, in the JAX
    package."""
    w = world
    sch, jctx = w["sch"], w["js"].ctx
    gen = torch.Generator().manual_seed(21)
    rot = sch.rotation_key_gen(w["sk"], [3, -1], gen)
    conj = sch.conjugation_key_gen(w["sk"], gen)
    relin = sch.relin_key_gen(w["sk"], gen)
    jrot = {r: JaxKsk(data=jnp.asarray(d["data"])) for r, d in convert.to_numpy(rot).items()}
    for r in (3, -1):
        want = np.roll(w["v1"], -r)
        assert np.abs(sch.decrypt(w["sk"], sch.rotate(w["c1"], r, rot)) - want).max() < TOL
        got = _jdec(w, jev.rotate(jctx, w["jc1"], r, jrot[r]))
        assert np.abs(got - want).max() < TOL
    jconj = JaxKsk(data=jnp.asarray(convert.to_numpy(conj)["data"]))
    assert np.abs(_jdec(w, jev.conjugate(jctx, w["jc1"], jconj)) - w["v1"]).max() < TOL
    jrelin = JaxKsk(data=jnp.asarray(convert.to_numpy(relin)["data"]))
    prod = w["v1"] * w["v2"]
    assert np.abs(sch.decrypt(w["sk"], sch.mult(w["c1"], w["c2"], relin)) - prod).max() < TOL
    got = _jdec(w, jev.mult(jctx, w["jc1"], w["jc2"], jrelin))
    assert np.abs(got - prod).max() < TOL
    # a port key on a port-encrypted ciphertext, decrypted by the JAX package
    ct = sch.encrypt_values(w["pk"], w["v2"], gen)
    got = _jdec(w, _to_jax(sch.rotate(ct, 3, rot)))
    assert np.abs(got - np.roll(w["v2"], -3)).max() < TOL


def test_inner_product_port_only():
    """The packed inner product on the port's own keys (relin key and the
    power-of-two rotations below the slot count) decrypts to np.dot within
    1e-3 in every slot, tests/test_ckks.py's gate."""
    from ppqsflhe_tpu_torch.ckks.params import CkksParams

    sch = CkksScheme(CkksParams.generate(n=N, mult_depth=2, scale_bits=40, dnum=2),
                     device="cpu")
    gen = torch.Generator().manual_seed(31)
    sk, pk = sch.keygen(gen)
    slots = sch.encoder.slots
    rots = [1 << i for i in range(int(np.log2(slots)))]
    rot = {r: ev.ksk_to_mont(sch.ctx, k)
           for r, k in sch.rotation_key_gen(sk, rots, gen).items()}
    relin = sch.relin_key_gen(sk, gen)
    rng = np.random.default_rng(32)
    v1, v2 = rng.uniform(-1, 1, slots) * 0.1, rng.uniform(-1, 1, slots) * 0.1
    out = sch.inner_product(sch.encrypt_values(pk, v1, gen), sch.encrypt_values(pk, v2, gen),
                            relin, rot)
    assert np.abs(sch.decrypt(sk, out) - np.dot(v1, v2)).max() < 1e-3


def test_convert_rotation_keys_round_trip():
    data = np.random.default_rng(0).integers(0, 1 << 62, (2, 2, 3, 8), dtype=np.uint64)
    keys = convert.rotation_keys({"1": data, -2: data + 1}, mont=True, device="cpu")
    assert set(keys) == {1, -2} and all(k.mont for k in keys.values())
    back = convert.to_numpy(keys)
    assert np.array_equal(back[1]["data"], data) and np.array_equal(back[-2]["data"], data + 1)
