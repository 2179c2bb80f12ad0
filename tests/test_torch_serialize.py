"""The port's serializer against the JAX package's: every document and blob
either package writes, the other reads to the same residues, and
re-emitting it gives the same bytes — the CC document, secret keys, public
keys and key-switch keys (dense and seeded), the PQTC ciphertext blobs v1,
v2 and v3, and the PQWD container. The seed expansion is bit-equal in both
evaluation orders (radix-2 at N=128, four-step at N=256)."""

import base64
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from ppqsflhe_tpu.ckks import eval as jev
from ppqsflhe_tpu.ckks import rlwe as jrlwe
from ppqsflhe_tpu.ckks import serialize as jser
from ppqsflhe_tpu.ckks.params import CkksParams as JaxParams
from ppqsflhe_tpu.ckks.scheme import CkksScheme as JaxScheme
from ppqsflhe_tpu.ckks.types import Ciphertext as JaxCt
from ppqsflhe_tpu_torch import convert
from ppqsflhe_tpu_torch.ckks import eval as ev
from ppqsflhe_tpu_torch.ckks import rlwe
from ppqsflhe_tpu_torch.ckks import serialize as ser
from ppqsflhe_tpu_torch.ckks.scheme import CkksScheme

SEED = bytes(range(16))


def _u(t):
    return convert.residues_np(t)


@pytest.fixture(scope="module", params=[("radix2", 128, "xla"), ("fourstep", 256, "mxu")],
                ids=["radix2", "fourstep"])
def world(request):
    backend, n, impl = request.param
    jp = JaxParams.generate(n=n, mult_depth=2, scale_bits=40, dnum=2, ntt_backend=backend,
                            ntt_impl=impl)
    js = JaxScheme(jp)
    sch = CkksScheme(ser.params_from_dict(jser.params_to_dict(jp)), device="cpu")
    jsk, jpk = js.keygen(jax.random.PRNGKey(1), a_seed=SEED)
    sk = ser.deserialize_secret_key(jser.serialize_secret_key(jsk), sch.ctx, "cpu")
    return dict(jp=jp, js=js, sch=sch, jsk=jsk, jpk=jpk, sk=sk)


def test_params_documents_cross(world, tmp_path):
    """CC documents re-emit byte for byte both ways; a document without
    ntt_backend reads as radix-2, like the JAX reader."""
    jp, sch = world["jp"], world["sch"]
    for p in (jp, dataclasses.replace(jp, pre_mode="INDCCA", pre_flood_bits=20)):
        jser.save_params(p, tmp_path / "j.json")
        q = ser.load_params(tmp_path / "j.json")
        ser.save_params(q, tmp_path / "t.json")
        assert (tmp_path / "j.json").read_bytes() == (tmp_path / "t.json").read_bytes()
        assert jser.load_params(tmp_path / "t.json") == p
        assert (q.ntt_backend, q.ntt_impl, q.pre_mode) == (p.ntt_backend, p.ntt_impl, p.pre_mode)
    d = jser.params_to_dict(jp)
    del d["ntt_backend"]
    assert ser.params_from_dict(d).ntt_backend == "radix2"
    # a FLEXIBLEAUTOEXT document loads with the mode on and re-emits it
    fx = ser.params_from_dict(dict(d, flexible_ext=True))
    assert fx.flexible_ext and ser.params_to_dict(fx)["flexible_ext"] is True
    assert ser.params_to_dict(sch.params) == jser.params_to_dict(jp)


def test_expand_a_bit_equal(world):
    js, sch = world["js"], world["sch"]
    seeds = [SEED, bytes(16), b"\xff" * 16]
    L = sch.params.num_q
    want = np.asarray(jrlwe.expand_a_batch(js.ctx, seeds, L))
    np.testing.assert_array_equal(_u(rlwe.expand_a_batch(sch.ctx, seeds, L, "cpu")), want)
    np.testing.assert_array_equal(_u(rlwe.expand_a(sch.ctx, seeds[1], L, "cpu")), want[1])
    LK = len(sch.ctx.moduli_qp)
    np.testing.assert_array_equal(_u(rlwe.expand_a(sch.ctx, SEED, LK, "cpu")),
                                  np.asarray(jrlwe.expand_a(js.ctx, SEED, LK)))
    with pytest.raises(ValueError, match="16 bytes"):
        rlwe.expand_a(sch.ctx, b"short", L, "cpu")


def test_secret_and_public_keys_cross(world):
    w = world
    js, sch, jsk, jpk, sk = w["js"], w["sch"], w["jsk"], w["jpk"], w["sk"]
    np.testing.assert_array_equal(_u(sk.s_eval), np.asarray(jsk.s_eval))
    assert ser.serialize_secret_key(sk) == jser.serialize_secret_key(jsk)
    for seed in (SEED, None):
        doc = jser.serialize_public_key(jpk, a_seed=seed)
        pk = ser.deserialize_public_key(json.loads(json.dumps(doc)), sch.ctx, "cpu")
        np.testing.assert_array_equal(_u(pk.data), np.asarray(jpk.data))
        assert json.dumps(ser.serialize_public_key(pk, a_seed=seed)) == json.dumps(doc)
        back = jser.deserialize_public_key(ser.serialize_public_key(pk, a_seed=seed), js.ctx)
        np.testing.assert_array_equal(np.asarray(back.data), np.asarray(jpk.data))
    # a port keygen with the same seed has the JAX key's a half
    _, pk2 = sch.keygen(torch.Generator().manual_seed(3), a_seed=SEED)
    np.testing.assert_array_equal(_u(pk2.data[1]), np.asarray(jpk.data[1]))


def test_keyswitch_keys_cross(world):
    """Seeded (sk_to) and dense KSK documents: same residues in both
    packages, same bytes re-emitted; a port-generated seeded KSK has the
    JAX expansion's a rows."""
    js, sch, jsk, sk = world["js"], world["sch"], world["jsk"], world["sk"]
    L = sch.params.num_q
    target = jsk.s_eval[:L]
    jk = jev.keyswitch_key_gen(js.ctx, target, jax.random.PRNGKey(4), sk_to=jsk, a_seed=SEED)
    for seed in (SEED, None):
        doc = jser.serialize_ksk(jk, a_seed=seed)
        k = ser.deserialize_ksk(json.loads(json.dumps(doc)), sch.ctx, "cpu")
        np.testing.assert_array_equal(_u(k.data), np.asarray(jk.data))
        assert json.dumps(ser.serialize_ksk(k, a_seed=seed)) == json.dumps(doc)
    mine = ev.keyswitch_key_gen(sch.ctx, sk.s_eval[:L], torch.Generator().manual_seed(5),
                                sk_to=sk, a_seed=SEED)
    np.testing.assert_array_equal(_u(mine.data[:, 1]), np.asarray(jk.data[:, 1]))
    back = jser.deserialize_ksk(ser.serialize_ksk(mine, a_seed=SEED), js.ctx)
    np.testing.assert_array_equal(np.asarray(back.data), _u(mine.data))
    with pytest.raises(ValueError, match="Montgomery"):
        ser.serialize_ksk(ev.ksk_to_mont(sch.ctx, mine))


def test_ciphertext_blobs_cross(world):
    """PQTC v1, v2 and v3 from the JAX package read to the same residues and
    re-emit the same bytes; the port's own blobs read back in JAX."""
    js, sch, jsk, jpk = world["js"], world["sch"], world["jsk"], world["jpk"]
    vals = np.random.default_rng(2).uniform(-1, 1, js.encoder.slots)
    jct = js.encrypt_values(jpk, vals, jax.random.PRNGKey(6))
    L = sch.params.num_q
    pt = js.make_plaintext(vals)
    jseeded = jrlwe.encrypt_sk(js.ctx, jsk, pt, jax.random.PRNGKey(7), SEED)
    cases = [(jser.ciphertext_to_bytes(jct, version=1), jct, dict(version=1)),
             (jser.ciphertext_to_bytes(jct), jct, {}),
             (jser.ciphertext_to_bytes(JaxCt(jct.data[:, :1], jct.scale)), None, {}),
             (jser.ciphertext_to_bytes(jseeded, a_seed=SEED), jseeded, dict(a_seed=SEED))]
    for blob, jc, kw in cases:
        ct = ser.ciphertext_from_bytes(blob, sch.ctx, "cpu")
        want = jser.ciphertext_from_bytes(blob, js.ctx)
        np.testing.assert_array_equal(_u(ct.data), np.asarray(want.data))
        assert ct.scale == want.scale
        assert ser.ciphertext_to_bytes(ct, **kw) == blob
        assert jser.ciphertext_to_bytes(want, **kw) == ser.ciphertext_to_bytes(ct, **kw)
    parts = ser.ciphertext_seeded_parts(cases[3][0])
    jparts = jser.ciphertext_seeded_parts(cases[3][0])
    np.testing.assert_array_equal(parts[0], jparts[0])
    assert parts[1:] == jparts[1:] and ser.ciphertext_seeded_parts(cases[1][0]) is None
    # a port encryption decrypts in JAX through the wire
    mine = rlwe.encrypt_sk(sch.ctx, world["sk"], sch.make_plaintext(vals),
                           torch.Generator().manual_seed(1), SEED)
    np.testing.assert_array_equal(_u(mine.data[1]), np.asarray(jseeded.data[1]))
    got = jser.ciphertext_from_b64(ser.ciphertext_to_b64(mine, a_seed=SEED), js.ctx)
    assert np.abs(np.asarray(js.decrypt(jsk, got)) - vals).max() < 1e-6
    assert L == jct.nlimbs


def test_foreign_blob_refused(world):
    sch = world["sch"]
    with pytest.raises(ValueError, match="bad ciphertext magic"):
        ser.ciphertext_from_bytes(b"\x01\x02junk" * 8, sch.ctx, "cpu")
    with pytest.raises(ValueError, match="bad ciphertext magic"):
        ser.ciphertext_from_b64(base64.b64encode(b"not a blob").decode(), sch.ctx, "cpu")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pqwd_container_cross(world, tmp_path, writer):
    """A PQWD document written by either package loads in the other to the
    same fields and re-emits the same bytes; the JSON form too."""
    js, jpk = world["js"], world["jpk"]
    vals = np.random.default_rng(8).uniform(-1, 1, 5)
    ct = js.encrypt_values(jpk, vals, jax.random.PRNGKey(9))
    b64 = jser.ciphertext_to_b64(ct)
    doc = {"weights_summary": [
        {"layer": "param_0", "shape": [5], "mean": b64, "std_dev": b64, "values": [b64, b64]},
        {"layer": "param_1", "shape": [1], "mean": b64, "std_dev": b64, "values": [b64]}]}
    first, second = (jser, ser) if writer == "jax" else (ser, jser)
    for binary in (True, False):
        a, b = tmp_path / f"a{binary}", tmp_path / f"b{binary}"
        first.save_enc_doc(json.loads(json.dumps(doc)), str(a), binary=binary)
        assert second.doc_is_binary(str(a)) == binary
        loaded = second.load_enc_doc(str(a))
        assert loaded == first.load_enc_doc(str(a))
        second.save_enc_doc(loaded, str(b), binary=binary)
        assert a.read_bytes() == b.read_bytes()
