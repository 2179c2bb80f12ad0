"""The OpenFHE cereal wire in the port against the JAX package.

``ckks/openfhe_emit.py`` and ``ckks/openfhe_io.py`` are copies of the JAX
package's modules: for the same residues the port's emitter writes the JAX
emitter's bytes (ciphertexts, key documents), and each side parses the
other's ciphertexts. ``serialize.ciphertext_to_b64_openfhe`` writes the JAX
function's Base64 for the same ciphertext at every level, and the ``_any``
readers take both wires. On files, the twin of
``tests/test_fl_pipeline.py::test_openfhe_wire_pipeline`` runs on the port's
tools, and from the JAX tools' files (``wire="openfhe"``, pk and sk
encryptions) the port's changeCipherDomain and aggregation with
``wire="openfhe"`` write the JAX tools' bytes. All on the CPU."""

import base64
import json
import os

import jax
import numpy as np
import pytest

from ppqsflhe_tpu.ckks import openfhe_emit as jemit
from ppqsflhe_tpu.ckks import serialize as jser
from ppqsflhe_tpu.ckks.params import CkksParams as JaxParams
from ppqsflhe_tpu.ckks.scheme import CkksScheme as JaxScheme
from ppqsflhe_tpu.ckks.types import Ciphertext as JaxCt
from ppqsflhe_tpu.fl import api as japi
from ppqsflhe_tpu_torch import convert
from ppqsflhe_tpu_torch.ckks import openfhe_emit, openfhe_io
from ppqsflhe_tpu_torch.ckks import serialize as ser
from ppqsflhe_tpu_torch.ckks.scheme import CkksScheme
from ppqsflhe_tpu_torch.ckks.types import EvalKey, KeySwitchKey
from ppqsflhe_tpu_torch.fl import api

from test_torch_fl_tools import make_weights, read, values_of

CPU = dict(device="cpu")


def _u(t):
    return convert.residues_np(t)


@pytest.fixture(scope="module")
def world():
    jp = JaxParams.generate(n=256, mult_depth=2, scale_bits=40, dnum=2,
                            ntt_backend="fourstep", ntt_impl="mxu")
    js = JaxScheme(jp)
    sch = CkksScheme(ser.params_from_dict(jser.params_to_dict(jp)), device="cpu")
    jsk, jpk = js.keygen(jax.random.PRNGKey(1))
    v = np.random.default_rng(3).uniform(-1, 1, js.encoder.slots)
    jct = js.encrypt_values(jpk, v, jax.random.PRNGKey(2))
    sk = convert.secret_key(np.asarray(jsk.s_eval), np.asarray(jsk.s_int), "cpu")
    return dict(js=js, sch=sch, jsk=jsk, jpk=jpk, jct=jct, sk=sk, v=v,
                ct=convert.ciphertext(np.asarray(jct.data), jct.scale, "cpu"))


@pytest.mark.parametrize("l", [3, 2, 1])
def test_ciphertext_b64_writes_jax_bytes(world, l):
    """The same residues at every level give the JAX function's Base64, and
    either parser reads the other's blob back to the same residues."""
    js, sch = world["js"], world["sch"]
    jct = JaxCt(world["jct"].data[:, :l], world["jct"].scale)
    ct = convert.ciphertext(np.asarray(jct.data), jct.scale, "cpu")
    mine = ser.ciphertext_to_b64_openfhe(ct, sch.ctx)
    assert mine == jser.ciphertext_to_b64_openfhe(jct, js.ctx)
    assert base64.b64decode(mine) == ser.ciphertext_to_bytes_openfhe(ct, sch.ctx)
    back = ser.ciphertext_from_b64_any(mine, sch.ctx, "cpu")
    assert back.scale == jct.scale and back.nlimbs == l
    np.testing.assert_array_equal(_u(back.data), np.asarray(jct.data))
    theirs = jser.ciphertext_from_b64_any(mine, js.ctx)
    np.testing.assert_array_equal(np.asarray(theirs.data), np.asarray(jct.data))
    # a JAX-written blob decrypts in the port
    got = sch.decrypt(world["sk"], ser.ciphertext_from_b64_any(
        jser.ciphertext_to_b64_openfhe(jct, js.ctx), sch.ctx, "cpu"))
    np.testing.assert_allclose(got, world["v"], atol=1e-6)


def test_any_readers_take_pqtc_and_refuse_foreign_blobs(world):
    sch = world["sch"]
    blob = ser.ciphertext_to_b64(world["ct"])
    np.testing.assert_array_equal(_u(ser.ciphertext_from_b64_any(blob, sch.ctx, "cpu").data),
                                  _u(world["ct"].data))
    for bad in (b"XXXX" + bytes(64), b"\x01\x02junk" * 8):
        with pytest.raises(ValueError, match="bad ciphertext magic"):
            ser.ciphertext_from_bytes_any(bad, sch.ctx, "cpu")
        with pytest.raises(ValueError, match="bad ciphertext magic"):
            jser.ciphertext_from_bytes_any(bad)


def test_emitter_copy_writes_jax_bytes(world):
    """The copied emitter against the JAX module on one chain: ciphertext
    binary, public-key, secret-key and eval-key documents, and the parse."""
    js = world["js"]
    ctx = js.ctx
    L = js.params.num_q
    args = (js.params.n, list(js.params.q_moduli), [int(p) for p in ctx.basis.psis[:L]])
    kw = dict(batch_size=js.params.slots, scaling_mod_size=40, mult_depth=L - 1, dnum=2)
    mine, theirs = openfhe_emit.OpenFheEmitter(*args, **kw), jemit.OpenFheEmitter(*args, **kw)
    data = np.asarray(world["jct"].data)
    b = mine.ciphertext_binary(data, scale=2.0**40, level=0, key_tag="t")
    assert b == theirs.ciphertext_binary(data, scale=2.0**40, level=0, key_tag="t")
    ref, got = jemit.parse_ciphertext_binary(b), openfhe_emit.parse_ciphertext_binary(b)
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]))
    pk = np.asarray(world["jpk"].data)[:, :L]
    assert mine.public_key_doc(pk, key_tag="k") == theirs.public_key_doc(pk, key_tag="k")
    assert mine.secret_key_doc(pk[0], key_tag="k") == theirs.secret_key_doc(pk[0], key_tag="k")
    rk = np.stack([pk, pk])
    assert mine.eval_key_doc(rk, key_tag="k") == theirs.eval_key_doc(rk, key_tag="k")
    # the copied reader finds the towers of the emitted public-key document
    doc = json.loads(json.dumps(mine.public_key_doc(pk, key_tag="k")))
    ids, h = openfhe_io.build_id_index(doc), openfhe_io._find_first(doc, "h")
    for comp in range(2):
        poly = openfhe_io._tower_arrays(h[comp], ids)
        np.testing.assert_array_equal(poly.towers, pk[comp])
        assert tuple(poly.moduli) == js.params.q_moduli
    assert openfhe_emit.reemit_json(doc) == doc


def test_eval_key_bundle():
    k = KeySwitchKey(data=convert.residues(np.zeros((1, 2, 3, 4), np.uint64), "cpu"))
    bundle = EvalKey(relin=k, rotations={1: k})
    assert bundle.relin is k and EvalKey().rotations == {} and EvalKey().relin is None


def test_openfhe_wire_pipeline(tmp_path):
    """Twin of tests/test_fl_pipeline.py::test_openfhe_wire_pipeline on the
    port's tools: every ciphertext field is Base64(cereal-BINARY), the
    readers detect it, and the decrypted aggregate matches FedAvg."""
    d = str(tmp_path)
    cc = f"{d}/cc.json"
    api.gen_cc({"multiplicative_depth": 2, "scaling_mod_size": 40, "batch_size": 32,
                "PREMode": "INDCPA", "ring_dim": 128}, cc)
    for i in (1, 2):
        api.key_gen(cc, f"{d}/pk{i}", f"{d}/sk{i}", seed=30 + i, **CPU)
    api.rekey_gen(cc, f"{d}/sk1", f"{d}/pk2", f"{d}/rk12", seed=33, **CPU)
    w1, w2 = f"{d}/w1.json", f"{d}/w2.json"
    s1, s2 = make_weights(w1, 61), make_weights(w2, 62)
    e1, e2 = f"{d}/e1.json", f"{d}/e2.json"
    api.encrypt_weights(cc, f"{d}/pk1", w1, e1, seed=63, wire="openfhe", **CPU)
    # an sk-encryption still ships both components dense on this wire, and
    # there is no binary container
    api.encrypt_weights(cc, f"{d}/sk2", w2, e2, seed=64, wire="openfhe", container="bin", **CPU)
    assert not ser.doc_is_binary(e2)
    for path in (e1, e2):
        with open(path) as f:
            doc = json.load(f)
        rec = openfhe_emit.parse_ciphertext_binary(
            base64.b64decode(doc["weights_summary"][0]["mean"]))
        assert rec["towers"].shape[0] == 2 and rec["scale"] > 0     # (c0, c1)
    e12 = f"{d}/e1in2.json"
    api.change_cipher_domain(cc, f"{d}/rk12", e1, e12, wire="openfhe", **CPU)
    agg = f"{d}/agg.json"
    api.aggregate_encrypted_weights(cc, [e12, e2], agg, wire="openfhe", **CPU)
    out = f"{d}/dec.json"
    api.decrypt_weights(cc, f"{d}/sk2", agg, out, **CPU)
    with open(out) as f:
        dec = json.load(f)
    for ge, a, b in zip(dec["weights_summary"], s1, s2):
        want = (np.asarray(a["values"]) + np.asarray(b["values"])) / 2
        np.testing.assert_allclose(np.asarray(ge["values"]), want, atol=1e-5)
    # the JAX tool decrypts the port's OpenFHE-wire aggregate the same way
    japi.decrypt_weights(cc, f"{d}/sk2", agg, out + ".jax")
    with open(out + ".jax") as f:
        jdec = json.load(f)
    for ge, je in zip(dec["weights_summary"], jdec["weights_summary"]):
        np.testing.assert_allclose(ge["values"], je["values"], atol=1e-9)


@pytest.fixture(scope="module", params=[("radix2", 128, "xla"), ("fourstep", 256, "mxu")],
                ids=["radix2", "fourstep"])
def files(request, tmp_path_factory):
    """The JAX tools' keys and OpenFHE-wire documents for one context:
    client 1 pk-encrypted, client 2 sk-encrypted (dense on this wire)."""
    backend, n, impl = request.param
    d = tmp_path_factory.mktemp(f"openfhe_{backend}")
    p = {k: str(d / k) for k in ("cc", "pk1", "sk1", "pk2", "sk2", "rk12", "rk21", "w1", "w2",
                                 "e1", "e2")}
    japi.gen_cc({"multiplicative_depth": 2, "scaling_mod_size": 40, "batch_size": 32,
                 "PREMode": "INDCPA", "ring_dim": n, "ntt_backend": backend,
                 "ntt_impl": impl}, p["cc"])
    for i in (1, 2):
        japi.key_gen(p["cc"], p[f"pk{i}"], p[f"sk{i}"], seed=100 + i)
    japi.rekey_gen(p["cc"], p["sk1"], p["pk2"], p["rk12"], seed=7)
    japi.rekey_gen(p["cc"], p["sk2"], p["pk1"], p["rk21"], seed=8)
    p["s1"], p["s2"] = make_weights(p["w1"], 1), make_weights(p["w2"], 2)
    japi.encrypt_weights(p["cc"], p["pk1"], p["w1"], p["e1"], seed=11, wire="openfhe")
    japi.encrypt_weights(p["cc"], p["sk2"], p["w2"], p["e2"], seed=12, wire="openfhe")
    p["dir"] = str(d)
    return p


def test_change_cipher_domain_openfhe_writes_jax_bytes(files):
    """From the JAX tools' OpenFHE-wire documents, with and without a
    LevelReduce, into the OpenFHE wire; and from a native PQTC document
    into it."""
    p = files
    for src, rk, drop in (("e1", "rk12", 0), ("e1", "rk12", 1), ("e2", "rk21", 0)):
        j, t = (os.path.join(p["dir"], f"{w}ccd_{src}{drop}.json") for w in ("j", "t"))
        japi.change_cipher_domain(p["cc"], p[rk], p[src], j, drop_limbs=drop, wire="openfhe")
        api.change_cipher_domain(p["cc"], p[rk], p[src], t, drop_limbs=drop, wire="openfhe",
                                 **CPU)
        assert read(t) == read(j), (src, drop)
    native = os.path.join(p["dir"], "native.bin")
    japi.encrypt_weights(p["cc"], p["pk1"], p["w1"], native, seed=13, container="bin")
    j, t = (os.path.join(p["dir"], f"{w}ccd_native.json") for w in ("j", "t"))
    japi.change_cipher_domain(p["cc"], p["rk12"], native, j, wire="openfhe")
    api.change_cipher_domain(p["cc"], p["rk12"], native, t, wire="openfhe", **CPU)
    assert read(t) == read(j) and not ser.doc_is_binary(t)


def test_aggregate_openfhe_writes_jax_bytes(files):
    """A moved OpenFHE-wire document beside a fresh one, both schedules;
    the port's aggregate decrypts to FedAvg."""
    p = files
    moved = os.path.join(p["dir"], "moved.json")
    japi.change_cipher_domain(p["cc"], p["rk12"], p["e1"], moved, wire="openfhe")
    for lazy in (False, True):
        j, t = (os.path.join(p["dir"], f"{w}agg{lazy}.json") for w in ("j", "t"))
        japi.aggregate_encrypted_weights(p["cc"], [moved, p["e2"]], j, lazy=lazy, wire="openfhe")
        api.aggregate_encrypted_weights(p["cc"], [moved, p["e2"]], t, lazy=lazy,
                                        wire="openfhe", **CPU)
        assert read(t) == read(j), f"lazy={lazy}"
        out = api.decrypt_weights(p["cc"], p["sk2"], t, t + ".dec", **CPU)
        for (k, got), a, b in zip(values_of(out).items(), p["s1"], p["s2"]):
            want = (np.asarray(a["values"]) + np.asarray(b["values"])) / 2
            np.testing.assert_allclose(got, want, atol=1e-3, err_msg=k)


def test_unknown_wire_refused(files, tmp_path):
    with pytest.raises(ValueError, match="wire"):
        api.change_cipher_domain(files["cc"], files["rk12"], files["e1"], str(tmp_path / "x"),
                                 wire="cereal-json", **CPU)
