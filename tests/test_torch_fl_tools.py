"""The port's seven FL tools on files against the JAX tools.

The JAX tools write the CC, the keys and the encrypted documents at ring 128
(radix-2, the CLI's default) and ring 256 (four-step). From those files the
port's ``change_cipher_domain`` (INDCPA, with and without ``drop_limbs``) and
``aggregate_encrypted_weights`` (with and without ``lazy``) must write the
same bytes as the JAX tools, in both containers; ``decrypt_weights`` of one
file gives the same values in both packages; ciphertexts cross both ways.
The port's own rounds decrypt within the JAX tests' gates
(``tests/test_fl_pipeline.py:110,165``: 1e-3 for INDCPA, 0.1 for two INDCCA
hops). All on the CPU (``device="cpu"``)."""

import base64
import json
import os

import numpy as np
import pytest

from ppqsflhe_tpu.fl import api as japi
from ppqsflhe_tpu_torch.ckks import serialize as ser
from ppqsflhe_tpu_torch.fl import api, cli

CPU = dict(device="cpu")


def make_weights(path, seed, with_optimizer=False):
    rng = np.random.default_rng(seed)
    summary = []
    for i, shape in enumerate([(3, 6), (50,), (1,)]):
        vals = rng.uniform(-1, 1, int(np.prod(shape)))
        summary.append({"layer": f"param_{i}", "shape": list(shape),
                        "mean": float(vals.mean()), "std_dev": float(vals.std()),
                        "values": [float(v) for v in vals]})
    if with_optimizer:
        summary.append({"layer": "optimizer/adam", "shape": [2], "mean": 0.0,
                        "std_dev": 0.0, "values": [0.0, 0.0]})
    with open(path, "w") as f:
        json.dump({"weights_summary": summary}, f)
    return summary


def values_of(doc):
    return {e["layer"]: np.asarray(e["values"]) for e in doc["weights_summary"]}


def read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module", params=[("radix2", 128, "xla"), ("fourstep", 256, "mxu")],
                ids=["radix2", "fourstep"])
def files(request, tmp_path_factory):
    """Everything the JAX tools write for one context."""
    backend, n, impl = request.param
    d = tmp_path_factory.mktemp(backend)
    p = {k: str(d / k) for k in ("cc", "pk1", "sk1", "pk2", "sk2", "rk12", "rk21", "w1", "w2")}
    japi.gen_cc({"multiplicative_depth": 2, "scaling_mod_size": 40, "batch_size": 32,
                 "PREMode": "INDCPA", "ring_dim": n, "ntt_backend": backend,
                 "ntt_impl": impl}, p["cc"])
    for i in (1, 2):
        japi.key_gen(p["cc"], p[f"pk{i}"], p[f"sk{i}"], seed=100 + i)
    japi.rekey_gen(p["cc"], p["sk1"], p["pk2"], p["rk12"], seed=7)
    japi.rekey_gen(p["cc"], p["sk2"], p["pk1"], p["rk21"], seed=8)
    p["s1"] = make_weights(p["w1"], 1, with_optimizer=True)
    p["s2"] = make_weights(p["w2"], 2)
    for c in ("json", "bin"):
        p[f"e1_{c}"] = str(d / f"e1.{c}")        # client 1: public key, dense v2
        p[f"e2_{c}"] = str(d / f"e2.{c}")        # client 2: secret key, seeded v3
        japi.encrypt_weights(p["cc"], p["pk1"], p["w1"], p[f"e1_{c}"], seed=11, container=c)
        japi.encrypt_weights(p["cc"], p["sk2"], p["w2"], p[f"e2_{c}"], seed=12, container=c)
    p["dir"] = str(d)
    return p


@pytest.mark.parametrize("container", ["json", "bin"])
def test_change_cipher_domain_writes_jax_bytes(files, container):
    p = files
    for drop in (0, 1):
        j, t = (os.path.join(p["dir"], f"{w}ccd{drop}.{container}") for w in ("j", "t"))
        japi.change_cipher_domain(p["cc"], p["rk12"], p[f"e1_{container}"], j, drop_limbs=drop)
        api.change_cipher_domain(p["cc"], p["rk12"], p[f"e1_{container}"], t, drop_limbs=drop,
                                 **CPU)
        assert read(t) == read(j), f"drop_limbs={drop}"
    # the seeded (v3) document of client 2 moves to client 1 the same way
    j, t = (os.path.join(p["dir"], f"{w}ccd21.{container}") for w in ("j", "t"))
    japi.change_cipher_domain(p["cc"], p["rk21"], p[f"e2_{container}"], j)
    api.change_cipher_domain(p["cc"], p["rk21"], p[f"e2_{container}"], t, **CPU)
    assert read(t) == read(j)


@pytest.mark.parametrize("container", ["json", "bin"])
def test_aggregate_writes_jax_bytes(files, container):
    """Over a moved (dense) and a seeded document at two levels."""
    p = files
    moved = os.path.join(p["dir"], f"moved.{container}")
    japi.change_cipher_domain(p["cc"], p["rk12"], p[f"e1_{container}"], moved, drop_limbs=1)
    for lazy in (False, True):
        j, t = (os.path.join(p["dir"], f"{w}agg{lazy}.{container}") for w in ("j", "t"))
        ins = [moved, p[f"e2_{container}"]]
        japi.aggregate_encrypted_weights(p["cc"], ins, j, lazy=lazy)
        api.aggregate_encrypted_weights(p["cc"], ins, t, lazy=lazy, **CPU)
        assert read(t) == read(j), f"lazy={lazy}"
        out = api.decrypt_weights(p["cc"], p["sk2"], t, t + ".dec", **CPU)
        for (k, got), a, b in zip(values_of(out).items(), p["s1"], p["s2"]):
            want = (np.asarray(a["values"]) + np.asarray(b["values"])) / 2
            np.testing.assert_allclose(got, want, atol=1e-3, err_msg=k)


def test_decrypt_and_cross_decrypt(files):
    """decrypt_weights of one file writes the same document in both
    packages; port-encrypted documents (pk and sk, both containers) decrypt
    in the JAX tool, and JAX-encrypted ones in the port."""
    p = files
    for c in ("json", "bin"):
        for enc, sk, want in ((p[f"e1_{c}"], p["sk1"], p["s1"]), (p[f"e2_{c}"], p["sk2"], p["s2"])):
            j, t = enc + ".jdec", enc + ".tdec"
            japi.decrypt_weights(p["cc"], sk, enc, j)
            out = api.decrypt_weights(p["cc"], sk, enc, t, **CPU)
            assert read(t) == read(j)
            assert "optimizer/adam" not in values_of(out)
            for e in want[:3]:
                got = values_of(out)[e["layer"]]
                assert got.size == int(np.prod(e["shape"]))
                np.testing.assert_allclose(got, e["values"], atol=1e-5)
        for key, i in (("pk1", 1), ("sk1", 1)):
            enc = os.path.join(p["dir"], f"port_{key}.{c}")
            api.encrypt_weights(p["cc"], p[key], p["w1"], enc, seed=21, container=c, **CPU)
            assert ser.doc_is_binary(enc) == (c == "bin")
            out = japi.decrypt_weights(p["cc"], p[f"sk{i}"], enc, enc + ".jdec")
            for e in p["s1"][:3]:
                np.testing.assert_allclose(values_of(out)[e["layer"]], e["values"], atol=1e-5)


def test_seeded_halves_match_jax(files, tmp_path):
    """For the same seed the port's public key has the JAX tool's a half,
    and the port's secret-key encryption ships the JAX tool's v3 seeds (so
    the same c1)."""
    p = files
    api.key_gen(p["cc"], str(tmp_path / "pk"), str(tmp_path / "sk"), seed=101, **CPU)
    mine, theirs = ser.load_json(str(tmp_path / "pk")), ser.load_json(p["pk1"])
    assert mine["a_seed"] == theirs["a_seed"] and mine["shape"] == theirs["shape"]
    enc = str(tmp_path / "e2")
    api.encrypt_weights(p["cc"], p["sk2"], p["w2"], enc, seed=12, **CPU)
    for a, b in zip(ser.load_enc_doc(enc)["weights_summary"],
                    ser.load_enc_doc(p["e2_json"])["weights_summary"]):
        for x, y in zip([a["mean"]] + a["values"], [b["mean"]] + b["values"]):
            px, py = (ser.ciphertext_parts(base64.b64decode(v)) for v in (x, y))
            assert px[1] == py[1] and px[1] is not None


def test_port_rounds_within_jax_gates(files, tmp_path):
    """The port's own full round (keys, rekeys, pk and sk encryption, PRE,
    FedAvg, PRE back, both decrypts) within 1e-3, and, on the radix-2 ring,
    an INDCCA round within 0.1."""
    p = files
    cc = p["cc"]
    f = {k: str(tmp_path / k) for k in ("pk1", "sk1", "pk2", "sk2", "rk12", "rk21", "e1",
                                        "e2", "c12", "agg", "back", "d1", "d2")}
    for i in (1, 2):
        api.key_gen(cc, f[f"pk{i}"], f[f"sk{i}"], seed=300 + i, **CPU)
    api.rekey_gen(cc, f["sk1"], f["pk2"], f["rk12"], seed=5, **CPU)
    api.rekey_gen(cc, f["sk2"], f["pk1"], f["rk21"], seed=6, **CPU)
    api.encrypt_weights(cc, f["pk1"], p["w1"], f["e1"], seed=1, **CPU)
    api.encrypt_weights(cc, f["sk2"], p["w2"], f["e2"], seed=2, container="bin", **CPU)
    api.change_cipher_domain(cc, f["rk12"], f["e1"], f["c12"], **CPU)
    api.aggregate_encrypted_weights(cc, [f["c12"], f["e2"]], f["agg"], **CPU)
    api.change_cipher_domain(cc, f["rk21"], f["agg"], f["back"], **CPU)
    d2 = api.decrypt_weights(cc, f["sk2"], f["agg"], f["d2"], **CPU)
    d1 = api.decrypt_weights(cc, f["sk1"], f["back"], f["d1"], **CPU)
    for a, b in zip(p["s1"], p["s2"]):
        want = (np.asarray(a["values"]) + np.asarray(b["values"])) / 2
        np.testing.assert_allclose(values_of(d1)[a["layer"]], want, atol=1e-3)
        np.testing.assert_allclose(values_of(d2)[a["layer"]], want, atol=1e-3)
    if "radix2" not in p["dir"]:
        return
    cca = str(tmp_path / "cca.json")
    with open(cc) as fh:
        doc = json.load(fh)
    with open(cca, "w") as fh:
        json.dump(dict(doc, pre_mode="INDCCA"), fh)
    with pytest.raises(ValueError, match="INDCCA"):
        api.change_cipher_domain(cca, f["rk12"], f["e1"], str(tmp_path / "x"), **CPU)
    hop, hop_b = str(tmp_path / "hop"), str(tmp_path / "hop_b")
    api.change_cipher_domain(cca, f["rk12"], f["e1"], hop, pub_path=f["pk2"], seed=81, **CPU)
    api.change_cipher_domain(cca, f["rk12"], f["e1"], hop_b, pub_path=f["pk2"], seed=82, **CPU)
    assert read(hop) != read(hop_b)                      # re-randomized
    api.aggregate_encrypted_weights(cca, [hop, f["e2"]], f["agg"], **CPU)
    api.change_cipher_domain(cca, f["rk21"], f["agg"], f["back"], pub_path=f["pk1"], seed=83,
                             **CPU)
    d1 = api.decrypt_weights(cca, f["sk1"], f["back"], f["d1"], **CPU)
    for a, b in zip(p["s1"], p["s2"]):
        want = (np.asarray(a["values"]) + np.asarray(b["values"])) / 2
        np.testing.assert_allclose(values_of(d1)[a["layer"]], want, atol=0.1)


def test_unseeded_keys_take_os_entropy(files, tmp_path, monkeypatch):
    """Without a seed the generator's whole mt19937 state comes from
    os.urandom (624 words, far above 128 bits): fixed entropy gives the same
    secret key, fresh entropy different ones."""
    asked = []
    real = os.urandom

    def fixed(k):
        asked.append(k)
        return bytes(range(256)) * (k // 256) + bytes(range(k % 256))

    monkeypatch.setattr(os, "urandom", fixed)
    sks = []
    for i in range(2):
        api.key_gen(files["cc"], str(tmp_path / f"pk{i}"), str(tmp_path / f"sk{i}"), **CPU)
        sks.append(ser.load_json(str(tmp_path / f"sk{i}")))
    assert sks[0] == sks[1] and max(asked) >= 16 and sum(asked) >= 2 * 4 * 624
    monkeypatch.setattr(os, "urandom", real)
    api.key_gen(files["cc"], str(tmp_path / "pk2"), str(tmp_path / "sk2"), **CPU)
    assert ser.load_json(str(tmp_path / "sk2")) != sks[0]


def test_cli_smoke(files, tmp_path):
    """The seven subcommands through fl/cli.py on the CPU."""
    p, d = files, str(tmp_path)
    run = lambda *a: cli.main(["--device", "cpu", "--seed", "5", *a])
    cfg = os.path.join(d, "cfg.json")
    with open(cfg, "w") as f:
        json.dump({"multiplicative_depth": 2, "scaling_mod_size": 40, "batch_size": 32,
                   "PREMode": "INDCPA", "ring_dim": 128}, f)
    cc = os.path.join(d, "cc.json")
    P = lambda n: os.path.join(d, n)
    assert run("genCC", cfg, cc) == 0
    assert run("keyGen", cc, P("pk1"), P("sk1")) == 0
    assert cli.main(["--device", "cpu", "--seed", "6", "keyGen", cc, P("pk2"), P("sk2")]) == 0
    assert run("REkeyGen", cc, P("sk1"), P("pk2"), P("rk12")) == 0
    assert run("encryptModelWeights", cc, P("pk1"), p["w1"], P("e1"), "--binary") == 0
    assert run("encryptModelWeights", cc, P("sk2"), p["w2"], P("e2")) == 0
    assert run("changeCipherDomain", cc, P("rk12"), P("e1"), P("c12"), "--drop-limbs", "1") == 0
    assert run("aggregateEncryptedWeights", cc, P("agg"), P("c12"), P("e2"), "--lazy") == 0
    assert run("decryptModelWeights", cc, P("sk2"), P("agg"), P("dec")) == 0
    assert ser.doc_is_binary(P("agg"))
    with open(P("dec")) as f:
        got = values_of(json.load(f))
    for a, b in zip(p["s1"], p["s2"]):
        want = (np.asarray(a["values"]) + np.asarray(b["values"])) / 2
        np.testing.assert_allclose(got[a["layer"]], want, atol=1e-3)
    # the OpenFHE wire: cereal-BINARY fields in a JSON document, which the
    # other tools read
    assert run("encryptModelWeights", cc, P("pk1"), p["w1"], P("x"), "--wire", "openfhe") == 0
    assert not ser.doc_is_binary(P("x"))
    with open(P("x")) as f:
        assert base64.b64decode(json.load(f)["weights_summary"][0]["mean"])[:4] != ser.MAGIC
    assert run("decryptModelWeights", cc, P("sk1"), P("x"), P("xdec")) == 0
    with open(P("xdec")) as f:
        got = values_of(json.load(f))
    assert set(got) == {a["layer"] for a in p["s1"][:3]}       # the optimizer layer skipped
    for a in p["s1"][:3]:
        np.testing.assert_allclose(got[a["layer"]], a["values"], atol=1e-3)
    with pytest.raises(ValueError, match="PREMode"):
        api.gen_cc({"ring_dim": 128, "batch_size": 32, "PREMode": "INDCCA2"}, P("bad.json"))
