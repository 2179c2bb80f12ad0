"""The port's seven threshold tools and their CLI subcommands on files, against
the JAX tools, at ring 128 (radix-2, the CLI's default) on the CPU.

Three parties share one CRS seed: party 1 runs the JAX tools, party 2 the
port's API and party 3 the port's CLI, so every document crosses in both
directions. ``thresholdCombine`` and ``thresholdAggregateShares`` must write
the JAX tools' bytes from the same inputs; ``thresholdFuseDecrypt`` of the
JAX tools' partial decryptions gives the JAX tool's document; the N-of-N
round decrypts within 0.08 and the 2-of-3 round within 0.2 (the gates of
tests/test_threshold.py), whichever package fuses."""

import json

import numpy as np
import pytest

from ppqsflhe_tpu.fl import api as japi
from ppqsflhe_tpu_torch.fl import api, cli

CPU = dict(device="cpu")
CRS = 42
N_PARTIES, T = 3, 2


def make_weights(path, seed):
    rng = np.random.default_rng(seed)
    summary = []
    for i, shape in enumerate([(3, 6), (50,), (1,)]):
        vals = rng.uniform(-1, 1, int(np.prod(shape)))
        summary.append({"layer": f"param_{i}", "shape": list(shape), "mean": float(vals.mean()),
                        "std_dev": float(vals.std()), "values": [float(v) for v in vals]})
    with open(path, "w") as f:
        json.dump({"weights_summary": summary}, f)
    return summary


def read(path):
    with open(path, "rb") as f:
        return f.read()


def run_cli(*args):
    assert cli.main(["--device", "cpu", *map(str, args)]) == 0


def assert_close(doc, summary, atol):
    for got, want in zip(doc["weights_summary"], summary):
        assert got["layer"] == want["layer"] and got["shape"] == want["shape"]
        np.testing.assert_allclose(got["values"], want["values"], atol=atol)
        np.testing.assert_allclose([got["mean"], got["std_dev"]],
                                   [want["mean"], want["std_dev"]], atol=atol)


@pytest.fixture(scope="module")
def w(tmp_path_factory):
    d = tmp_path_factory.mktemp("threshold")
    p = lambda name: str(d / name)
    japi.gen_cc({"multiplicative_depth": 2, "scaling_mod_size": 40, "batch_size": 32,
                 "PREMode": "INDCPA", "ring_dim": 128}, p("cc"))
    japi.threshold_keygen(p("cc"), CRS, p("sh1"), p("b1"), seed=101)
    api.threshold_keygen(p("cc"), CRS, p("sh2"), p("b2"), seed=102, **CPU)
    run_cli("--seed", 103, "thresholdKeyGen", p("cc"), CRS, p("sh3"), p("b3"))
    bshares = [p(f"b{i}") for i in (1, 2, 3)]
    japi.threshold_combine_pubkey(p("cc"), CRS, bshares, p("jpk_jax"))
    summary = make_weights(p("w"), 5)
    japi.encrypt_weights(p("cc"), p("jpk_jax"), p("w"), p("enc"), seed=6)
    return dict(p=p, bshares=bshares, summary=summary)


def test_combine_writes_jax_bytes(w):
    p = w["p"]
    api.threshold_combine_pubkey(p("cc"), CRS, w["bshares"], p("jpk_port"), **CPU)
    run_cli("thresholdCombine", p("cc"), CRS, p("jpk_cli"), *w["bshares"])
    assert read(p("jpk_port")) == read(p("jpk_jax")) == read(p("jpk_cli"))
    doc = json.loads(read(p("b2")))
    assert doc["type"] == "ckks_public_share" and doc["crs_seed"] == CRS
    with pytest.raises(ValueError, match="different CRS seed"):
        api.threshold_combine_pubkey(p("cc"), CRS + 1, w["bshares"], p("bad"), **CPU)


def test_n_of_n_fusion_both_ways(w):
    """Party 1's partial from the JAX tool, 2's from the port's API, 3's
    from its CLI (lead-free, smudging 30); the JAX tool and the port fuse
    them to the same document, within 0.08 of the weights."""
    p = w["p"]
    japi.threshold_partial_decrypt(p("cc"), p("sh1"), p("enc"), p("pd1"), seed=11)
    api.threshold_partial_decrypt(p("cc"), p("sh2"), p("enc"), p("pd2"), seed=12, **CPU)
    run_cli("--seed", 13, "thresholdPartialDecrypt", p("cc"), p("sh3"), p("enc"), p("pd3"))
    parts = [p(f"pd{i}") for i in (1, 2, 3)]
    japi.threshold_fuse_decrypt(p("cc"), p("enc"), parts, p("dec_jax"))
    out = api.threshold_fuse_decrypt(p("cc"), p("enc"), parts, p("dec_port"), **CPU)
    run_cli("thresholdFuseDecrypt", p("cc"), p("enc"), p("dec_cli"), *parts)
    assert read(p("dec_port")) == read(p("dec_jax")) == read(p("dec_cli"))
    assert_close(out, w["summary"], 0.08)
    doc = json.loads(read(p("pd2")))
    assert doc["type"] == "ckks_partial_decryptions" and doc["limbs"] == 3


def test_fuse_of_jax_partials_gives_the_jax_document(w):
    """Every partial from the JAX tool (it reads the port's secret shares),
    encrypted by the port's tool under the port's joint key."""
    p = w["p"]
    api.threshold_combine_pubkey(p("cc"), CRS, w["bshares"], p("jpk_p"), **CPU)
    api.encrypt_weights(p("cc"), p("jpk_p"), p("w"), p("enc_p"), seed=7, **CPU)
    parts = []
    for i in (1, 2, 3):
        japi.threshold_partial_decrypt(p("cc"), p(f"sh{i}"), p("enc_p"), p(f"jpd{i}"),
                                       seed=20 + i)
        parts.append(p(f"jpd{i}"))
    japi.threshold_fuse_decrypt(p("cc"), p("enc_p"), parts, p("jdec"))
    out = api.threshold_fuse_decrypt(p("cc"), p("enc_p"), parts, p("tdec"), **CPU)
    assert read(p("tdec")) == read(p("jdec"))
    assert_close(out, w["summary"], 0.08)


def test_no_flood_decrypts_exactly(w):
    p = w["p"]
    parts = []
    for i in (1, 2, 3):
        api.threshold_partial_decrypt(p("cc"), p(f"sh{i}"), p("enc"), p(f"z{i}"), seed=30 + i,
                                      smudging_bits=0, **CPU)
        parts.append(p(f"z{i}"))
    assert_close(api.threshold_fuse_decrypt(p("cc"), p("enc"), parts, p("zdec"), **CPU),
                 w["summary"], 1e-3)


@pytest.fixture(scope="module")
def shamir(w):
    """Shamir 2-of-3: party 1 shares with the JAX tool, 2 with the port's
    API, 3 with its CLI; each recipient's σ from the port's tool."""
    p = w["p"]
    outs = lambda i: [p(f"f{i}to{j}") for j in range(1, N_PARTIES + 1)]
    japi.threshold_shamir_share(p("cc"), p("sh1"), N_PARTIES, T, outs(1), seed=41)
    api.threshold_shamir_share(p("cc"), p("sh2"), N_PARTIES, T, outs(2), seed=42, **CPU)
    run_cli("--seed", 43, "thresholdShamirShare", p("cc"), p("sh3"), N_PARTIES, T, *outs(3))
    incoming = {j: [p(f"f{i}to{j}") for i in range(1, N_PARTIES + 1)]
                for j in range(1, N_PARTIES + 1)}
    for j, files in incoming.items():
        api.threshold_aggregate_shares(p("cc"), files, p(f"sig{j}"), **CPU)
    return incoming


def test_aggregate_shares_writes_jax_bytes(w, shamir):
    """Each recipient's σ from the port's API and CLI is the JAX tool's
    bytes."""
    p = w["p"]
    for j, incoming in shamir.items():
        japi.threshold_aggregate_shares(p("cc"), incoming, p(f"sig{j}_jax"))
        run_cli("thresholdAggregateShares", p("cc"), p(f"sig{j}_cli"), *incoming)
        assert read(p(f"sig{j}")) == read(p(f"sig{j}_jax")) == read(p(f"sig{j}_cli"))
    doc = json.loads(read(p("f2to3")))
    assert (doc["type"], doc["recipient"], doc["threshold"]) == ("ckks_shamir_share", 3, T)


def test_t_of_n_both_ways(w, shamir):
    """The set {1, 3} decrypts (party 1 in the JAX tool, 3 in the port's
    API or CLI) within 0.2, the same document whichever package fuses."""
    p = w["p"]
    japi.threshold_partial_decrypt_t(p("cc"), p("sig1"), p("enc"), p("pt1"), [1, 3], 1, seed=51)
    api.threshold_partial_decrypt_t(p("cc"), p("sig3"), p("enc"), p("pt3"), [1, 3], 3,
                                    seed=53, **CPU)
    run_cli("--seed", 54, "thresholdPartialDecryptT", p("cc"), p("sig3"), p("enc"),
            p("pt3c"), 3, 1, 3)
    for third in ("pt3", "pt3c"):
        parts = [p("pt1"), p(third)]
        japi.threshold_fuse_decrypt(p("cc"), p("enc"), parts, p("tdec_jax"))
        out = api.threshold_fuse_decrypt(p("cc"), p("enc"), parts, p("tdec"), **CPU)
        assert read(p("tdec")) == read(p("tdec_jax"))
        assert_close(out, w["summary"], 0.2)
    assert json.loads(read(p("pt3")))["party_set"] == [1, 3]


def test_t_of_n_refusals(w, shamir):
    p = w["p"]
    with pytest.raises(ValueError, match="belongs to party"):
        api.threshold_partial_decrypt_t(p("cc"), p("sig3"), p("enc"), p("x"), [1, 2], 2, **CPU)
    with pytest.raises(ValueError, match="threshold"):
        api.threshold_partial_decrypt_t(p("cc"), p("sig3"), p("enc"), p("x"), [1, 2, 3], 3,
                                        **CPU)
    with pytest.raises(ValueError, match="output paths"):
        api.threshold_shamir_share(p("cc"), p("sh2"), N_PARTIES, T, [p("x")], **CPU)
    with pytest.raises(ValueError, match="different recipients"):
        api.threshold_aggregate_shares(p("cc"), [p("f1to1"), p("f1to2")], p("x"), **CPU)


def test_entry_points_default_to_the_card():
    """The seven tools and the CRS run on the card unless the caller names
    another device; the multikey bench refuses to run without one."""
    import inspect

    from ppqsflhe_tpu_torch.bench import multikey as mk
    from ppqsflhe_tpu_torch.ckks import threshold as th

    tools = [api.threshold_keygen, api.threshold_combine_pubkey, api.threshold_partial_decrypt,
             api.threshold_shamir_share, api.threshold_aggregate_shares,
             api.threshold_partial_decrypt_t, api.threshold_fuse_decrypt,
             th.common_random_poly, th.lagrange_at_zero]
    for fn in tools:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
    with pytest.raises(SystemExit, match="needs a CUDA GPU"):
        mk.main([])
