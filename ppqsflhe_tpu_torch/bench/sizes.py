"""Wire and artifact sizes against the reference's committed run: the twin
of ``bench_sizes.py:37-132``.

The reference pins every artifact size in its
``orchestration/metrics/comm_metrics.csv`` (:data:`REF_SIZES`). This bench
makes the same artifacts with the port's tools at the same parameters — the
reference chain (N=16384, 4 towers, batch 8192) and the reference GRU's
39,041 weights (numpy-seeded normal(0, 0.2)) — and reports their bytes and
the ratios:

- the CC, both key pairs, the rekeys 1 → 2 and 2 → 1;
- the weights encrypted under the public key (dense), under the secret key
  (seeded), and on the OpenFHE cereal wire (``wire="openfhe"``);
- a full-level changeCipherDomain of the seeded document;
- the lazy binary round: seeded PQWD uploads, the uplink PRE one tower
  down, the lazy FedAvg another, and the downlink LevelReduced to one tower
  before its PRE, whose decrypt must give the payload back within 1e-4.

The tools run on ``--device`` (the card by default; sizes do not depend on
it). A dense (v2) document's limb widths follow its residues' maxima: on
the reference chain q2 = 2^40 + 294,913, so a ciphertext whose q2 residues
reach 2^40 (about 1 in 110) takes one more byte per coefficient there, and
the dense documents' sizes vary by that much from run to run. It prints one JSON line with ``bench_sizes.py``'s keys plus
``"card"`` and writes it only to the path given with ``--out``, never to
the repository's ``SIZES.json``, which holds the JAX package's numbers::

    python -m ppqsflhe_tpu_torch.bench.sizes [--device cpu|cuda] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch

from ..fl import api
from .timing import card_line

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REF_SIZES = {  # bytes, from the reference's comm_metrics.csv
    "cc": 15199,
    "pubkey": 12622786,
    "rekey": 26799207,
    "enc_weights": 37806011,
    "aggregate": 28368755,
}
# the reference GRU's 8 weight tensors: 39,041 values
GRU_SHAPES = [[7, 192], [64, 192], [2, 192], [64, 192], [64, 192], [2, 192], [64, 1], [1]]
REFERENCE_CC = {"multiplicative_depth": 2, "scaling_mod_size": 40, "batch_size": 8192,
                "PREMode": "INDCPA", "use_reference_chain": True}
ERR_GATE = 1e-4


def weights_doc(shapes=GRU_SHAPES, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"weights_summary": [
        {"layer": f"param_{i}", "shape": sh, "mean": 0.0, "std_dev": 1.0,
         "values": rng.normal(0, 0.2, int(np.prod(sh))).tolist()}
        for i, sh in enumerate(shapes)]}


def artifacts(tools, d: str, cc_config=REFERENCE_CC, shapes=GRU_SHAPES, **kw) -> tuple:
    """Every artifact of ``bench_sizes.py:50-104`` in directory ``d``,
    written by ``tools`` (the port's ``fl.api``, or a module with the same
    tools); ``kw`` goes to every tool but ``gen_cc`` (the port's
    ``device``). Returns (sizes in bytes, the downlink's decrypt error)."""
    P = lambda name: os.path.join(d, name)
    cc = P("CC.json")
    tools.gen_cc(dict(cc_config), cc)
    for i in (1, 2):
        tools.key_gen(cc, P(f"pk{i}"), P(f"sk{i}"), seed=100 + i, **kw)
    tools.rekey_gen(cc, P("sk1"), P("pk2"), P("rk12"), seed=7, **kw)
    weights = weights_doc(shapes)
    with open(P("weights.json"), "w") as f:
        json.dump(weights, f)
    w = P("weights.json")
    tools.encrypt_weights(cc, P("pk1"), w, P("enc_dense.json"), seed=21, **kw)
    tools.encrypt_weights(cc, P("sk1"), w, P("enc_seeded.json"), seed=21, **kw)
    tools.encrypt_weights(cc, P("pk1"), w, P("enc_openfhe.json"), seed=21, wire="openfhe", **kw)
    tools.change_cipher_domain(cc, P("rk12"), P("enc_seeded.json"), P("agg.json"), **kw)

    # the lazy binary round: seeded binary uplinks, the uplink PRE one tower
    # down, the lazy FedAvg another, the decrypt-only downlink at one tower
    tools.rekey_gen(cc, P("sk2"), P("pk1"), P("rk21"), seed=8, **kw)
    tools.encrypt_weights(cc, P("sk1"), w, P("e1.bin"), seed=31, container="bin", **kw)
    tools.encrypt_weights(cc, P("sk2"), w, P("e2.bin"), seed=32, container="bin", **kw)
    tools.change_cipher_domain(cc, P("rk12"), P("e1.bin"), P("e1in2.bin"), drop_limbs=1, **kw)
    tools.aggregate_encrypted_weights(cc, [P("e1in2.bin"), P("e2.bin")], P("agg2.bin"),
                                      lazy=True, **kw)
    tools.change_cipher_domain(cc, P("rk21"), P("agg2.bin"), P("downlink.bin"), keep_limbs=1,
                               **kw)
    tools.decrypt_weights(cc, P("sk1"), P("downlink.bin"), P("dec.json"), **kw)
    with open(P("dec.json")) as f:
        dec = json.load(f)
    # both clients encrypted the same payload, so FedAvg gives it back
    err = max(float(np.abs(np.asarray(e["values"]) - np.asarray(v["values"])).max())
              for e, v in zip(dec["weights_summary"], weights["weights_summary"]))
    sz = lambda name: os.path.getsize(P(name))
    sizes = {
        "cc": sz("CC.json"), "pubkey": sz("pk1"), "secret_key": sz("sk1"), "rekey": sz("rk12"),
        "enc_weights_dense": sz("enc_dense.json"), "enc_weights_seeded": sz("enc_seeded.json"),
        "enc_weights_seeded_bin": sz("e1.bin"),
        "enc_weights_openfhe_wire": sz("enc_openfhe.json"),
        "aggregate_full_level": sz("agg.json"), "aggregate_lazy_bin": sz("downlink.bin"),
        "plain_weights": sz("weights.json"),
    }
    return sizes, err


def report(sizes: dict) -> dict:
    """``bench_sizes.py``'s JSON object for ``sizes``."""
    ref = REF_SIZES
    ratios = {
        "pubkey": ref["pubkey"] / sizes["pubkey"],
        "rekey": ref["rekey"] / sizes["rekey"],
        "enc_weights_dense": ref["enc_weights"] / sizes["enc_weights_dense"],
        "enc_weights_seeded": ref["enc_weights"] / sizes["enc_weights_seeded"],
        "enc_weights_seeded_bin": ref["enc_weights"] / sizes["enc_weights_seeded_bin"],
        "aggregate_full_level": ref["aggregate"] / sizes["aggregate_full_level"],
        "aggregate": ref["aggregate"] / sizes["aggregate_lazy_bin"],
    }
    return {"metric": "wire_size_reduction_enc_weights",
            "value": round(ratios["enc_weights_seeded"], 2), "unit": "x_smaller_than_reference",
            "sizes_bytes": sizes, "reference_bytes": ref,
            "ratios_vs_reference": {k: round(v, 2) for k, v in ratios.items()}}


def bench(device="cuda", out=print) -> dict:
    """The artifacts at the reference's sizes with the port's tools on
    ``device``, in a temporary directory: prints and returns the JSON
    object; raises after printing when the downlink's decrypt fails."""
    device = torch.device(device)
    with tempfile.TemporaryDirectory(prefix="ppqsflhe_sizes_") as d:
        sizes, err = artifacts(api, d, device=str(device))
    result = dict(report(sizes), err=err, device=str(device),
                  card=card_line() if device.type == "cuda" else None)
    out(json.dumps(result))
    if not (np.isfinite(err) and err < ERR_GATE):
        raise AssertionError(f"lazy binary downlink decrypt error {err} over {ERR_GATE}")
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device the tools compute on")
    ap.add_argument("--out", default=None, help="also write the JSON object to this path")
    args = ap.parse_args(argv)
    if args.out and os.path.realpath(args.out) == os.path.realpath(
            os.path.join(REPO, "SIZES.json")):
        raise SystemExit("sizes bench: the repository's SIZES.json holds the JAX package's "
                         "numbers; give another --out")
    result = bench(args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
