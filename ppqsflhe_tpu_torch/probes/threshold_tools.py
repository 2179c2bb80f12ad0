"""The threshold tools' milliseconds on the card, and the share of them that
is host JSON and Base64 work.

At the size of ``chip_smoke.py`` phase 10's run C: run C's context
(``configs/oConfig.threshold.example.json``: N=2^14, depth 2, 40-bit
scale, 8192 slots) with ``"ntt_backend": "fourstep"``, four parties, the
GRU's 39,041 weights (its Keras layout, uniform(-1, 1)) encrypted under
the joint key, and party 2's σ of a 2-of-4 Shamir sharing. Each tool
(``threshold_partial_decrypt``, ``threshold_partial_decrypt_t`` with the
set {2, 4}, ``threshold_fuse_decrypt`` of the four partials) is called
``--calls`` times, each call synchronized: its first call and the median
of the rest (past the scheme's graph warm-up where the tree caches the
body). Beside each, the median of the tool's host half alone, run with
the tools' own helpers: reading and parsing its documents, Base64 decoding
and uploading, then downloading, Base64 encoding or decoding the slots,
and writing the result (no device body). Prints one JSON line with
``"card"`` and the fused weights' RMS error (the four floods: ≈0.1). It imports whichever ``ppqsflhe_tpu_torch`` comes first on the
path, so two checkouts are compared in one call by running this file from
each root in turns::

    PYTHONPATH=. python3 ppqsflhe_tpu_torch/probes/threshold_tools.py
    (cd <other root> && PYTHONPATH=. python3 <this file>)
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ppqsflhe_tpu_torch import convert
from ppqsflhe_tpu_torch.ckks import rlwe
from ppqsflhe_tpu_torch.ckks import serialize as ser
from ppqsflhe_tpu_torch.fl import api

GRU_SHAPES = ([7, 192], [64, 192], [2, 192], [64, 192], [64, 192], [2, 192], [64, 1], [1])
CC = {"multiplicative_depth": 2, "scaling_mod_size": 40, "batch_size": 8192,
      "ring_dim": 16384, "ntt_backend": "fourstep"}
PARTIES, T, SUBSET, CRS = 4, 2, [2, 4], 1234


def _ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def setup(tmp: str, dev: str) -> dict:
    """Run C's files: the context, shares, joint key, encrypted weights, σ."""
    p = lambda name: os.path.join(tmp, name)
    with open(p("cc_cfg.json"), "w") as f:
        json.dump(CC, f)
    api.gen_cc(p("cc_cfg.json"), p("CC.json"))
    for i in range(1, PARTIES + 1):
        api.threshold_keygen(p("CC.json"), CRS, p(f"sh{i}"), p(f"b{i}"), seed=10 + i, device=dev)
    api.threshold_combine_pubkey(p("CC.json"), CRS, [p(f"b{i}") for i in range(1, PARTIES + 1)],
                                 p("jpk"), device=dev)
    rng = np.random.default_rng(7)
    summary = []
    for i, shape in enumerate(GRU_SHAPES):
        v = rng.uniform(-1, 1, int(np.prod(shape)))
        summary.append({"layer": f"param_{i}", "shape": shape, "mean": float(v.mean()),
                        "std_dev": float(v.std()), "values": v.tolist()})
    with open(p("w.json"), "w") as f:
        json.dump({"weights_summary": summary}, f)
    api.encrypt_weights(p("CC.json"), p("jpk"), p("w.json"), p("enc"), seed=3, device=dev)
    outs = {i: [p(f"f{i}to{j}") for j in range(1, PARTIES + 1)] for i in range(1, PARTIES + 1)}
    for i in outs:
        api.threshold_shamir_share(p("CC.json"), p(f"sh{i}"), PARTIES, T, outs[i], seed=20 + i,
                                   device=dev)
    api.threshold_aggregate_shares(p("CC.json"), [outs[i][SUBSET[0] - 1] for i in outs],
                                   p("sig"), device=dev)
    return {"p": p, "values": sum(int(np.prod(s)) for s in GRU_SHAPES)}


def host_halves(f: dict, dev: str) -> dict:
    """Each tool's host half, as its helpers run it (the partials and the
    plaintext coefficients computed once beforehand)."""
    p = f["p"]
    sch = api.load_scheme(p("CC.json"), dev)
    enc, cts = api._doc_batch(sch, p("enc"))
    parts = torch.zeros(cts.data.shape[:-3] + cts.data.shape[-2:], dtype=torch.int64,
                        device=dev)
    l, n = cts.nlimbs, sch.params.n

    def partial(t_of_n: bool):
        if t_of_n:
            api._doc_array(ser.load_json(p("sig")), dev)
        else:
            ser.deserialize_secret_key(ser.load_json(p("sh2")), sch.ctx, dev)
        doc, _ = api._doc_batch(sch, p("enc"))
        ser.save_json(api._partials_doc(doc, parts), p("host_partial"))

    def fuse():
        doc, batch = api._doc_batch(sch, p("enc"))
        flat = [np.stack([ser._b64_to_arr(s, (l, n)) for _, _, _, s in api._doc_fields(
            ser.load_json(p(f"pd{i}")))]) for i in range(1, PARTIES + 1)]
        convert.residues(np.stack(flat), dev)
        host = batch.data[..., 0, :, :].cpu()
        vals = [rlwe.decode_coeffs(sch.ctx, c, batch, sch.encoder) for c in host]
        with open(p("host_plain"), "w") as fh:
            json.dump({"values": [float(x) for x in np.concatenate(vals)[: f["values"]]]}, fh)

    return {"threshold_partial_decrypt": lambda: partial(False),
            "threshold_partial_decrypt_t": lambda: partial(True),
            "threshold_fuse_decrypt": fuse}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("threshold_tools: needs a CUDA GPU")
    dev = "cuda:0"
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        f = setup(tmp, dev)
        p = f["p"]
        setup_s = time.perf_counter() - t0
        tools = {
            "threshold_partial_decrypt": lambda: api.threshold_partial_decrypt(
                p("CC.json"), p("sh2"), p("enc"), p("pd2"), seed=5, device=dev),
            "threshold_partial_decrypt_t": lambda: api.threshold_partial_decrypt_t(
                p("CC.json"), p("sig"), p("enc"), p("pt2"), SUBSET, SUBSET[0], seed=5,
                device=dev),
            "threshold_fuse_decrypt": lambda: api.threshold_fuse_decrypt(
                p("CC.json"), p("enc"), [p(f"pd{i}") for i in range(1, PARTIES + 1)],
                p("dec"), device=dev),
        }
        for i in (1, 3, 4):
            api.threshold_partial_decrypt(p("CC.json"), p(f"sh{i}"), p("enc"), p(f"pd{i}"),
                                          seed=i, device=dev)
        rows = {}
        for name, fn in tools.items():
            times = [_ms(fn) for _ in range(args.calls)]
            rows[name] = {"first_ms": times[0], "median_ms": statistics.median(times[3:]),
                          "ms": times}
        halves = host_halves(f, dev)
        for name, fn in halves.items():
            fn()
            host = statistics.median(_ms(fn) for _ in range(5))
            rows[name].update(host_ms=host, host_share=host / rows[name]["median_ms"])
        with open(p("dec")) as fh:
            got = np.concatenate([e["values"] for e in json.load(fh)["weights_summary"]])
        with open(p("w.json")) as fh:
            want = np.concatenate([e["values"] for e in json.load(fh)["weights_summary"]])
    result = {"probe": "threshold_tools", "tree": os.path.abspath(api.__file__),
              "values": f["values"], "decrypted": len(got),
              "rms_err": float(np.sqrt(np.mean((got - want) ** 2))), "calls": args.calls,
              "setup_s": setup_s, "tools": rows, "card": card}
    print(json.dumps(result))
    sys.stdout.flush()


if __name__ == "__main__":
    main()
