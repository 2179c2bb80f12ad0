"""CLI for the FL tools of the port, with the JAX CLI's positional
contracts and flags (twin of ``ppqsflhe_tpu.fl.cli``). The seven reference
binaries:

  python -m ppqsflhe_tpu_torch.fl.cli genCC <config_cc.json> <cc_out>
  python -m ppqsflhe_tpu_torch.fl.cli keyGen <cc> <pubkey_out> <privkey_out>
  python -m ppqsflhe_tpu_torch.fl.cli REkeyGen <cc> <own_sk> <peer_pk> <rekey_out>
  python -m ppqsflhe_tpu_torch.fl.cli encryptModelWeights <cc> <pubkey> <weights_in> <enc_out>
  python -m ppqsflhe_tpu_torch.fl.cli decryptModelWeights <cc> <privkey> <enc_in> <plain_out>
  python -m ppqsflhe_tpu_torch.fl.cli changeCipherDomain <cc> <rekey> <enc_in> <enc_out> [target_pk]
  python -m ppqsflhe_tpu_torch.fl.cli aggregateEncryptedWeights <cc> <agg_out> <enc_in1> <enc_in2> [...]

Local training (the reference's ``c_trainAndUpdate.py``; the ``CLIENT``
section of a client config):

  python -m ppqsflhe_tpu_torch.fl.cli [--seed S] train <c_config.json>

The threshold multiparty tools (ckks/threshold.py):

  python -m ppqsflhe_tpu_torch.fl.cli thresholdKeyGen <cc> <crs_seed> <share_out> <bshare_out>
  python -m ppqsflhe_tpu_torch.fl.cli thresholdCombine <cc> <crs_seed> <joint_pub_out> <bshare1> [...]
  python -m ppqsflhe_tpu_torch.fl.cli thresholdPartialDecrypt <cc> <share> <enc_in> <partial_out>
  python -m ppqsflhe_tpu_torch.fl.cli thresholdShamirShare <cc> <share> <n_parties> <t> <out1> ... <outN>
  python -m ppqsflhe_tpu_torch.fl.cli thresholdAggregateShares <cc> <sigma_out> <in1> [...]
  python -m ppqsflhe_tpu_torch.fl.cli thresholdPartialDecryptT <cc> <sigma> <enc_in> <partial_out> <party_id> <j1> ... <jt>
  python -m ppqsflhe_tpu_torch.fl.cli thresholdFuseDecrypt <cc> <enc_in> <plain_out> <partial1> [...]

``--device`` (before the subcommand) picks where the tools compute: the card
(``cuda``, the default) or ``cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import api


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ppqsflhe-fl-torch")
    p.add_argument("--seed", type=int, default=None, help="deterministic RNG seed")
    p.add_argument("--device", default="cuda", help="torch device the tools compute on")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("genCC")
    s.add_argument("config")
    s.add_argument("cc_out")

    s = sub.add_parser("keyGen")
    s.add_argument("cc")
    s.add_argument("pub_out")
    s.add_argument("priv_out")

    s = sub.add_parser("REkeyGen")
    s.add_argument("cc")
    s.add_argument("own_sk")
    s.add_argument("peer_pk")
    s.add_argument("rekey_out")

    s = sub.add_parser("encryptModelWeights")
    s.add_argument("cc")
    s.add_argument("pubkey")
    s.add_argument("weights_in")
    s.add_argument("enc_out")
    s.add_argument("--wire", choices=("native", "openfhe"), default="native",
                   help="ciphertext wire: native PQTC blobs, or the reference's OpenFHE "
                        "cereal-BINARY")
    s.add_argument("--binary", action="store_true",
                   help="write the PQWD raw-binary container instead of JSON+Base64 "
                        "(downstream tools detect and keep it)")

    s = sub.add_parser("decryptModelWeights")
    s.add_argument("cc")
    s.add_argument("privkey")
    s.add_argument("enc_in")
    s.add_argument("plain_out")

    s = sub.add_parser("changeCipherDomain")
    s.add_argument("cc")
    s.add_argument("rekey")
    s.add_argument("enc_in")
    s.add_argument("enc_out")
    s.add_argument("target_pubkey", nargs="?", default=None,
                   help="target-domain public key (required under PREMode INDCCA)")
    s.add_argument("--drop-limbs", type=int, default=0,
                   help="LevelReduce N limbs before the switch")
    s.add_argument("--keep-limbs", type=int, default=None,
                   help="reduce to exactly this many limbs before the switch")
    s.add_argument("--wire", choices=("native", "openfhe"), default="native")

    s = sub.add_parser("aggregateEncryptedWeights")
    s.add_argument("cc")
    s.add_argument("agg_out")
    s.add_argument("enc_in", nargs="+")
    s.add_argument("--lazy", action="store_true",
                   help="free ÷N (power-of-two client counts) + LevelReduce")
    s.add_argument("--wire", choices=("native", "openfhe"), default="native")

    s = sub.add_parser("train")
    s.add_argument("config")

    s = sub.add_parser("thresholdKeyGen")
    s.add_argument("cc")
    s.add_argument("crs_seed", type=int)
    s.add_argument("share_out")
    s.add_argument("bshare_out")

    s = sub.add_parser("thresholdCombine")
    s.add_argument("cc")
    s.add_argument("crs_seed", type=int)
    s.add_argument("joint_pub_out")
    s.add_argument("bshares", nargs="+")

    s = sub.add_parser("thresholdPartialDecrypt")
    s.add_argument("cc")
    s.add_argument("share")
    s.add_argument("enc_in")
    s.add_argument("partial_out")
    s.add_argument("--smudging-bits", type=int, default=None)

    s = sub.add_parser("thresholdShamirShare")
    s.add_argument("cc")
    s.add_argument("priv_share")
    s.add_argument("n_parties", type=int)
    s.add_argument("threshold", type=int)
    s.add_argument("share_outs", nargs="+", help="one output path per recipient party (1..N)")

    s = sub.add_parser("thresholdAggregateShares")
    s.add_argument("cc")
    s.add_argument("sigma_out")
    s.add_argument("incoming", nargs="+")

    s = sub.add_parser("thresholdPartialDecryptT")
    s.add_argument("cc")
    s.add_argument("sigma")
    s.add_argument("enc_in")
    s.add_argument("partial_out")
    s.add_argument("party_id", type=int)
    s.add_argument("party_set", nargs="+", type=int, help="the t participating party ids")
    s.add_argument("--smudging-bits", type=int, default=None)

    s = sub.add_parser("thresholdFuseDecrypt")
    s.add_argument("cc")
    s.add_argument("enc_in")
    s.add_argument("plain_out")
    s.add_argument("partials", nargs="+")

    args = p.parse_args(argv)
    dev = args.device
    t0 = time.time()
    if args.cmd == "genCC":
        api.gen_cc(args.config, args.cc_out)
    elif args.cmd == "keyGen":
        api.key_gen(args.cc, args.pub_out, args.priv_out, seed=args.seed, device=dev)
    elif args.cmd == "REkeyGen":
        api.rekey_gen(args.cc, args.own_sk, args.peer_pk, args.rekey_out, seed=args.seed,
                      device=dev)
    elif args.cmd == "encryptModelWeights":
        api.encrypt_weights(args.cc, args.pubkey, args.weights_in, args.enc_out,
                            seed=args.seed, wire=args.wire,
                            container="bin" if args.binary else "json", device=dev)
    elif args.cmd == "decryptModelWeights":
        api.decrypt_weights(args.cc, args.privkey, args.enc_in, args.plain_out, device=dev)
    elif args.cmd == "changeCipherDomain":
        api.change_cipher_domain(args.cc, args.rekey, args.enc_in, args.enc_out,
                                 pub_path=args.target_pubkey, seed=args.seed,
                                 drop_limbs=args.drop_limbs, wire=args.wire,
                                 keep_limbs=args.keep_limbs, device=dev)
    elif args.cmd == "aggregateEncryptedWeights":
        api.aggregate_encrypted_weights(args.cc, args.enc_in, args.agg_out, lazy=args.lazy,
                                        wire=args.wire, device=dev)
    elif args.cmd == "thresholdKeyGen":
        api.threshold_keygen(args.cc, args.crs_seed, args.share_out, args.bshare_out,
                             seed=args.seed, device=dev)
    elif args.cmd == "thresholdCombine":
        api.threshold_combine_pubkey(args.cc, args.crs_seed, args.bshares, args.joint_pub_out,
                                     device=dev)
    elif args.cmd == "thresholdPartialDecrypt":
        api.threshold_partial_decrypt(args.cc, args.share, args.enc_in, args.partial_out,
                                      seed=args.seed, smudging_bits=args.smudging_bits,
                                      device=dev)
    elif args.cmd == "thresholdShamirShare":
        api.threshold_shamir_share(args.cc, args.priv_share, args.n_parties, args.threshold,
                                   args.share_outs, seed=args.seed, device=dev)
    elif args.cmd == "thresholdAggregateShares":
        api.threshold_aggregate_shares(args.cc, args.incoming, args.sigma_out, device=dev)
    elif args.cmd == "thresholdPartialDecryptT":
        api.threshold_partial_decrypt_t(args.cc, args.sigma, args.enc_in, args.partial_out,
                                        args.party_set, args.party_id, seed=args.seed,
                                        smudging_bits=args.smudging_bits, device=dev)
    elif args.cmd == "thresholdFuseDecrypt":
        api.threshold_fuse_decrypt(args.cc, args.enc_in, args.partials, args.plain_out,
                                   device=dev)
    elif args.cmd == "train":
        from ..train.trainer import train_client

        with open(args.config) as f:
            cfg = json.load(f)["CLIENT"]
        train_client(cfg, seed=args.seed or 0, device=dev)
    print(f"[{args.cmd}] done in {time.time() - t0:.2f}s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
