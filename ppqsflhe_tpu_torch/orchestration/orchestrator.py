"""FL rounds orchestrator — orchestration/run.sh as a Python program
(reference lifecycle SURVEY.md §3.1), on the port's tools and trainer.

Twin of ``ppqsflhe_tpu.orchestration.orchestrator``: the same phases, step
log and file tree. ``OrchestratorConfig.device`` (the card unless the
caller names another) goes to every tool and to the trainer; a round's
result also carries each trained client's summary (epochs, validation MSE
before and after, warm start).

Init phase (run.sh:55-62):
  gen_cc → start artifact server → distribute CC → per-client keyGen →
  upload pubkeys → cross-distribute peer pubkeys → per-client REkeyGen →
  upload rekeys.

Each round (run.sh:28-44):
  per-client local training → encrypt weights → upload →
  PRE every non-hub client into the hub domain (changeCipherDomain) →
  homomorphic aggregate (FedAvg) → PRE the aggregate back to each client →
  download → decrypt → (next round warm-starts from the decrypted global).

Generalized to N clients (the reference hardcodes 2 with hub = client 2 —
server_fns.sh:62-80); transports: 'http' (reference MONGOOSE mode) or
'local' (the COMM_MODE != MONGOOSE cp fallback, comm_fns.sh:14-18).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from datetime import datetime
from typing import Dict, List

from ..ckks import serialize as ser
from ..comm.client import CommClient
from ..comm.server import ArtifactServer
from ..fl import api


def log(role: str, step: str, msg: str) -> None:
    """Structured logger matching helper_fns.sh:141-146 (ms resolution so
    the step log doubles as a per-step profile — bench_orchestrated.py)."""
    print(f"[{datetime.now().isoformat(timespec='milliseconds')}] [{role}] [{step}] {msg}", flush=True)


@dataclass
class OrchestratorConfig:
    rounds: int = 5                       # oConfig.json ROUNDS
    n_clients: int = 2
    work_dir: str = "./fl_run"
    comm_mode: str = "local"              # 'http' | 'local'
    host: str = "127.0.0.1"
    port: int = 0                         # 0 → ephemeral
    cc_config: Dict = field(default_factory=dict)  # config_cc.json schema
    client_configs: List[Dict] = field(default_factory=list)  # CLIENT sections
    seed: int = 1234
    train: bool = True                    # False → clients must provide weights JSONs
    # Failure handling (beyond the reference's set -e fail-fast,
    # SURVEY.md §5.3): a client whose train/encrypt/upload step raises is
    # DROPPED from the round; the server aggregates over the survivors as
    # long as at least `min_clients` (and the hub, whose key domain hosts
    # the aggregation) are present. Dropped clients rejoin automatically
    # next round (they warm-start from their last decrypted global).
    # fail_fast=True restores reference semantics (first error aborts).
    fail_fast: bool = False
    min_clients: int = 1
    # Protocol: 'pre' = the reference's proxy-re-encryption dance (hub key
    # domain, changeCipherDomain in/out — SURVEY.md §3.1); 'threshold' =
    # N-of-N multiparty CKKS (ckks/threshold.py): clients share a JOINT key,
    # the server round is pure aggregation (no PRE key switches), and
    # decryption is distributed (each client publishes a smudged partial;
    # everyone fuses). The reference's CryptoContext enables the MULTIPARTY
    # feature flag without using it; this mode is that capability.
    protocol: str = "pre"                 # 'pre' | 'threshold'
    smudging_bits: int | None = None      # threshold-mode flooding noise
    # Lazy level management: LevelReduce each inbound ciphertext one limb
    # before the PRE key switch (free modulus switch — fl.api
    # change_cipher_domain drop_limbs). Cuts the server round's NTT count
    # ~1/3 and shrinks the domain-changed payloads; precision unchanged.
    # Off by default = reference full-level schedule.
    lazy_levels: bool = False
    # Raw-binary artifact container (PQWD, serialize.save_enc_doc): the
    # encrypted-weights/domain-changed/aggregate files skip Base64 (~25%
    # smaller wires). The transports move opaque files, so this composes
    # with both comm modes; every downstream tool auto-detects the
    # container. Off by default = reference JSON file shapes.
    binary_wire: bool = False
    device: str = "cuda"                  # every tool's and the trainer's device


class Orchestrator:
    def __init__(self, cfg: OrchestratorConfig):
        self.cfg = cfg
        self.server_storage = os.path.join(cfg.work_dir, "server_storage")
        self.client_dirs = [
            os.path.join(cfg.work_dir, f"client_{i + 1}") for i in range(cfg.n_clients)
        ]
        for d in [self.server_storage] + self.client_dirs:
            os.makedirs(d, exist_ok=True)
        self.server: ArtifactServer | None = None
        self.hub = cfg.n_clients  # aggregation domain = last client (reference: C2)

    # -- helpers ------------------------------------------------------------

    def _client_comm(self, i: int) -> CommClient:
        base = f"http://{self.cfg.host}:{self.server.port}" if self.server else ""
        return CommClient(
            base_url=base, role=f"client_{i}", mode=self.cfg.comm_mode,
            local_storage_root=self.server_storage,
            metrics_csv=os.path.join(self.cfg.work_dir, "metrics", "comm_metrics.csv"),
        )

    def _cpath(self, i: int, name: str) -> str:
        return os.path.join(self.client_dirs[i - 1], name)

    # -- init phase ---------------------------------------------------------

    # -- run-state checkpoint (SURVEY.md §5.4 FL-state resume, extended to
    # the whole orchestration: crypto material and decrypted globals already
    # persist on disk; this records WHERE in the lifecycle the run is so a
    # killed orchestrator restarts without regenerating keys or re-running
    # completed rounds) --------------------------------------------------

    @property
    def _state_path(self) -> str:
        return os.path.join(self.cfg.work_dir, "orchestrator_state.json")

    def _save_state(self, init_done: bool, completed_rounds: int) -> None:
        with open(self._state_path, "w") as f:
            json.dump({
                "init_done": init_done,
                "completed_rounds": completed_rounds,
                "n_clients": self.cfg.n_clients,
                "protocol": self.cfg.protocol,
            }, f)

    def _load_state(self) -> Dict | None:
        if not os.path.exists(self._state_path):
            return None
        with open(self._state_path) as f:
            state = json.load(f)
        for key in ("n_clients", "protocol"):
            want = getattr(self.cfg, key)
            if state.get(key) != want:
                raise ValueError(
                    f"resume mismatch: checkpoint has {key}={state.get(key)!r} "
                    f"but config says {want!r} (start a fresh work_dir)")
        return state

    def _start_server(self) -> None:
        if self.cfg.comm_mode == "http" and self.server is None:
            log("server", "Mserver", "starting artifact server")
            self.server = ArtifactServer(
                self.server_storage, self.cfg.host, self.cfg.port,
                metrics_csv=os.path.join(self.cfg.work_dir, "metrics",
                                         "server_comm_metrics.csv"),
            ).start()

    def init_phase(self):
        cfg = self.cfg
        log("server", "genCC", "generating crypto context")
        cc_server = os.path.join(self.server_storage, "CC.json")
        api.gen_cc(cfg.cc_config, cc_server)

        self._start_server()

        if cfg.protocol == "threshold":
            self._init_threshold()
            return

        # distribute CC, generate keys, upload pubkeys
        for i in range(1, cfg.n_clients + 1):
            comm = self._client_comm(i)
            cc_i = self._cpath(i, "CC.json")
            comm.get("/getCC", cc_i, client_id=f"client_{i}", type_="cc")
            log(f"client_{i}", "keyGen", "RLWE keypair")
            api.key_gen(cc_i, self._cpath(i, f"client_{i}-public.key"),
                        self._cpath(i, f"client_{i}-private.key"), seed=cfg.seed + i,
                        device=cfg.device)
            comm.post_file(f"/uploadPubKeyC{i}", self._cpath(i, f"client_{i}-public.key"),
                           client_id=f"client_{i}", type_="pubkey")

        # cross-distribute peer pubkeys + generate re-encryption keys
        # (client i needs rekey i→hub; hub needs rekey hub→i for the return trip)
        hub = self.hub
        for i in range(1, cfg.n_clients + 1):
            comm = self._client_comm(i)
            peers = [hub] if i != hub else [j for j in range(1, cfg.n_clients + 1) if j != hub]
            for j in peers:
                peer_pk = self._cpath(i, f"client_{j}-public.key")
                comm.get(f"/download/client_{j}/client_{j}-public.key", peer_pk,
                         client_id=f"client_{i}", type_="peer_pubkey")
                log(f"client_{i}", "REkeyGen", f"PRE key client_{i}→client_{j}")
                rk = self._cpath(i, f"client_{i}-to-{j}-ReKey.key")
                api.rekey_gen(self._cpath(i, "CC.json"),
                              self._cpath(i, f"client_{i}-private.key"), peer_pk, rk,
                              seed=cfg.seed + 100 * i + j, device=cfg.device)
                comm.post_file(f"/uploadReKeyC{i}", rk, client_id=f"client_{i}", type_="rekey")

    def _init_threshold(self):
        """Threshold-mode init: distribute CC, every client generates a
        secret share + public b-share over the shared CRS, server combines
        the joint public key and redistributes it."""
        cfg = self.cfg
        crs_seed = cfg.seed  # public; any agreed value works
        for i in range(1, cfg.n_clients + 1):
            comm = self._client_comm(i)
            cc_i = self._cpath(i, "CC.json")
            comm.get("/getCC", cc_i, client_id=f"client_{i}", type_="cc")
            log(f"client_{i}", "thresholdKeyGen", "secret share + public b-share")
            api.threshold_keygen(cc_i, crs_seed,
                                 self._cpath(i, f"client_{i}-share.key"),
                                 self._cpath(i, f"client_{i}-bshare.key"),
                                 seed=cfg.seed + i, device=cfg.device)
            comm.post_file(f"/uploadPubKeyC{i}", self._cpath(i, f"client_{i}-bshare.key"),
                           client_id=f"client_{i}", type_="pub_share")
        log("server", "thresholdCombine", "combining joint public key")
        shares = [os.path.join(self.server_storage, f"client_{i}",
                               f"client_{i}-bshare.key")
                  for i in range(1, cfg.n_clients + 1)]
        joint = os.path.join(self.server_storage, "joint-public.key")
        api.threshold_combine_pubkey(
            os.path.join(self.server_storage, "CC.json"), crs_seed, shares, joint,
            device=cfg.device)
        for i in range(1, cfg.n_clients + 1):
            self._client_comm(i).get("/download/joint-public.key",
                                     self._cpath(i, "joint-public.key"),
                                     client_id=f"client_{i}", type_="joint_pubkey")

    # -- one round ----------------------------------------------------------

    def _client_round_step(self, r: int, i: int) -> Dict | None:
        """Train + encrypt + upload for one client (the per-client failure
        domain for dropout handling). Returns the training summary, or None
        without training."""
        cfg = self.cfg
        ccfg = dict(cfg.client_configs[i - 1]) if cfg.client_configs else {}
        weights = ccfg.get("INPUT_WEIGHTS_PATH") or self._cpath(i, "weights.json")
        summary = None
        if cfg.train:
            log(f"client_{i}", "training", f"round {r} local training")
            from ..train.trainer import train_client

            ccfg.setdefault("client_id", f"client_{i}")
            ccfg["INPUT_WEIGHTS_PATH"] = weights
            ccfg.setdefault("OUTPUT_DECRYPTED_WEIGHTS_PATH",
                            self._cpath(i, "decrypted_weights.json"))
            res = train_client(ccfg, seed=cfg.seed + 1000 * r + i, verbose=False,
                               device=cfg.device)
            summary = {"epochs": len(res.history["loss"]), "best_epoch": res.best_epoch,
                       "val_mse_init": res.val_mse_init,
                       "val_mse": min(res.history["val_loss"], default=None),
                       "warm_start": res.warm_start}
        log(f"client_{i}", "encrypt", "encrypting weights")
        enc = self._cpath(i, f"encrypted_weights_c{i}.json")
        # threshold mode encrypts under the JOINT public key (no single
        # holder of the matching secret); PRE mode encrypts under the
        # client's OWN key, so the secret key is local — use the seeded
        # compact wire (c0 + 16-byte seed per ct, ~2x smaller uploads)
        key = ("joint-public.key" if cfg.protocol == "threshold"
               else f"client_{i}-private.key")
        api.encrypt_weights(self._cpath(i, "CC.json"), self._cpath(i, key),
                            weights, enc, seed=cfg.seed + 2000 * r + i,
                            container="bin" if cfg.binary_wire else "json", device=cfg.device)
        self._client_comm(i).post_file(f"/uploadEncWeightsC{i}", enc,
                                       client_id=f"client_{i}", type_="enc_weights")
        return summary

    def run_round(self, r: int) -> Dict:
        cfg = self.cfg
        hub = self.hub
        t_round = time.time()
        # 1) local training + encrypt + upload; failed clients drop out
        active: List[int] = []
        dropped: List[int] = []
        training: Dict[int, Dict] = {}
        for i in range(1, cfg.n_clients + 1):
            try:
                summary = self._client_round_step(r, i)
                active.append(i)
                if summary is not None:
                    training[i] = summary
            except Exception as e:
                if cfg.fail_fast:
                    raise
                dropped.append(i)
                log(f"client_{i}", "dropout",
                    f"round {r}: dropped ({type(e).__name__}: {e}); "
                    "will rejoin next round")
        if cfg.protocol != "threshold" and hub not in active:
            raise RuntimeError(
                f"round {r}: hub client_{hub} dropped — the aggregation key "
                "domain is unavailable (no rekeys into a replacement hub)")
        if len(active) < max(cfg.min_clients, 1):
            raise RuntimeError(
                f"round {r}: only {len(active)} active clients "
                f"(< min_clients={cfg.min_clients})")
        if cfg.protocol == "threshold":
            return dict(self._finish_round_threshold(r, t_round, active, dropped),
                        training=training)

        # 2) server: PRE non-hub clients into hub domain
        cc_server = os.path.join(self.server_storage, "CC.json")

        def pubkey_of(j: int) -> str | None:
            """Target-domain pubkey for INDCCA re-randomization (the server
            holds every client's uploaded pubkey); None under INDCPA."""
            if ser.load_params(cc_server).pre_mode != "INDCCA":
                return None
            return os.path.join(self.server_storage, f"client_{j}",
                                f"client_{j}-public.key")

        hub_domain_files = []
        for i in active:
            src = os.path.join(self.server_storage, f"client_{i}",
                               f"encrypted_weights_c{i}.json")
            if i == hub:
                hub_domain_files.append(src)
                continue
            log("server", "changeCipherDomain", f"client_{i} → client_{hub} domain")
            rekey = os.path.join(self.server_storage, f"client_{i}",
                                 f"client_{i}-to-{hub}-ReKey.key")
            dst = os.path.join(self.server_storage, f"c{i}_domainChange_c{hub}.json")
            api.change_cipher_domain(cc_server, rekey, src, dst,
                                     pub_path=pubkey_of(hub),
                                     seed=cfg.seed + 4000 * r + i,
                                     drop_limbs=1 if cfg.lazy_levels else 0, device=cfg.device)
            hub_domain_files.append(dst)

        # 3) homomorphic FedAvg in the hub domain (over the active subset)
        log("server", "aggregate",
            f"FedAvg over {len(active)}/{cfg.n_clients} clients")
        agg = os.path.join(self.server_storage, "aggregated_weights.json")
        api.aggregate_encrypted_weights(cc_server, hub_domain_files, agg,
                                        lazy=cfg.lazy_levels, device=cfg.device)

        # 4) PRE the aggregate back to each active client + distribute
        for i in active:
            if i == hub:
                src_rel = "aggregated_weights.json"
            else:
                log("server", "changeCipherDomain", f"aggregate → client_{i} domain")
                rekey = os.path.join(self.server_storage, f"client_{hub}",
                                     f"client_{hub}-to-{i}-ReKey.key")
                dst = os.path.join(self.server_storage,
                                   f"c{hub}_domainChange_c{i}.json")
                # lazy: the downlink is decrypt-only (clients warm-start from
                # the plaintext), so LevelReduce to ONE tower before the
                # final switch — message Δ·m + noise ≪ q0 = 2^60 keeps full
                # precision, the switch does 1/2 the NTT work, and the
                # artifact that moves every round shrinks ~2x again.
                api.change_cipher_domain(cc_server, rekey, agg, dst,
                                         pub_path=pubkey_of(i),
                                         seed=cfg.seed + 5000 * r + i,
                                         keep_limbs=1 if cfg.lazy_levels else None,
                                         device=cfg.device)
                src_rel = os.path.basename(dst)
            dest = self._cpath(i, "aggregated_for_me.json")
            self._client_comm(i).get(f"/download/{src_rel}", dest,
                                     client_id=f"client_{i}", type_="aggregated")
            log(f"client_{i}", "decrypt", "decrypting aggregate")
            api.decrypt_weights(self._cpath(i, "CC.json"),
                                self._cpath(i, f"client_{i}-private.key"),
                                dest, self._cpath(i, "decrypted_weights.json"),
                                device=cfg.device)
        dt = time.time() - t_round
        log("orchestrator", "round", f"round {r} complete in {dt:.1f}s "
            f"({len(active)} active, {len(dropped)} dropped)")
        return {"round": r, "seconds": dt, "active": active, "dropped": dropped,
                "training": training}

    def _finish_round_threshold(self, r: int, t_round: float,
                                active: List[int], dropped: List[int]) -> Dict:
        """Threshold-mode server half: aggregate under the joint key (no PRE),
        then one distributed-decryption round. EVERY client (incl. a client
        that dropped out of training) contributes its partial — N-of-N
        threshold decryption needs all shares; a share-holder that is truly
        unreachable stalls the round by construction."""
        cfg = self.cfg
        cc_server = os.path.join(self.server_storage, "CC.json")
        enc_files = [os.path.join(self.server_storage, f"client_{i}",
                                  f"encrypted_weights_c{i}.json") for i in active]
        log("server", "aggregate",
            f"joint-key FedAvg over {len(active)}/{cfg.n_clients} clients (no PRE)")
        agg = os.path.join(self.server_storage, "aggregated_weights.json")
        api.aggregate_encrypted_weights(cc_server, enc_files, agg, device=cfg.device)

        # distributed decryption: every share-holder downloads the aggregate,
        # publishes a smudged partial; then each client fuses all partials.
        for i in range(1, cfg.n_clients + 1):
            dest = self._cpath(i, "aggregated_for_me.json")
            self._client_comm(i).get("/download/aggregated_weights.json", dest,
                                     client_id=f"client_{i}", type_="aggregated")
            log(f"client_{i}", "partialDecrypt", "publishing decryption share")
            part = self._cpath(i, f"partial_c{i}.json")
            api.threshold_partial_decrypt(
                self._cpath(i, "CC.json"), self._cpath(i, f"client_{i}-share.key"),
                dest, part, seed=cfg.seed + 3000 * r + i,
                smudging_bits=cfg.smudging_bits, device=cfg.device)
            self._client_comm(i).post_file(f"/uploadEncWeightsC{i}", part,
                                           client_id=f"client_{i}", type_="partial_dec")
        for i in range(1, cfg.n_clients + 1):
            comm = self._client_comm(i)
            parts = []
            for j in range(1, cfg.n_clients + 1):
                p = self._cpath(i, f"peer_partial_c{j}.json")
                comm.get(f"/download/client_{j}/partial_c{j}.json", p,
                         client_id=f"client_{i}", type_="peer_partial")
                parts.append(p)
            log(f"client_{i}", "fuseDecrypt", "fusing decryption shares")
            api.threshold_fuse_decrypt(
                self._cpath(i, "CC.json"), self._cpath(i, "aggregated_for_me.json"),
                parts, self._cpath(i, "decrypted_weights.json"), device=cfg.device)
        dt = time.time() - t_round
        log("orchestrator", "round", f"round {r} complete in {dt:.1f}s "
            f"({len(active)} active, {len(dropped)} dropped)")
        return {"round": r, "seconds": dt, "active": active, "dropped": dropped}

    # -- full run -----------------------------------------------------------

    def run(self, resume: bool = False) -> List[Dict]:
        """Drive init + rounds. ``resume=True`` picks up a checkpointed run
        in the same work_dir: init (key material) is skipped if already
        done and only rounds after the last completed one execute."""
        t0 = time.time()
        state = self._load_state() if resume else None
        if state and state.get("init_done"):
            self._start_server()
            first = int(state["completed_rounds"]) + 1
            log("orchestrator", "resume",
                f"checkpoint found: init done, {first - 1} rounds complete — "
                f"resuming at round {first}")
        else:
            self.init_phase()
            self._save_state(init_done=True, completed_rounds=0)
            log("orchestrator", "init",
                f"init phase complete in {time.time() - t0:.1f}s")
            first = 1
        results = []
        for r in range(first, self.cfg.rounds + 1):
            results.append(self.run_round(r))
            self._save_state(init_done=True, completed_rounds=r)
        if self.server:
            self.server.stop()
        return results
