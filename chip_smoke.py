#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

Drives the port's paths through ``ppqsflhe_tpu_torch``:

- **the server round** of ``bench.py`` (2 clients × 27 ciphertexts at
  N=2^14, the ``CkksParams.generate(n=2^14, mult_depth=2, dnum=2)`` chain),
  once in each schedule (lazy-4 and full level);
- **hoisted Galois rotations** of ``bench_rotations.py`` (R=8 rotations
  {1, 2, 4, …, 128} of one ciphertext at N=2^15 on
  ``CkksParams.generate(n=2^15, mult_depth=2, dnum=2)``: Q = 60/40/40 bits,
  P = 2 × 60 bits), plain, hoisted and as a double-hoisted rotation sum,
  plus one packed inner product;
- **the NTT north star** of ``bench_kernels.py:53-99`` (the four-step
  runner over ``first_prime_down(59, 2N)`` + 3 × 40-bit primes, chained
  transforms, forward then inverse) at N=2^14 (B=27) and N=2^16 (B=8), in
  both implementations: the digit-matmul route (kernel 1 at 2^14; kernels
  4+5 and 1b at 2^16) and the butterfly, kernel 6;
- **the server round at N=2^16** (``ring_dim: 65536`` with the reference's
  other CC settings, 8192 slots), both schedules: kernel 1b on the 40-bit
  limbs, kernels 4+5 on the 60-bit ones, 2 and 3 (at every digit count, as
  in every round); then the
  device memory of the context's NTT tables, and the big route's transforms
  on the 60-bit limbs bit-equal to kernel 6's and kernel 1b's;
- **the butterfly configuration** of the N=2^14 round (``ntt_impl="pallas"``:
  kernel 6 runs every NTT), both schedules, bit-equal to the default round;
- **the seven FL tools on files** (``ppqsflhe_tpu_torch.fl.api``) at N=2^14
  in a temporary directory: ``configs/config_cc.json`` as genCC writes it
  (radix-2, JSON container) and the same with the four-step digit-matmul
  NTT (PQWD container); two clients' GRU weights (39,041 values, 27
  ciphertexts each, one optimizer layer skipped), keyGen ×2, REkeyGen both
  ways, pk (dense v2) and sk (seeded v3) encryption, changeCipherDomain,
  aggregation, changeCipherDomain back, both decrypts; then one INDCCA hop
  under ``configs/config_cc_indcca.json``;
- **the multikey round** of ``bench_multikey.py`` (``BASELINE.json`` config
  5) through ``ppqsflhe_tpu_torch.bench.multikey``: 16 clients × 154
  ciphertexts (the stacked LSTM's 1,091,101 values) at N=2^14, 15 PREs into
  the hub, FedAvg ÷16, 15 PREs out, in both schedules; the whole average
  decrypted under the hub's key and the outbound ciphertexts of clients 0
  and 14 under theirs (error < 1e-3); ms per round, rounds/s, device ms
  by kernel, host enqueue and idle share;
- **threshold CKKS** at 16 parties on the same chain: the CRS (its SHA-256
  equal to the JAX package's), 16 key shares and the joint key, each
  party's 154 ciphertexts encrypted under it, ``multikey.aggregate_local``,
  16 batched partial decryptions and the fusion (the error's RMS within
  0.9–1.1 σ = √(16·N/6)·2^30/Δ and its max below 6 σ; below 1e-3 with no
  flood), then Shamir 9-of-16: the sets {1..9} and {8..16} decrypt by the
  same gate at 9 parties, {1..8} does not (max error > 1);
- **kernel 7**, the tensor-core / integer-chain overlap probe of
  ``probes/mxu_vpu_overlap.py`` at its shapes (K=64 cells, m=256, nd=6,
  c=256): µs/cell for its four orders, scan-marginal over chained launches
  (each chain one CUDA graph, every launch's output held to the plain
  version after every replay), the ``wgmma`` design's split (CTAs a cell,
  warpgroups a CTA), the mxu order's int8 rate and the share of the
  possible overlap. Its JSON rows carry the scan's µs per launch as
  ``ms`` (``"timing": "scan"``) and the profiler's per call beside it;
- **the orchestrated FL loop** (``ppqsflhe_tpu_torch.orchestration``,
  local GRU training at full width, the artifact server, the rounds) in
  three runs, each fail-fast in a temporary directory on numpy-seeded
  synthetic CSVs (hourly over July 2024; the reference's are not in the
  repository): A, ``configs/oConfig.example.json`` (PRE, 2 clients over
  http, lazy levels, radix-2) cut to 2 rounds (the second through
  ``resume``) and 3 epochs; B, the twin of ``bench_orchestrated.py``
  (``bench/orchestrated.py``: reference chain, PQWD wire, no training); C,
  ``configs/oConfig.threshold.example.json`` (4 clients) for 1 round of 3
  epochs with ``"ntt_backend": "fourstep"`` added. Gates: no client dropped
  (a kernel failure must not pass as a dropout); each client's decrypt
  equals the mean of the exported weights within 1e-3 (C: within the
  flood's σ, phase 8's gate) and the clients agree; round 2 of A starts
  from round 1's decrypt; round 1 lowers every client's validation MSE;
  the GRU forward on the card is within 1e-4 of the CPU's (the clients
  train through ``train_client``'s CUDA graphs); kernels 2 and 3
  (A, B) and 1 (C) launched and are bit-equal at the run's shapes; C's
  threshold tools captured and replayed their graphs (the fused documents
  of eager calls and replays the same bytes). Then
  each round's per-step table (the step log), ms per eager training step
  and epoch, and the device's idle share over one eager epoch and one warm
  round of B;
- **the bench twins** (``ppqsflhe_tpu_torch.bench``): ``server_round`` (the
  twin of ``bench.py``) in all five schedules, ``rotations``
  (``bench_rotations.py``), ``kernels`` (``bench_kernels.py``: the NTT north
  star and the key switch on the 60/40/40 chain and on the FLEXIBLEAUTOEXT
  chain, ``extra_mod_bits=20``) and ``sizes`` (``bench_sizes.py``), each
  printing its JSON line (``[twin json]``) behind its gates, then one
  changeCipherDomain and aggregation on the OpenFHE cereal wire
  (``wire="openfhe"``), parsed back and decrypted (< 1e-3); kernels 1, 2
  and 3 at the FLEXIBLEAUTOEXT chain's shapes (the 20-bit limb, the digit
  {q2, q3}, nd=2 over LK=6) are held to their plain versions first. The
  phase prints its seconds;
- **the sharded server round** (``ppqsflhe_tpu_torch.parallel``, the
  twin of ``bench_sharded.py``) on a one-rank NCCL group, client 1 × coef
  1, at full width: first kernels 4 and 5 at every per-shard shape of a
  coef axis of D ∈ {2, 4, 8} ranks (N=2^14 on the round's QP chain, N=2^16
  on ``bench_kernels.py``'s; N=2^12 at D ∈ {2, 4} and N=2^10 at D=2 for
  the m = 64 and 32 instances): every shard's column block at col0 = k·c
  bit-equal to the plain stage A, the blocks exchanged as the tiled
  all-to-all exchanges them, every rank's rows bit-equal to the plain
  stage B and the stitched result to the replicated transform; kernels 2
  and 3 at a shard's width N/D. Then the main path: ``fedavg_round_sharded``
  and ``fl.api.server_round`` over the sharded context (lazy-4 and full)
  on phase 1's inputs, bit-equal to phase 1's replicated round and
  decrypting within 1e-3, with kernels 4, 5, 2 and 3 launched and kernel 1
  not (11 all-to-alls and one all-reduce a round); a sharded rotation and
  conjugation bit-equal to the scheme's; ``joint_public_key_sharded`` and
  ``partial_decrypt_psum`` at 16 local parties (bit-equal to the joint key
  and to the single-device fusion, RMS error 0.9–1.1 σ); the mesh graphs
  (``[mesh graphs]``): the five sharded compositions
  (``sctx.cached_graph``: re-encryption, rotation, conjugation, hoisted
  rotations, the FedAvg round) and ``aggregate_sharded``, the joint key and
  ``partial_decrypt_psum`` (``utils.graphs.group_cache``) each captured as a
  CUDA graph with its NCCL collectives and replayed three times or more on
  fresh inputs, each call ``torch.equal`` to its eager body, their kernel
  launches and collectives a replay (the round's: 11 all-to-alls and one
  all-reduce), the MiB they reserved, freed before the group is destroyed,
  and a replay after that refused; the twin ``bench/sharded.py`` in both
  schedules (``[twin json]``: the eager sharded round's marginal and the
  compiled one's, each replay of the compiled round bit-equal, beside the
  replicated round per-op cached and compiled); and ``runtime/`` built
  with make, its artifact server answering ``/getCC`` and ``/download/``.
  The phase prints its seconds;
- **small rings and narrow shards** (phase 13): kernels 1, 1b and 6 at
  m = 8 and 16 (N = 2^6 … 2^9 on ``bench_kernels.py``'s chain, 4 limbs ×
  27 polys), every launch of both stages or passes, forward and inverse,
  bit-equal to its plain version, the whole forward transforms timed (1
  and 1b also held to the digit transform, on the CPU: cuBLAS's int8
  product refuses the small digit matrices); kernels 4 and 5 there as a
  one-rank coef axis, and on shards narrower than a 16-wide tile: N=2^12
  at D = 8, 16, 32, 64 (c = 8, 4, 2, 1), N=2^14 at D = 16, 32 and N=2^16
  at D = 32, every shard bit-equal and the stitched shards equal to the
  replicated transform; kernels 2 and 3 at the small rounds' shapes. Rows
  are timed at N = 2^7 (n1 = 8, n2 = 16: both instances and 8-wide
  tiles), at D = 64 of N=2^12 (1-wide tiles), and for kernels 2 and 3 at
  N = 2^9. Then the main
  path: ``bench.py``'s server round at N = 2^8 and 2^9 in both schedules through
  the default route (kernels 1, 2 and 3 launched, decrypt error < 1e-3,
  bit-equal to the same round run on the CPU, ms/round), the N = 2^8 round
  in the butterfly configuration (kernel 6, bit-equal to it), and
  ``bench.scaling``'s three paths at D = 1 on the JAX bench's shapes (the
  aggregation at N=256) on a one-rank NCCL group, its collectives equal
  to ``SCALING_MODEL.json``'s D = 1 row. The phase prints its seconds;
- **the compiled server round** (phase 14, ``fl/compiled.py``): the round
  captured once as a CUDA graph (``CompiledRound``) for the N=2^14 round in
  all five schedules, the same round on the radix-2 order (plain-torch
  NTTs, a world of its own), the butterfly configuration and the N=2^16
  round at lazy-4 and full level, on the earlier phases' worlds; each case 20
  chained replays (each rewriting one residue of client 1's stack from
  the previous replay's checksum, its outputs poisoned before it) held
  with ``torch.equal`` to the eager round on the same inputs, the first
  decrypting within 1e-3; the graph must hold every kernel of its round
  and its replays must run them (``fl.compiled.replayed``); then the
  eager and the compiled round's wall, host enqueue, device ms and idle.
  The phase prints its seconds;
- **the compiled training step** (phase 15, ``train/compiled.py``): the
  GRU (7 -> 64 -> 64 -> 1, 39,041 parameters), the LSTM (hidden 300), the
  MLP and the transformer at their default widths on run A's client 1
  data, each trained 2 epochs by ``train_client`` on the card (its step
  and validation MSE as CUDA graphs: 2 eager warm-up steps, then replays)
  and by the eager trainer from the same weights and seeds; every batch
  MSE, validation MSE, the best epoch's weights and, after the last
  epoch, the weights, Adam moments and count ``torch.equal``, the graphs
  replayed at every later step and evaluation; then eager and compiled ms
  a step and an epoch (synchronized host clock, median), device ms and
  launches of a step and an epoch's device ms and idle share (one
  CUDA-only profile each), capture seconds; last, the GRU at lr = 0 on
  one batch: each replay's dropout mask differs from the last and equals
  the eager step's from the same generator state. The path launches none
  of the seven kernels. The phase prints its seconds;
- **the compiled scheme** (phase 16, ``CkksScheme``'s per-op CUDA graphs,
  the counterpart of the JAX scheme's ``_jit``): on phase 2's N=2^15
  world, every cached operation (add, sub, add_plain, mult_plain,
  mult_scalar, mult, rescale, rotate by 1 and 2, conjugate, INDCPA
  re_encrypt, decrypt) called WARMUP + 3 times on fresh inputs, each
  result ``torch.equal`` to the eager body on the same inputs; an
  interleaving of twelve cached calls whose results are all held at the
  end (no replay may change an earlier result); the inner product through
  the cached ops within 1e-3 of np.dot; µs per operation eager -> cached.
  Then the rotation bench's three units captured whole
  (``bench.rotations.CompiledUnit``) and phase 7's multikey round in both
  schedules (``bench.multikey.CompiledMultikeyRound``), each
  ``torch.equal`` to its eager counterpart (the round decrypting within
  1e-3), eager -> compiled µs per rotation and ms per round with device
  time, idle and capture seconds; the replays' kernel launches, the keys
  cached and the reserved device memory's growth. The phase prints its
  seconds and the script's;
- **the randomized scheme** (phase 17): keygen, relin_key_gen,
  rot_key_gen, conj_key_gen, rekey_gen and encrypt on phase 2's N=2^15
  world and INDCCA re_encrypt of 32 ciphertexts on phase 7's multikey
  world (its scheme in PREMode INDCCA), each WARMUP + 3 times on a CUDA
  and on a CPU generator: the draws are made outside the per-op graph
  (one sampler call a kind) and every cached result is ``torch.equal`` to
  the eager body on the same draws; every key is used once in a key
  switch and every encryption and INDCCA hop decrypted within its gate;
  µs per operation eager -> cached; the multikey prep's and the threshold
  phase's encryptions split into encode, draws and body (the threshold
  phase prints its own too) against their totals with per-entry draws;
  the graphs cached, the reserved memory's growth, the phase's and the
  whole script's seconds.

The scheme's operations cache a CUDA graph per operation and shape on the
card (``ckks/scheme.py``), so a phase's eager timings run inside
``utils.graphs.eager()`` (:func:`eager_ops`), which phases 1, 2, 4, 5, 13
and 14 measured before the cache existed; the main paths run as a user
calls them, through the cache. The launch counts a phase reads are the
wrappers' plus the launches that graph replays ran (:func:`read_counts`).

For each path:

1. sets up seeded keys and ciphertexts on the card;
2. runs each hand-written kernel and its plain torch version on the same
   inputs at the path's shapes, requires bit-equal outputs, and times both:
   device time per call from ``torch.profiler``'s kernel events, beside the
   CUDA-event wall mean of back-to-back calls (which reads the host's cost
   per call when the kernel is short);
3. resets the kernels' launch counters, drives the path, requires every
   kernel of the path to have launched, and checks the decrypted outputs
   with the reference's gates (bench.py: error < 1e-3; bench_rotations.py:
   hoisted error < 1e-3, plain bit-equal to hoisted, rotation sum < 1e-2;
   the inner product within 1e-3 of np.dot);
4. times it: ms/round per schedule, µs/rotation for plain, hoisted and
   rotation sum (CUDA events, median of 20 after warm-up), µs per limb-NTT
   and limb-NTT/s (profiler device time and CUDA-event wall), ms per FL
   tool (host clock around the call, file I/O included, synchronized) and
   the server tools' device ms, µs/cell of the probe.

The file round's gates: decrypt error < 1e-3 against the plaintext mean in
both contexts, changeCipherDomain's document bit-equal to the in-memory
``change_cipher_domain_batch`` on the same loaded ciphertexts, the
radix-2 round launching kernels 2 and 3 and no NTT kernel, the four-step
round kernels 1, 2 and 3; the INDCCA hop's error RMS below √(N/2)·2^-10
(the flooding's cost per hop, ``docs/SECURITY.md:58``) and its largest
value below four times that. Then, in both contexts, the tools run again
in turns through their CUDA graphs (the radix-2 transforms, the seed
expansion, the encoding NTT, sk-encryption, the batched decryption, the
aggregation's sum and ÷N, and the scheme's per-op graphs) and inside
``utils.graphs.eager()``: every file the graphs write must be byte-equal
to the eager tools' in every turn, every new cache must have captured and
replayed a graph, and every scrubbed graph's static buffers must be zero
after a call; it prints warm ms per tool both ways, device ms, device
activities and host launch calls of four tools both ways, the caches'
graphs and the device memory they hold.

Each kernel row carries its bound: the least time the card could take for
the same work, the larger of the bytes it must move (each input read once,
each output written once) over 3.35 TB/s and its int8 operations over
1,979 T/s (H100 SXM; the 64-bit integer work of the butterflies and base
extensions has no published rate, so their bound is the bytes). The rows of
kernels 1, 1b, 4 and 5, Shoup butterflies on this card, also print the floor
of the TPU's digit method for the same stages (its int8 operations at 1,979
T/s); kernels 1 and 1b are checked per transform (and once against the digit
transform) and, on the NTT loop's inputs, per stage. ModDown's tail, a
kernel that replaces no TPU kernel, is checked in phases 1 and 7 at l = 3,
2, 4 over the key switch's 2 × 27 and 2 × 154 polys on the benchmark's
60/40/40/20 chain, c read in place. No PyTorch
call computes an NTT, base extension, key inner product or tail mod q, so
``library_ms`` is null in those rows; the probe's mxu row carries the time
of one ``torch._int_mm`` over the same cells (their x permuted into one
operand before the timed window), the faster of that operand stored
row-major and stored K-major.

Then it prints a JSON line of per-kernel results, the card line, and finally
``{"ok": true, "device": {...}}``. Any failure raises (exit code ≠ 0). Needs
one CUDA device and nvcc; it refuses to run without them and never gives way
to a plain version. Run from the repository root:

    python3 chip_smoke.py [--profile]

``--profile`` adds a torch.profiler table of device time per kernel for one
round of each schedule and one hoisted rotation pass.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

N_ROUND = 1 << 14
N_ROT = 1 << 15
N_BIG = 1 << 16      # the CLI's ring_dim: 65536
SLOTS = 8192         # the reference's batch_size
NTT_SIZES = ((1 << 14, 4, 27), (1 << 16, 4, 8))   # (N, L, B) of bench_kernels.py:53
NTT_CHAIN = 20       # chained transforms per implementation and direction
N_CTS = 27           # ciphertexts per client (the reference payload's count)
ERR_GATE = 1e-3      # bench.py's gate; bench_rotations.py's for a rotation
SUM_GATE = 1e-2      # bench_rotations.py's gate for the rotation sum
SEED = 7             # keys, noise and payloads
ROUNDS = 20          # timed repetitions
ROTS = [1, 2, 4, 8, 16, 32, 64, 128]
MK_CLIENTS = 16      # bench_multikey.py's clients (BASELINE.json config 5)
TH_PARTIES, TH_T = 16, 9     # threshold: N-of-N at 16 parties, t-of-N at 9 of 16
# the threshold CRS seed (its high word non-zero) and the SHA-256 of the
# JAX package's CRS residues for it on the N=2^14 chain, four-step order
# (tests/test_torch_jax_prng.py takes it from the JAX package on the CPU)
CRS_SEED = (7 << 32) | 2026
CRS_SHA256 = "6f902f668151684407918f6106dc26d26b1438e95d8cb2880f3e4cebb6c71b62"
K1, K2, K3 = ("ppqsflhe_tpu/ops/pallas_mxu_ntt.py:390", "ppqsflhe_tpu/ops/pallas_ext.py:167",
              "ppqsflhe_tpu/ops/pallas_ks.py:127")
K4, K5 = "ppqsflhe_tpu/ops/pallas_mxu_ntt.py:512", "ppqsflhe_tpu/ops/pallas_mxu_ntt.py:566"
K1B, K6 = "ppqsflhe_tpu/ops/pallas_mxu_ntt.py:347", "ppqsflhe_tpu/ops/pallas_ntt.py:207"
SRC_NTT = "ppqsflhe_tpu_torch/csrc/mxu_ntt.cu"
SRC_STREAMED = "ppqsflhe_tpu_torch/csrc/streamed_ntt.cu"
SRC_FS = "ppqsflhe_tpu_torch/csrc/fourstep_ntt.cu"
SRC_EXT = "ppqsflhe_tpu_torch/csrc/base_ext.cu"
SRC_KS = "ppqsflhe_tpu_torch/csrc/ks_ip.cu"
SRC_MODDOWN = "ppqsflhe_tpu_torch/csrc/moddown.cu"
SRC_DECOMPOSE = "ppqsflhe_tpu_torch/csrc/decompose.cu"
SRC_PROBE = "ppqsflhe_tpu_torch/csrc/overlap_probe.cu"
K7 = "probes/mxu_vpu_overlap.py:59"
# launch counter → (module under ppqsflhe_tpu_torch, attribute, kernel symbol)
COUNTERS = {
    "mxu_ntt": ("ops.cuda_mxu_ntt", "launches", "mxu_ntt_stage_kernel"),
    "mxu_ntt_mont": ("ops.cuda_mxu_ntt", "launches_mont", "mxu_ntt_stage_mont_kernel"),
    "streamed_stage_a": ("ops.streamed_ntt", "launches_stage_a", "streamed_stage_a_kernel"),
    "streamed_stage_b": ("ops.streamed_ntt", "launches_stage_b", "streamed_stage_b_kernel"),
    "base_extend": ("ops.cuda_ext", "launches", "base_extend_kernel"),
    "ks_inner_product": ("ops.cuda_ks", "launches", "ks_ip_kernel"),
    "fourstep_ntt": ("ops.cuda_ntt", "launches", "fourstep_ntt_kernel"),
    # counts eager calls and captures, not replays: utils/graphs.COUNTERS lacks it
    "moddown_tail": ("ops.cuda_moddown", "launches", "moddown_tail_kernel"),
    # as moddown_tail: eager launches and captures, not replays
    "decompose": ("ops.cuda_decompose", "launches", "decompose_kernel"),
    "overlap_probe": ("probes.mxu_vpu_overlap", "launches", "overlap_probe_kernel"),
}
# ModDown's tail replaces no TPU kernel: XLA fused it into its neighbours
MODDOWN_REPLACES = "none (XLA fused it: ppqsflhe_tpu/ckks/eval.py:335-336)"
# nor does the digit assembly: XLA fused keyswitch_core's product, cat and stack
DECOMPOSE_REPLACES = "none (XLA fused it: ppqsflhe_tpu/ckks/eval.py keyswitch_core)"
HBM_BPS = 3.35e12    # H100 SXM device memory, bytes/s
INT8_OPS = 1.979e15  # H100 SXM dense int8 tensor-core ops/s (a multiply-add is 2)


def bound(work) -> tuple:
    """(ms, "bytes" or "operations"): the least time for ``work`` =
    (bytes moved, int8 operations)."""
    t_bytes, t_ops = work[0] / HBM_BPS, work[1] / INT8_OPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def fused_work(tabs, B, twiddle_bytes):
    """A whole kernel-1 (1b) transform of B polys over limbs with tables
    ``tabs``: x in and out once, the limb's twiddle table (16 B an entry for
    the Shoup pair, 8 for the Montgomery table), both stages' m-vector and
    Pease row 0 (value, companion) pairs."""
    return sum(16 * B * t.n + twiddle_bytes * t.n + 24 * (t.n1 + t.n2) for t in tabs), 0


def stage_work(L, B, m, c, twiddle_bytes=0):
    """One butterfly stage (kernels 1, 1b, 4, 5) over an (m, c) block of B
    polys per limb: x in and y out once, the limb's m-vector and Pease row 0
    (value, companion) pairs, and a first stage's twiddle over the block."""
    return L * (16 * B * m * c + 24 * m + twiddle_bytes * m * c), 0


def digit_floor(tabs, B, *stages):
    """The TPU method's floor for the same stages (m, c), for comparison: its
    int8 digit product does 2·(nd·m)² operations per column, at 1,979 T/s."""
    ops = sum(2 * B * (t.nd * m) ** 2 * c for t in tabs for m, c in stages)
    return f"; TPU method's floor {ops / INT8_OPS * 1e6:.1f} us ({ops / 1e9:.2f} G int8 ops)"


def fused_case(cases, fntt, x, sel, fwd, mont, run, iters, tag):
    """A whole kernel-1 (1b with ``mont``) transform ``run`` of x over limbs
    ``sel`` against its plain version (the two butterfly stages in torch),
    after a one-off check against the digit-matmul plain transform (the TPU
    method's twin), run on the CPU for the small rings, N ≤ 2^9 (cuBLAS's
    int8 product refuses their digit matrices)."""
    import torch

    from ppqsflhe_tpu_torch.ops import mxu_ntt

    got = run()
    fn = mxu_ntt.mxu_ntt_limb if fwd else mxu_ntt.mxu_intt_limb
    xd = x.cpu() if fntt.n <= SMALL_RINGS[-1] else x
    digit = torch.stack([fn(xd[..., k, :], fntt.tabs[i], mont) for k, i in enumerate(sel)],
                        dim=-2)
    if not torch.equal(got.to(digit.device), digit):
        raise AssertionError(f"kernel 1{'b' if mont else ''} differs from the digit transform "
                             f"({tag})")
    B, tabs = x.numel() // (len(sel) * fntt.n), [fntt.tabs[i] for i in sel]
    counter = "mxu_ntt_mont" if mont else "mxu_ntt"
    plain = lambda: fntt.fused_plain(x, fwd, sel, mont)
    cases.check(f"{counter} ({'forward' if fwd else 'inverse'}, {tag})", counter, SRC_NTT,
                K1B if mont else K1, got, plain(), run, plain, iters,
                fused_work(tabs, B, 8 if mont else 16),
                note=digit_floor(tabs, B, (fntt.n1, fntt.n2), (fntt.n2, fntt.n1)))


def fused_stage_checks(cases, fntt, x, tag):
    """Kernels 1 and 1b one stage at a time on x (B, L, N) over all L limbs:
    stage 1 then stage 2 of each direction and twiddle kind against their
    plain versions."""
    import torch

    from ppqsflhe_tpu_torch.ops import cuda_mxu_ntt as cm

    B, L = x.shape[:2]
    sel = list(range(L))
    st = fntt.tables.streamed
    tabs = [st.limb(i) for i in sel]
    for fwd in (True, False):
        m1, m2 = (fntt.n1, fntt.n2) if fwd else (fntt.n2, fntt.n1)
        xb = x.reshape(B, L, m1, m2)
        for mont in (False, True):
            buf, info1, info2 = st.device(x.device, sel, fwd, mont)
            y = torch.empty((B, L, m2, m1), dtype=torch.int64, device=x.device)
            z = torch.empty_like(y)
            counter = "mxu_ntt_mont" if mont else "mxu_ntt"
            name = (f"{counter} stage %d ({'forward' if fwd else 'inverse'}, m=%d, limbs {sel} x "
                    f"{B} polys, {tag})")
            k = K1B if mont else K1
            run1 = lambda: cm.ntt_stage(xb, y, buf, info1, fwd, True, mont)
            plain1 = lambda: cm.stage1_plain(xb, tabs, fwd, mont)
            cases.check(name % (1, m1), counter, SRC_NTT, k, run1().clone(), plain1(), run1,
                        plain1, 5, stage_work(L, B, m1, m2, 8 if mont else 16),
                        note=digit_floor(fntt.tabs, B, (m1, m2)))
            run2 = lambda: cm.ntt_stage(y, z, buf, info2, fwd, False, mont)
            plain2 = lambda: cm.stage2_plain(y, tabs, fwd)
            cases.check(name % (2, m2), counter, SRC_NTT, k, run2().clone(), plain2(), run2,
                        plain2, 5, stage_work(L, B, m2, m1),
                        note=digit_floor(fntt.tabs, B, (m2, m1)))


def butterfly_work(L, B, n1, n2):
    """A kernel-6 transform of B polys over L limbs: x in and out, two
    (value, companion) elementwise tables and the Pease stage tables."""
    stages = 16 * ((n1.bit_length() - 1) * n1 // 2 + (n2.bit_length() - 1) * n2 // 2)
    return L * (16 * B * n1 * n2 + 32 * n1 * n2 + stages), 0


def fourstep_pass_work(L, B, m, c, tables):
    """One kernel-6 launch over an (m, c) block of B polys per limb: x in and
    y out once, ``tables`` (m, c) (value, companion) pairs and Pease row 0."""
    return L * (16 * B * m * c + 16 * tables * m * c + 8 * m), 0


def fourstep_pass_checks(cases, bf, x, tag):
    """Kernel 6 one launch at a time on x (B, L, N) over all L limbs: pass 1
    then pass 2 of each direction against their plain versions."""
    import torch

    from ppqsflhe_tpu_torch.ops import cuda_ntt

    B, L = x.shape[:2]
    sel = list(range(L))
    for fwd in (True, False):
        m1, m2 = (bf.n1, bf.n2) if fwd else (bf.n2, bf.n1)
        xb = x.reshape(B, L, m1, m2)
        tabs, info1, info2 = bf.device(x.device, sel, fwd)
        y = torch.empty((B, L, m2, m1), dtype=torch.int64, device=x.device)
        z = torch.empty_like(y)
        name = (f"fourstep_ntt pass %d ({'forward' if fwd else 'inverse'}, m=%d, limbs {sel} x "
                f"{B} polys, {tag})")
        run1 = lambda: cuda_ntt.fourstep_pass(xb, y, tabs, info1, fwd, True)
        plain1 = lambda: bf.plain_pass(xb, fwd, True, sel)
        cases.check(name % (1, m1), "fourstep_ntt", SRC_FS, K6, run1().clone(), plain1(), run1,
                    plain1, 5, fourstep_pass_work(L, B, m1, m2, 2 if fwd else 1))
        run2 = lambda: cuda_ntt.fourstep_pass(y, z, tabs, info2, fwd, False)
        plain2 = lambda: bf.plain_pass(y, fwd, False, sel)
        cases.check(name % (2, m2), "fourstep_ntt", SRC_FS, K6, run2().clone(), plain2(), run2,
                    plain2, 5, fourstep_pass_work(L, B, m2, m1, 0 if fwd else 1))


def ext_work(B, ls, ld, n):
    return 8 * (B * n * (ls + ld) + 4 * ls + 3 * ld + 2 * ls * ld), 0


def ks_work(B, nd, lk, n):
    return 8 * n * lk * (B * nd + 2 * nd + 2 * B), 0


def moddown_work(B, l, n):
    return 8 * (3 * B * l * n + 3 * l), 0


def moddown_checks(cases, polys, tag, gen, device):
    """ModDown's tail kernel against its plain version at l = 3, 2, 4 over
    ``polys`` (both components of a batch) at N=2^14, on the benchmark's
    chain 60/40/40/20 + 2 x 60, reading c in place from the (2, B, l + K, N)
    tensor the key switch stacks."""
    from ppqsflhe_tpu_torch.ckks.params import CkksContext, CkksParams
    from ppqsflhe_tpu_torch.ops.cuda_moddown import moddown_tail, moddown_tail_plain

    ctx = CkksContext(CkksParams.generate(n=N_ROUND, mult_depth=2, scale_bits=40, dnum=2,
                                          extra_mod_bits=20))
    mq = ctx.moduli_qp
    for l in (3, 2, 4):
        idx = ctx.q_idx(l)
        c_ext = rand_residues([mq[i] for i in idx + ctx.p_idx()], (2, polys // 2), N_ROUND, gen,
                              device)
        c = c_ext[..., :l, :]
        e = rand_residues([mq[i] for i in idx], (2, polys // 2), N_ROUND, gen, device)
        args = (c, e, ctx.limb_consts(idx, device)[0], *ctx.moddown_consts(l, device))
        run, plain = lambda: moddown_tail(*args), lambda: moddown_tail_plain(*args)
        cases.check(f"moddown_tail (l={l}, {polys} polys, c in place, N=2^14, {tag})",
                    "moddown_tail", SRC_MODDOWN, MODDOWN_REPLACES, run(), plain(), run, plain,
                    20, moddown_work(polys, l, N_ROUND))


def decompose_work(B, nd, lk, n, rows):
    return 8 * (2 * B * nd * lk * n + 3 * rows), 0


def decompose_checks(cases, B, tag, gen, device, n=N_ROUND, levels=(3, 2, 4)):
    """The digit assembly against its plain version at each level over
    ``B`` c1 polys, on the benchmark's chain 60/40/40/20 + 2 x 60 at ring
    ``n``, reading c in place from the (B, 2, l, n) ciphertexts and writing
    the (B, nd, l + K, n) stack the inner product reads."""
    from ppqsflhe_tpu_torch.ckks.eval import _ks_decomp_consts, _ks_digit_cols
    from ppqsflhe_tpu_torch.ckks.params import CkksContext, CkksParams
    from ppqsflhe_tpu_torch.ops.cuda_decompose import digits, digits_plain

    ctx = CkksContext(CkksParams.generate(n=n, mult_depth=2, scale_bits=40, dnum=2,
                                          extra_mod_bits=20))
    mq, K = ctx.moduli_qp, ctx.params.num_p
    for l in levels:
        idx_ext = ctx.q_idx(l) + ctx.p_idx()
        groups, _ = _ks_decomp_consts(ctx, l)
        ct = rand_residues([mq[i] for i in ctx.q_idx(l)], (B, 2), n, gen, device)
        exts = [rand_residues([mq[i] for i in idx_ext if i not in g], (B,), n, gen, device)
                for g in groups]
        args = (ct[:, 1], exts, *_ks_digit_cols(ctx, l, device))
        run, plain = lambda: digits(*args), lambda: digits_plain(*args)
        nd = len(groups)
        cases.check(f"decompose (l={l}, nd={nd}, LK={l + K}, {B} polys, c in place, "
                    f"N=2^{n.bit_length() - 1}, {tag})", "decompose", SRC_DECOMPOSE,
                    DECOMPOSE_REPLACES, run(), plain(), run, plain, 20,
                    decompose_work(B, nd, l + K, n, l))


def sh(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def _module(name):
    import importlib

    return importlib.import_module(f"ppqsflhe_tpu_torch.{name}")


def reset_counts() -> None:
    for mod, attr, _ in COUNTERS.values():
        setattr(_module(mod), attr, 0)
    _module("utils.graphs").reset_replayed()


def read_counts() -> dict:
    """Each kernel's launches since :func:`reset_counts`: those its wrapper
    enqueued plus those that CUDA-graph replays ran (``utils.graphs.replayed``:
    the scheme's per-op graphs replay their captured launches, and a capture
    launches nothing)."""
    replayed = _module("utils.graphs").replayed
    return {k: getattr(_module(mod), attr) + replayed.get(k, 0)
            for k, (mod, attr, _) in COUNTERS.items()}


def eager_ops():
    """The scheme's operations run eagerly inside (no per-op CUDA graph is
    warmed, captured or replayed): the phases' timings of eager paths keep
    measuring them; phase 16 measures the per-op graphs."""
    return _module("utils.graphs").eager()


def cuda_ms(fn, iters: int, warmup: int = 2):
    """Mean wall milliseconds per call of ``fn``, back to back (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_events(fn, iters: int = 1, symbol: str | None = None, expect: int | None = None):
    """The device activities (kernels, copies) of ``iters`` calls of ``fn``
    under torch.profiler whose name holds ``symbol`` (all when None), as
    (name, µs) pairs. A profile may lack some activities of calls that ran
    (on the H100, now and then at N ≤ 2^15; one or two of every window
    once the N=2^16 phases have run), so: with ``expect``, the first of
    three profiles that holds exactly ``expect`` activities, else the
    fullest of them; without it, the fuller of two."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best, seen = [], []
    for _ in range(3 if expect is not None else 2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and (symbol is None or symbol in e.name)]
        if expect is not None and len(evs) == expect:
            return evs
        seen.append(len(evs))
        if len(evs) > len(best):
            best = evs
    if expect is not None:
        print(f"[profiler] {symbol}: {seen} activities in three profiles, {expect} launched")
    return best


def device_ms(fn, iters: int, symbol: str | None = None, expect: int | None = None):
    """Device ms per call of the activities :func:`device_events` returns;
    None when it returns none. With ``expect``, a profile short of launches
    counts each missing one at the mean of those it holds, if it holds at
    least half of them (else None)."""
    evs = device_events(fn, iters, symbol, expect)
    if not evs or (expect is not None and 2 * len(evs) < expect):
        return None
    total = sum(us for _, us in evs) * (expect / len(evs) if expect else 1)
    return total / iters / 1e3


def show_us(ms):
    return "not measured" if ms is None else f"{ms * 1e3:.1f} us"


def rand_residues(moduli, shape, n, gen, device):
    """Uniform residues int64[*shape, len(moduli), n] below each modulus."""
    import torch

    return torch.stack([torch.randint(0, q, tuple(shape) + (n,), generator=gen,
                                      dtype=torch.int64) for q in moduli],
                       dim=len(shape)).to(device)


class KernelCases:
    """The rows of the JSON ``kernels`` line: each case holds a kernel to its
    plain version (bit-equal) and times both."""

    def __init__(self, card: str):
        self.card = card
        self.rows = []

    def check(self, name, counter, source, replaces, got, want, fn, plain_fn, iters, work,
              library_ms=None, note=""):
        """``work``: (bytes, int8 operations) of one call, for its bound;
        ``library_ms``: the time of one PyTorch call for the same function;
        ``note``: appended to the printed line."""
        import torch

        if not torch.equal(got, want):
            bad = (got != want).sum().item()
            raise AssertionError(f"{name}: kernel differs from plain version in {bad} residues")
        err = (got - want).abs().max().item()
        symbol = COUNTERS[counter][2]
        before = read_counts()[counter]
        fn()
        per_call = read_counts()[counter] - before
        wall, plain_wall = cuda_ms(fn, iters), cuda_ms(plain_fn, max(2, iters // 5))
        dev = device_ms(fn, iters, symbol, expect=per_call * iters)
        plain_dev = device_ms(plain_fn, max(2, iters // 5))
        if dev is None or plain_dev is None:
            print(f"[kernel] {name}: no profile held half the launches; device time not measured")
        timing = "profiler" if dev is not None and plain_dev is not None else "cuda_events"
        bound_ms, bound_by = bound(work)
        print(f"[kernel] {name}: bit-equal to plain; device time per call: kernel "
              f"{show_us(dev)} ({per_call:g} launches of {symbol}), plain {show_us(plain_dev)}; "
              f"wall mean per "
              f"call: kernel {wall * 1e3:.1f} us, plain {plain_wall * 1e3:.1f} us; bound "
              f"{bound_ms * 1e3:.2f} us by {bound_by} ({work[0] / 1e6:.2f} MB, "
              f"{work[1] / 1e9:.2f} G int8 ops){note} ({self.card})")
        self.rows.append(dict(
            name=name, route="cuda", source=source, replaces=replaces, counter=counter,
            max_abs_err=err, ms=dev if timing == "profiler" else wall,
            plain_ms=plain_dev if timing == "profiler" else plain_wall,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
            timing=timing, wall_ms=wall, plain_wall_ms=plain_wall))

    def take_launches(self, counts: dict) -> list:
        """Give every row the main path's launch count of its kernel."""
        rows = [dict(r, launches=counts[r["counter"]]) for r in self.rows]
        for r in rows:
            del r["counter"]
        return rows


# ---------------------------------------------------------------------------
# Path 1: the server round at N=2^14
# ---------------------------------------------------------------------------

def round_kernel_checks(cases, sch, rk_mont, gen, device):
    """Each kernel against its plain version at the round's shapes."""
    import numpy as np
    import torch

    from ppqsflhe_tpu_torch.ckks.eval import _ks_decomp_consts
    from ppqsflhe_tpu_torch.ops import cuda_ext
    from ppqsflhe_tpu_torch.ops.cuda_ks import ks_inner_product, ks_inner_product_plain

    ctx, n = sch.ctx, sch.params.n
    mq = ctx.moduli_qp
    L, K = sch.params.num_q, sch.params.num_p

    # kernel 1: the 2-limb transforms of the lazy key switch (q0: nd=9,
    # q1: nd=6) over both components of 27 ciphertexts
    idx = (0, 1)
    x = rand_residues([mq[i] for i in idx], (2 * N_CTS,), n, gen, device)
    fused_case(cases, ctx.fntt, x, idx, True, False, lambda: ctx.ntt(x, idx), 20,
               f"2 limbs x {2 * N_CTS} polys, N=2^14")
    got = ctx.ntt(x, idx)
    back = ctx.intt(got, idx)
    if not (torch.equal(back, ctx.fntt.fused_plain(got, False, idx)) and torch.equal(back, x)):
        raise AssertionError("mxu_ntt inverse differs from plain version or input")

    # kernel 2: every base extension the two schedules run — at each PRE
    # level l ∈ {3, 2, 1}, each digit group's decompose+extend (its constant
    # folded in, over the 27 c1 polys) and the ModDown P → Q_l (no constant,
    # over both components of the 27 products)
    for l in (L, L - 1, 1):
        idx_ext = ctx.q_idx(l) + ctx.p_idx()
        groups, consts = _ks_decomp_consts(ctx, l)
        todo = [(g, tuple(i for i in idx_ext if i not in g), pre, (N_CTS,))
                for g, pre in zip(groups, consts)]
        todo.append((ctx.p_idx(), ctx.q_idx(l), None, (2, N_CTS)))
        for src, dst, pre, lead in todo:
            ext = ctx.extender(src, dst)
            xe = rand_residues([mq[i] for i in src], lead, n, gen, device)
            tag = "pre" if pre is not None else "ModDown"
            cases.check(f"base_extend (l={l}, {len(src)}->{len(dst)} limbs, {tag}, "
                        f"{'x'.join(map(str, lead))} polys, N=2^14)", "base_extend", SRC_EXT, K2,
                        cuda_ext.fused_extend(xe, ext, pre), ext.extend(xe, pre),
                        lambda: cuda_ext.fused_extend(xe, ext, pre),
                        lambda: ext.extend(xe, pre), 50,
                        ext_work(int(np.prod(lead)), len(src), len(dst), n))

    # kernel 3: the full-level inner product, nd=2 digits over LK=5 limbs
    limbs = tuple(range(L + K))
    nd = len(ctx.digit_groups)
    q, qinv, _ = ctx.limb_consts(limbs, device)
    sel = ctx.consts(("limb_map", limbs), lambda: limbs, device)
    dig = rand_residues(mq, (N_CTS, nd), n, gen, device)
    args = (dig, rk_mont.data, sel, q, qinv)
    cases.check(f"ks_inner_product (nd={nd}, LK={len(limbs)}, {N_CTS} polys, N=2^14)",
                "ks_inner_product", SRC_KS, K3,
                ks_inner_product(*args), ks_inner_product_plain(*args),
                lambda: ks_inner_product(*args), lambda: ks_inner_product_plain(*args), 50,
                ks_work(N_CTS, nd, len(limbs), n))
    ks_one_digit_checks(cases, sch, rk_mont, gen, device)
    ext_generic_checks(cases, n, gen, device)
    moddown_checks(cases, 2 * N_CTS, "pairwise", gen, device)
    decompose_checks(cases, N_CTS, "pairwise", gen, device)
    torch.cuda.synchronize()


def ks_one_digit_checks(cases, sch, rk_mont, gen, device):
    """Kernel 3 at the lazy-4 schedule's one-digit shapes — nd=1 over the 27
    c1 polys at l=2 (LK=4) and l=1 (LK=3) — against its plain version, and
    the ``[A/B ks nd=1]`` line: kernel against plain, device and wall (the
    two cases' own timings)."""
    from ppqsflhe_tpu_torch.ops.cuda_ks import ks_inner_product, ks_inner_product_plain

    ctx, n = sch.ctx, sch.params.n
    tag = f"N=2^{n.bit_length() - 1}"
    parts = []
    for l in (2, 1):
        limbs = tuple(ctx.q_idx(l)) + ctx.p_idx()
        q, qinv, _ = ctx.limb_consts(limbs, device)
        sel = ctx.consts(("limb_map", limbs), lambda: limbs, device)
        dig = rand_residues([ctx.moduli_qp[i] for i in limbs], (N_CTS, 1), n, gen, device)
        args = (dig, rk_mont.data, sel, q, qinv)
        run, plain = lambda: ks_inner_product(*args), lambda: ks_inner_product_plain(*args)
        cases.check(f"ks_inner_product (nd=1, LK={len(limbs)}, {N_CTS} polys, l={l}, {tag})",
                    "ks_inner_product", SRC_KS, K3, run(), plain(), run, plain, 20,
                    ks_work(N_CTS, 1, len(limbs), n))
        r = cases.rows[-1]
        parts.append(f"l={l} (LK={len(limbs)}): kernel 3 {show_us(r['ms'])}, plain "
                     f"{show_us(r['plain_ms'])} ({r['timing']}); wall "
                     f"{r['wall_ms'] * 1e3:.1f} / {r['plain_wall_ms'] * 1e3:.1f} us")
    print(f"[A/B ks nd=1] {tag}, {N_CTS} polys, bit-equal: " + "; ".join(parts)
          + f" ({cases.card})")


def ext_generic_checks(cases, n, gen, device):
    """Kernel 2's generic instance (shapes without an unrolled one: 4 -> 2
    limbs, and 3 -> 10 in two launches, 3 -> 8 generic then 3 -> 2) on 50-bit
    moduli, 27 polys."""
    from ppqsflhe_tpu_torch.core import primes
    from ppqsflhe_tpu_torch.core.rns import BaseExtender
    from ppqsflhe_tpu_torch.ops import cuda_ext

    moduli = primes.prime_chain(50, 13, 2 * n)
    pre = [primes.mod_inverse(7 + i, q) for i, q in enumerate(moduli[:4])]
    for ls, ld in ((4, 2), (3, 10)):
        ext = BaseExtender(moduli[:ls], moduli[ls:ls + ld])
        xe = rand_residues(moduli[:ls], (N_CTS,), n, gen, device)
        cases.check(f"base_extend (generic, {ls}->{ld} limbs, pre, {N_CTS} polys, "
                    f"N=2^{n.bit_length() - 1})", "base_extend", SRC_EXT, K2,
                    cuda_ext.fused_extend(xe, ext, pre[:ls]), ext.extend(xe, pre[:ls]),
                    lambda: cuda_ext.fused_extend(xe, ext, pre[:ls]),
                    lambda: ext.extend(xe, pre[:ls]), 20, ext_work(N_CTS, ls, ld, n))


def max_err(sch, sk, cts, want):
    """Max |decrypt - want| over every ciphertext of the batch and slot."""
    from ppqsflhe_tpu_torch.ckks.types import Ciphertext

    err = 0.0
    for i in range(cts.data.shape[0]):
        got = sch.decrypt(sk, Ciphertext(cts.data[i], cts.scale))
        err = max(err, float(abs(got - want[i]).max()))
    return err


def round_world(n, device, slots=0, backend="fourstep"):
    """Seeded keys, rekeys (Montgomery form) and 2 × N_CTS encryptions of
    uniform(-1, 1) payloads for the server round on the
    ``CkksParams.generate(n, mult_depth=2, scale_bits=40, dnum=2)`` chain in
    the ``backend``'s evaluation order."""
    import types

    import numpy as np
    import torch

    from ppqsflhe_tpu_torch.ckks import eval as ev
    from ppqsflhe_tpu_torch.ckks.params import CkksParams
    from ppqsflhe_tpu_torch.ckks.scheme import CkksScheme

    t0 = time.perf_counter()
    params = CkksParams.generate(n=n, mult_depth=2, scale_bits=40, dnum=2, slots=slots,
                                 ntt_backend=backend)
    sch = CkksScheme(params, device=device)
    t_ctx = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(SEED)
    sk1, pk1 = sch.keygen(gen)
    sk2, pk2 = sch.keygen(gen)
    rk12 = ev.ksk_to_mont(sch.ctx, sch.rekey_gen(sk1, pk2, gen))
    rk21 = ev.ksk_to_mont(sch.ctx, sch.rekey_gen(sk2, pk1, gen))
    rng = np.random.default_rng(SEED)
    slots = sch.encoder.slots
    v1 = [rng.uniform(-1, 1, slots) for _ in range(N_CTS)]
    v2 = [rng.uniform(-1, 1, slots) for _ in range(N_CTS)]
    ct1 = sch.encrypt_values(pk1, v1, gen)
    ct2 = sch.encrypt_values(pk2, v2, gen)
    torch.cuda.synchronize()
    print(f"[setup] N={n}, Q={[q.bit_length() for q in params.q_moduli]} bits, "
          f"P={[p.bit_length() for p in params.p_moduli]} bits, dnum={params.dnum}, "
          f"{slots} slots, {backend}; context {t_ctx:.1f} s, then keys, rekeys and 2x{N_CTS} "
          f"encryptions in {time.perf_counter() - t0 - t_ctx:.1f} s")
    return types.SimpleNamespace(sch=sch, gen=gen, sk1=sk1, sk2=sk2, rk12=rk12, rk21=rk21,
                                 ct1=ct1, ct2=ct2, want=(np.array(v1) + np.array(v2)) / 2)


def drive_round(tag, sch, w, need, absent=()):
    """The main path: one round per schedule with fresh launch counters.
    Requires the kernels ``need[lazy]`` to have launched and ``absent`` not
    to have, checks the decrypted outputs against the plaintext mean, and
    returns (outputs by schedule, launch counts of both schedules)."""
    import numpy as np
    import torch

    from ppqsflhe_tpu_torch.fl.api import server_round

    reset_counts()
    outs, per_sched = {}, {}
    for lazy in (4, 0):
        before = read_counts()
        outs[lazy] = server_round(sch, w.ct1, w.ct2, w.rk12, w.rk21, lazy)
        torch.cuda.synchronize()
        per_sched[lazy] = {k: v - before[k] for k, v in read_counts().items()}
    launches = read_counts()
    for lazy in (4, 0):
        print(f"[{tag} lazy={lazy}] kernel launches: "
              f"{ {k: v for k, v in per_sched[lazy].items() if v} }")
        missing = [k for k in need[lazy] if per_sched[lazy][k] == 0]
        if missing:
            raise AssertionError(f"{tag}: schedule lazy={lazy} never launched {missing}")
    wrong = [k for k in absent if launches[k]]
    if wrong:
        raise AssertionError(f"{tag}: launched {wrong}, which this configuration must not run")
    for lazy in (4, 0):
        avg, back = outs[lazy]
        e2 = max_err(sch, w.sk2, avg, w.want)
        e1 = max_err(sch, w.sk1, back, w.want)
        print(f"[{tag} lazy={lazy}] decrypt max err: average under sk2 {e2:.3e}, "
              f"re-encrypted under sk1 {e1:.3e} (gate {ERR_GATE}); output "
              f"{tuple(back.data.shape)} at {back.nlimbs} limb(s)")
        if not (np.isfinite(e1) and np.isfinite(e2) and max(e1, e2) < ERR_GATE):
            raise AssertionError(f"{tag} lazy={lazy}: decrypt error {max(e1, e2)} over the gate")
    return outs, launches


def host_ms(fn):
    """Median host milliseconds to enqueue one call of ``fn`` (the host
    clock around the call, the device drained before each)."""
    import torch

    times = []
    for _ in range(ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def time_round(tag, sch, w, card, profile_on):
    """ms/round per schedule (median of per-round CUDA-event times), the
    host's enqueue time, and the device time by kernel of one round; the
    scheme's operations eagerly (:func:`eager_ops`)."""
    from ppqsflhe_tpu_torch.fl.api import server_round

    for lazy in (4, 0):
        run = lambda: server_round(sch, w.ct1, w.ct2, w.rk12, w.rk21, lazy)
        with eager_ops():
            times = median_ms(run, 3)
            print(f"[timing {tag} lazy={lazy}] server round {statistics.median(times):.3f} "
                  f"ms/round (median of {len(times)}, min {min(times):.3f}, max "
                  f"{max(times):.3f}; host enqueue {host_ms(run):.3f} ms; 2x{N_CTS} "
                  f"ciphertexts, N={sch.params.n}; {card})")
            busy_line(f"{tag} lazy={lazy}", run, statistics.median(times))
            if profile_on:
                profile_table(f"{tag} lazy={lazy}", run)


def round_phase(card, device, profile_on):
    """The server round: set-up, kernel checks, main path, decrypt, timing.
    Returns the kernels' JSON rows, the round's world and its outputs."""
    w = round_world(N_ROUND, device)
    cases = KernelCases(card)
    round_kernel_checks(cases, w.sch, w.rk12, w.gen, device)
    need = ("mxu_ntt", "base_extend", "ks_inner_product", "moddown_tail", "decompose")
    outs, launches = drive_round("round", w.sch, w, {4: need, 0: need})
    time_round("round", w.sch, w, card, profile_on)
    return cases.take_launches(launches), w, outs


def median_ms(fn, warmup: int):
    """Per-call CUDA-event milliseconds of ROUNDS calls after ``warmup``."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(ROUNDS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return times


def device_events_once(fn):
    """The device activities of one call of ``fn`` from one CUDA-only
    profile, read from the raw kineto events: a training epoch launches
    ~100,000 kernels, and building the profiler's event tree for them took
    25 s (70 times the raw read)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name(), e.duration_ns() / 1e3) for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA]


def busy_line(tag, fn, wall_ms, once=False):
    """Device time by kernel for one call of ``fn`` against its wall time
    (``once``: from :func:`device_events_once`)."""
    evs = device_events_once(fn) if once else device_events(fn)
    if not evs:
        print(f"[busy {tag}] not measured: the profiler saw no device activity")
        return
    by = {k: 0.0 for k in COUNTERS}
    other = 0.0
    for name, us in evs:
        key = next((k for k, (_, _, sym) in COUNTERS.items() if sym in name), None)
        if key is None:
            other += us
        else:
            by[key] += us
    busy = sum(by.values()) + other
    parts = [f"{k} {v / 1e3:.3f}" for k, v in by.items() if v] + [f"other ops {other / 1e3:.3f} ms"]
    print(f"[busy {tag}] device {busy / 1e3:.3f} ms of {wall_ms:.3f} ms wall "
          f"(idle {max(0.0, 1 - busy / 1e3 / wall_ms):.1%}): {', '.join(parts)}, {len(evs)} "
          f"device activities")


def profile_table(tag, fn):
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    print(f"[profile {tag}]")
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))


# ---------------------------------------------------------------------------
# Path 2: hoisted Galois rotations at N=2^15
# ---------------------------------------------------------------------------

def rotation_kernel_checks(cases, sch, rot_keys, gen, device):
    """Kernels 4 and 5 (and 1, 2, 3) against their plain versions at the
    shapes one full-level rotation gives them."""
    import torch

    from ppqsflhe_tpu_torch.ckks.eval import _ks_decomp_consts
    from ppqsflhe_tpu_torch.ops import cuda_ext, cuda_mxu_ntt, streamed_ntt
    from ppqsflhe_tpu_torch.ops.cuda_ks import ks_inner_product, ks_inner_product_plain

    ctx, n = sch.ctx, sch.params.n
    fntt = ctx.fntt
    mq = ctx.moduli_qp
    L, K = sch.params.num_q, sch.params.num_p
    nd9 = [i for i, t in enumerate(fntt.tabs) if cuda_mxu_ntt.route(n, t.nd) == "big"]
    nd6 = [i for i, t in enumerate(fntt.tabs) if cuda_mxu_ntt.route(n, t.nd) == "fused"]
    print(f"[route N={n}] big (kernels 4+5): limbs {nd9}; fused (kernel 1): limbs {nd6}")
    if not nd9 or not nd6:
        raise AssertionError("the rotation chain must route limbs both ways at N=2^15")

    # kernels 4 and 5: the nd=9 limbs of the key switch's extended digit
    # (q0, p0, p1, forward, one poly) and of ModDown's iNTT (p0, p1 over both
    # components), each stage against its plain version (stage A also on
    # half the columns, with lazy inputs < 4q), then the whole transform
    # through the big route against kernel 1 and the plain version
    st = fntt.big.streamed
    for sel, lead, fwd in (([0] + list(ctx.p_idx()), (1,), True), (list(ctx.p_idx()), (2,), False)):
        sel = [i for i in sel if i in nd9]
        tag = f"{'forward' if fwd else 'inverse'}, limbs {sel} x {lead[0]} poly(s), N=2^15"
        m1, m2 = (fntt.n1, fntt.n2) if fwd else (fntt.n2, fntt.n1)
        x = rand_residues([mq[i] for i in sel], lead, n, gen, device).reshape(
            lead[0], len(sel), m1, m2)
        buf, info_a, info_b = st.device(device, sel, fwd)
        tabs = [st.limb(i) for i in sel]
        ya = torch.empty_like(x)
        run_a = lambda: streamed_ntt.stage_a(x, ya, buf, info_a, fwd, m2)
        plain_a = lambda: streamed_ntt.stage_a_plain(x, tabs, fwd)
        cases.check(f"streamed_stage_a ({tag})", "streamed_stage_a", SRC_STREAMED, K4,
                    run_a().clone(), plain_a(), run_a, plain_a, 20,
                    stage_work(len(sel), lead[0], m1, m2, 16),
                    note=digit_floor([fntt.tabs[i] for i in sel], lead[0], (m1, m2)))
        zb = torch.empty((lead[0], len(sel), m2, m1), dtype=torch.int64, device=device)
        run_b = lambda: streamed_ntt.stage_b(ya, zb, buf, info_b, fwd)
        plain_b = lambda: streamed_ntt.stage_b_plain(ya, tabs, fwd)
        cases.check(f"streamed_stage_b ({tag})", "streamed_stage_b", SRC_STREAMED, K5,
                    run_b().clone(), plain_b(), run_b, plain_b, 20,
                    stage_work(len(sel), lead[0], m2, m1),
                    note=digit_floor([fntt.tabs[i] for i in sel], lead[0], (m2, m1)))
        # stage A on one half of the columns, reading its slice of the table
        h = m2 // 2
        qs = torch.tensor([mq[i] for i in sel], device=device)[None, :, None, None]
        xh = (x[..., h:] + 3 * qs).contiguous()
        got = streamed_ntt.stage_a(xh, torch.empty_like(xh), buf, info_a, fwd, m2, h)
        if not torch.equal(got, streamed_ntt.stage_a_plain(xh, tabs, fwd, h)):
            raise AssertionError(f"streamed_stage_a on columns [{h}, {m2}) differs ({tag})")
        # the whole transform: big route = kernel 1's fused launches = plain
        xf = x.reshape(lead + (len(sel), n))
        run = fntt.ntt if fwd else fntt.intt
        big, fused = run(xf, sel), fntt.fused(xf, fwd, sel)
        plain = fntt.fused(xf.cpu(), fwd, sel).to(device)
        if not (torch.equal(big, fused) and torch.equal(big, plain)):
            raise AssertionError(f"big route differs from kernel 1 or the plain version ({tag})")
        t_big = device_ms(lambda: run(xf, sel), 20)
        t_fused = device_ms(lambda: fntt.fused(xf, fwd, sel), 20)
        w_big, w_fused = cuda_ms(lambda: run(xf, sel), 20), cuda_ms(
            lambda: fntt.fused(xf, fwd, sel), 20)
        show = lambda v: "not measured" if v is None else f"{v * 1e3:.1f} us"
        print(f"[route nd=9] {tag}: bit-equal (big = kernel 1 = plain); device time per "
              f"transform: big route (kernels 4+5) {show(t_big)}, fused route (kernel 1) "
              f"{show(t_fused)}; wall mean {w_big * 1e3:.1f} / {w_fused * 1e3:.1f} us "
              f"({cases.card})")

    # kernel 1: the nd=6 limbs of ModDown's NTT back to Q (q1, q2, both
    # components), forward and back
    idx = tuple(i for i in ctx.q_idx(L) if i in nd6)
    x = rand_residues([mq[i] for i in idx], (2,), n, gen, device)
    fused_case(cases, fntt, x, idx, True, False, lambda: ctx.ntt(x, idx), 20,
               f"limbs {list(idx)} x 2 polys, N=2^15")
    if not torch.equal(ctx.intt(ctx.ntt(x, idx), idx), x):
        raise AssertionError("mxu_ntt inverse at N=2^15 does not give the input back")

    # kernel 2: the full-level key switch's three extensions — each digit
    # group (its constant folded in, one poly) and ModDown P → Q (2 polys)
    idx_ext = ctx.q_idx(L) + ctx.p_idx()
    groups, consts = _ks_decomp_consts(ctx, L)
    todo = [(g, tuple(i for i in idx_ext if i not in g), pre, (1,))
            for g, pre in zip(groups, consts)]
    todo.append((ctx.p_idx(), ctx.q_idx(L), None, (2,)))
    for src, dst, pre, lead in todo:
        ext = ctx.extender(src, dst)
        xe = rand_residues([mq[i] for i in src], lead, n, gen, device)
        tag = "pre" if pre is not None else "ModDown"
        cases.check(f"base_extend ({len(src)}->{len(dst)} limbs, {tag}, {lead[0]} poly(s), "
                    f"N=2^15)", "base_extend", SRC_EXT, K2,
                    cuda_ext.fused_extend(xe, ext, pre), ext.extend(xe, pre),
                    lambda: cuda_ext.fused_extend(xe, ext, pre), lambda: ext.extend(xe, pre), 50,
                    ext_work(lead[0], len(src), len(dst), n))

    # kernel 3: one rotation's inner product, nd=2 digits over LK=5 limbs
    limbs = tuple(range(L + K))
    nd = len(ctx.digit_groups)
    q, qinv, _ = ctx.limb_consts(limbs, device)
    sel = ctx.consts(("limb_map", limbs), lambda: limbs, device)
    dig = rand_residues(mq, (1, nd), n, gen, device)
    args = (dig, rot_keys[ROTS[0]].data, sel, q, qinv)
    cases.check(f"ks_inner_product (nd={nd}, LK={len(limbs)}, 1 poly, N=2^15)",
                "ks_inner_product", SRC_KS, K3,
                ks_inner_product(*args), ks_inner_product_plain(*args),
                lambda: ks_inner_product(*args), lambda: ks_inner_product_plain(*args), 50,
                ks_work(1, nd, len(limbs), n))
    torch.cuda.synchronize()


def rotation_phase(card, device, profile_on):
    """Rotations at N=2^15: set-up, kernel checks, main path, decrypt,
    timing (eagerly). Returns the kernels' JSON rows and the phase's world
    (phase 16 runs the scheme's per-op graphs on it)."""
    import numpy as np
    import torch

    from ppqsflhe_tpu_torch.ckks import eval as ev
    from ppqsflhe_tpu_torch.ckks.params import CkksParams
    from ppqsflhe_tpu_torch.ckks.scheme import CkksScheme

    import types

    t0 = time.perf_counter()
    params = CkksParams.generate(n=N_ROT, mult_depth=2, scale_bits=40, dnum=2)
    sch = CkksScheme(params, device=device)
    t_ctx = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(SEED)
    sk, pk = sch.keygen(gen)
    slots = sch.encoder.slots
    ip_rots = [1 << i for i in range(int(np.log2(slots)))]
    # long-lived keys go to Montgomery form once (bench_rotations.py:155-157)
    rot_keys = {r: ev.ksk_to_mont(sch.ctx, k) for r, k in
                sch.rotation_key_gen(sk, sorted(set(ROTS) | set(ip_rots)), gen).items()}
    relin = ev.ksk_to_mont(sch.ctx, sch.relin_key_gen(sk, gen))
    v = np.linspace(-1, 1, slots)
    ct = sch.encrypt_values(pk, v, gen)
    rng = np.random.default_rng(SEED)
    u1, u2 = rng.uniform(-1, 1, slots) * 0.1, rng.uniform(-1, 1, slots) * 0.1
    cu1, cu2 = sch.encrypt_values(pk, u1, gen), sch.encrypt_values(pk, u2, gen)
    torch.cuda.synchronize()
    print(f"[setup] N={N_ROT}, Q={[q.bit_length() for q in params.q_moduli]} bits, "
          f"P={[p.bit_length() for p in params.p_moduli]} bits, dnum={params.dnum}; context "
          f"{t_ctx:.1f} s, then keys, {len(rot_keys)} rotation keys, relin key and 3 "
          f"encryptions in {time.perf_counter() - t0 - t_ctx:.1f} s")

    cases = KernelCases(card)
    rotation_kernel_checks(cases, sch, rot_keys, gen, device)

    # the main path: R plain rotations, one hoisted pass, one rotation sum
    plain = lambda: [sch.rotate(ct, r, rot_keys) for r in ROTS]
    hoisted = lambda: sch.rotate_hoisted(ct, ROTS, rot_keys)
    rot_sum = lambda: sch.rotate_sum_hoisted(ct, ROTS, rot_keys)
    reset_counts()
    outs_p, outs_h, out_s = plain(), hoisted(), rot_sum()
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"[rotations] kernel launches (R={len(ROTS)} plain + hoisted + rotation sum): "
          f"{launches}")
    missing = [k for k in ("mxu_ntt", "streamed_stage_a", "streamed_stage_b", "base_extend",
                           "ks_inner_product") if launches[k] == 0]
    if missing:
        raise AssertionError(f"the rotation path never launched {missing}")

    err_h = max(float(np.abs(sch.decrypt(sk, o) - np.roll(v, -r)).max())
                for r, o in zip(ROTS, outs_h))
    same = all(torch.equal(p.data, h.data) for p, h in zip(outs_p, outs_h))
    err_s = float(np.abs(sch.decrypt(sk, out_s) - sum(np.roll(v, -r) for r in ROTS)).max())
    ip = sch.inner_product(cu1, cu2, relin, rot_keys)
    err_ip = float(np.abs(sch.decrypt(sk, ip) - np.dot(u1, u2)).max())
    print(f"[rotations] hoisted decrypt max err {err_h:.3e} (gate {ERR_GATE}); plain "
          f"bit-equal to hoisted: {same}; rotation sum err {err_s:.3e} (gate {SUM_GATE}); "
          f"inner product of {slots} slots err {err_ip:.3e} (gate {ERR_GATE})")
    if not (np.isfinite(err_h) and err_h < ERR_GATE and same and np.isfinite(err_s)
            and err_s < SUM_GATE and np.isfinite(err_ip) and err_ip < ERR_GATE):
        raise AssertionError("a rotation check failed")

    us = {}
    for name, fn in (("plain", plain), ("hoisted", hoisted), ("rot_sum", rot_sum)):
        with eager_ops():
            times = median_ms(fn, 3)
            us[name] = statistics.median(times) * 1e3 / len(ROTS)
            print(f"[timing rotations] {name}: {us[name]:.1f} us/rotation (median of "
                  f"{len(times)} passes of R={len(ROTS)}, min "
                  f"{min(times) * 1e3 / len(ROTS):.1f}, max {max(times) * 1e3 / len(ROTS):.1f}; "
                  f"N={N_ROT}; eager; {card})")
            busy_line(f"rotations {name}", fn, statistics.median(times))
    print(f"[timing rotations] hoisting speed-up {us['plain'] / us['hoisted']:.2f}x, "
          f"rotation sum speed-up {us['plain'] / us['rot_sum']:.2f}x over plain rotations")
    if profile_on:
        profile_table("rotations hoisted", hoisted)
    world = types.SimpleNamespace(sch=sch, sk=sk, pk=pk, gen=gen, rot_keys=rot_keys, relin=relin,
                                  ct=ct, v=v, cu1=cu1, cu2=cu2, u1=u1, u2=u2)
    return cases.take_launches(launches), world


# ---------------------------------------------------------------------------
# Path 3: the NTT north star at N=2^14 and N=2^16, both implementations
# ---------------------------------------------------------------------------

def ab_line(tag, fa, fb, names, card):
    """Device and wall time per call of two functions that must agree."""
    import torch

    a, b = fa(), fb()
    if not torch.equal(a, b):
        raise AssertionError(f"[A/B] {tag}: {names[0]} and {names[1]} differ")
    dev = [device_ms(f, 10) for f in (fa, fb)]
    wall = [cuda_ms(f, 10) for f in (fa, fb)]
    print(f"[A/B] {tag}: bit-equal; device time per call: {names[0]} {show_us(dev[0])}, "
          f"{names[1]} {show_us(dev[1])}; wall mean {wall[0] * 1e3:.1f} / "
          f"{wall[1] * 1e3:.1f} us ({card})")


def ntt_chain(run, x, steps):
    """``steps`` transforms, each output the next input."""
    for _ in range(steps):
        x = run(x)
    return x


def ntt_kernel_checks(cases, n, impls, x, card):
    """Kernel 6 (and 1b at 2^16) against the plain versions on the phase's
    inputs, with a limb subset; kernels 1 and 1b stage by stage and kernel 6
    pass by pass on every limb (m = 128 at 2^14, 256 at 2^16); the A/B
    lines."""
    from ppqsflhe_tpu_torch.ops.cuda_mxu_ntt import route

    mx, bf = impls["digit-matmul"], impls["butterfly"]
    B, L = x.shape[0], x.shape[1]
    tag = f"N=2^{n.bit_length() - 1}"
    for fwd in (True, False):
        for sel in (list(range(L)), [2, 0]):
            xs = x[:, sel].contiguous()
            run = lambda: (bf.ntt if fwd else bf.intt)(xs, sel)
            plain = lambda: bf.plain(xs, fwd, sel)
            cases.check(f"fourstep_ntt ({'forward' if fwd else 'inverse'}, limbs {sel} x {B} "
                        f"polys, {tag})", "fourstep_ntt", SRC_FS, K6, run(), plain(), run, plain,
                        10, butterfly_work(len(sel), B, bf.n1, bf.n2))
    mont = [i for i, t in enumerate(mx.tabs) if route(n, t.nd) == "fused_mont"]
    if n == N_BIG:
        if not mont:
            raise AssertionError("no limb of the N=2^16 chain routes to kernel 1b")
        xs = x[:, mont].contiguous()
        for fwd in (True, False):
            run = lambda: mx.fused(xs, fwd, mont, mont=True)
            fused_case(cases, mx, xs, mont, fwd, True, run, 10,
                       f"limbs {mont} x {B} polys, {tag}")
            ab_line(f"nd=6 {'forward' if fwd else 'inverse'}, limbs {mont} x {B} polys, {tag}",
                    run, lambda: mx.fused(xs, fwd, mont), ("kernel 1b (Montgomery twiddle)",
                                                           "kernel 1 (Shoup twiddle)"), card)
    fused_stage_checks(cases, mx, x, tag)
    fourstep_pass_checks(cases, bf, x, tag)
    for fwd in (True, False):
        name = "ntt" if fwd else "intt"
        ab_line(f"{name}, limbs 0-{L - 1} x {B} polys, {tag}",
                lambda: getattr(bf, name)(x), lambda: getattr(mx, name)(x),
                ("butterfly (kernel 6)", "digit-matmul route"), card)


def ntt_phase(card, device):
    """bench_kernels.py's NTT loop through the port's four-step runner, in
    both implementations at both sizes: kernel checks, then the chained
    transforms as the main path (forward then inverse), bit-equal across
    implementations, to the plain version, and back to the input; µs per
    limb-NTT and limb-NTT/s."""
    import torch

    from ppqsflhe_tpu_torch.core import primes
    from ppqsflhe_tpu_torch.ops.cuda_mxu_ntt import route
    from ppqsflhe_tpu_torch.ops.cuda_ntt import BUTTERFLY, MXU, four_step_ntt

    cases = KernelCases(card)
    runs = []
    for n, L, B in NTT_SIZES:
        t0 = time.perf_counter()
        moduli = [primes.first_prime_down(59, 2 * n)] + primes.prime_chain(40, 3, 2 * n)
        moduli = moduli[:L]
        psis = [primes.root_of_unity(2 * n, q) for q in moduli]
        impls = {"digit-matmul": four_step_ntt(n, moduli, psis, MXU),
                 "butterfly": four_step_ntt(n, moduli, psis, BUTTERFLY)}
        gen = torch.Generator().manual_seed(SEED)
        x = rand_residues(moduli, (B,), n, gen, device)
        routes = [route(n, t.nd) for t in impls["digit-matmul"].tabs]
        print(f"[ntt N={n} L={L} B={B}] moduli {[q.bit_length() for q in moduli]} bits, "
              f"digit-matmul routes {routes}; tables {time.perf_counter() - t0:.1f} s")
        ntt_kernel_checks(cases, n, impls, x, card)
        runs.append((n, L, B, impls, x))

    reset_counts()
    launches_by_n = {}
    for n, L, B, impls, x in runs:
        before = read_counts()
        outs = {}
        for name, f in impls.items():
            y = ntt_chain(f.ntt, x, NTT_CHAIN)
            outs[name] = (y, ntt_chain(f.intt, y, NTT_CHAIN))
        torch.cuda.synchronize()
        launches_by_n[n] = {k: v - before[k] for k, v in read_counts().items()}
        (y0, z0), (y1, z1) = outs.values()
        plain = ntt_chain(lambda v: impls["butterfly"].plain(v, True, range(L)), x, NTT_CHAIN)
        if not (torch.equal(y0, y1) and torch.equal(y0, plain)):
            raise AssertionError(f"N={n}: the chained transforms differ between "
                                 f"implementations or from the plain version")
        if not (torch.equal(z0, x) and torch.equal(z1, x)):
            raise AssertionError(f"N={n}: intt(ntt(x)) != x")
        print(f"[ntt N={n} L={L} B={B}] {NTT_CHAIN} chained forward transforms bit-equal "
              f"across implementations and to the plain version; {NTT_CHAIN} inverse give the "
              f"input back; kernel launches "
              f"{ {k: v for k, v in launches_by_n[n].items() if v} }")
    need = {NTT_SIZES[0][0]: ("mxu_ntt", "fourstep_ntt"),
            N_BIG: ("mxu_ntt_mont", "streamed_stage_a", "streamed_stage_b", "fourstep_ntt")}
    for n, keys in need.items():
        missing = [k for k in keys if launches_by_n[n][k] == 0]
        if missing:
            raise AssertionError(f"the NTT loop at N={n} never launched {missing}")
    launches = read_counts()

    for n, L, B, impls, x in runs:
        for name, f in impls.items():
            for fwd in (True, False):
                start = x if fwd else f.ntt(x)
                run = lambda: ntt_chain(f.ntt if fwd else f.intt, start, NTT_CHAIN)
                count = NTT_CHAIN * B * L
                dev = device_ms(run, 1)
                wall = cuda_ms(run, 3)
                per = lambda v: None if v is None else v / count
                rate = "" if dev is None else f", {count / dev * 1e3:,.0f} limb-NTT/s"
                print(f"[timing ntt N=2^{n.bit_length() - 1} L={L} B={B}] {name} "
                      f"{'forward' if fwd else 'inverse'}: device {show_us(per(dev))}/limb-NTT"
                      f"{rate}; wall {wall / count * 1e3:.2f} us/limb-NTT "
                      f"({count / wall * 1e3:,.0f} limb-NTT/s) ({card})")
    return cases.take_launches(launches)


# ---------------------------------------------------------------------------
# Path 4: the server round at N=2^16
# ---------------------------------------------------------------------------

def round16_kernel_checks(cases, sch, rk_mont, gen, device):
    """Kernels 1b, 4, 5, 2, 3 and 9 against their plain versions at shapes
    the N=2^16 round gives them."""
    import torch

    from ppqsflhe_tpu_torch.ckks.eval import _ks_decomp_consts
    from ppqsflhe_tpu_torch.ops import cuda_ext, cuda_mxu_ntt, streamed_ntt
    from ppqsflhe_tpu_torch.ops.cuda_ks import ks_inner_product, ks_inner_product_plain

    ctx, n = sch.ctx, sch.params.n
    fntt = ctx.fntt
    mq = ctx.moduli_qp
    L, K = sch.params.num_q, sch.params.num_p
    routes = [cuda_mxu_ntt.route(n, t.nd) for t in fntt.tabs]
    print(f"[route N={n}] {routes}")
    mont = [i for i, r in enumerate(routes) if r == "fused_mont"]
    big = [i for i, r in enumerate(routes) if r == "big"]
    if not mont or not big:
        raise AssertionError("the N=2^16 chain must route limbs to kernel 1b and to 4+5")

    # kernel 1b: ModDown's NTT back to Q at full level (q1, q2 over both
    # components) and the lazy schedule's iNTT of c1 (q1 over 27 polys)
    for sel, lead, fwd in ((mont, (2 * N_CTS,), True), (mont[:1], (N_CTS,), False)):
        x = rand_residues([mq[i] for i in sel], lead, n, gen, device)
        run = lambda: (ctx.ntt if fwd else ctx.intt)(x, sel)
        fused_case(cases, fntt, x, sel, fwd, True, run, 5,
                   f"limbs {sel} x {lead[0]} polys, N=2^16")

    # kernels 4 and 5: the extended digit's forward NTT on the 60-bit limbs
    sel = [i for i in big if i not in ctx.q_idx(1)] or big
    st = fntt.big.streamed
    tabs = [st.limb(i) for i in sel]
    xb = rand_residues([mq[i] for i in sel], (N_CTS,), n, gen, device).reshape(
        N_CTS, len(sel), fntt.n1, fntt.n2)
    buf, info_a, info_b = st.device(device, sel, True)
    ya = torch.empty_like(xb)
    run_a = lambda: streamed_ntt.stage_a(xb, ya, buf, info_a, True, fntt.n2)
    plain_a = lambda: streamed_ntt.stage_a_plain(xb, tabs, True)
    tag = f"forward, limbs {sel} x {N_CTS} polys, N=2^16"
    floor = digit_floor([fntt.tabs[i] for i in sel], N_CTS, (fntt.n1, fntt.n2))
    cases.check(f"streamed_stage_a ({tag})", "streamed_stage_a", SRC_STREAMED, K4,
                run_a().clone(), plain_a(), run_a, plain_a, 5,
                stage_work(len(sel), N_CTS, fntt.n1, fntt.n2, 16), note=floor)
    zb = torch.empty((N_CTS, len(sel), fntt.n2, fntt.n1), dtype=torch.int64, device=device)
    run_b = lambda: streamed_ntt.stage_b(ya, zb, buf, info_b, True)
    plain_b = lambda: streamed_ntt.stage_b_plain(ya, tabs, True)
    cases.check(f"streamed_stage_b ({tag})", "streamed_stage_b", SRC_STREAMED, K5,
                run_b().clone(), plain_b(), run_b, plain_b, 5,
                stage_work(len(sel), N_CTS, fntt.n2, fntt.n1), note=floor)

    # kernel 2: the full-level first digit's extension and ModDown P → Q
    idx_ext = ctx.q_idx(L) + ctx.p_idx()
    groups, consts = _ks_decomp_consts(ctx, L)
    g0 = groups[0]
    for src, dst, pre, lead in ((g0, tuple(i for i in idx_ext if i not in g0), consts[0],
                                 (N_CTS,)), (ctx.p_idx(), ctx.q_idx(L), None, (2 * N_CTS,))):
        ext = ctx.extender(src, dst)
        xe = rand_residues([mq[i] for i in src], lead, n, gen, device)
        cases.check(f"base_extend ({len(src)}->{len(dst)} limbs, "
                    f"{'pre' if pre is not None else 'ModDown'}, {lead[0]} polys, N=2^16)",
                    "base_extend", SRC_EXT, K2, cuda_ext.fused_extend(xe, ext, pre),
                    ext.extend(xe, pre), lambda: cuda_ext.fused_extend(xe, ext, pre),
                    lambda: ext.extend(xe, pre), 10, ext_work(lead[0], len(src), len(dst), n))

    # kernel 3: the full-level inner product, nd=2 digits over LK=5 limbs
    limbs = tuple(range(L + K))
    nd = len(ctx.digit_groups)
    q, qinv, _ = ctx.limb_consts(limbs, device)
    lmap = ctx.consts(("limb_map", limbs), lambda: limbs, device)
    dig = rand_residues(mq, (N_CTS, nd), n, gen, device)
    args = (dig, rk_mont.data, lmap, q, qinv)
    cases.check(f"ks_inner_product (nd={nd}, LK={len(limbs)}, {N_CTS} polys, N=2^16)",
                "ks_inner_product", SRC_KS, K3, ks_inner_product(*args),
                ks_inner_product_plain(*args), lambda: ks_inner_product(*args),
                lambda: ks_inner_product_plain(*args), 10, ks_work(N_CTS, nd, len(limbs), n))
    ks_one_digit_checks(cases, sch, rk_mont, gen, device)
    # the digit assembly at the pairwise-n16 cell's PRE levels: in at 4 limbs
    # (both digits), back at 3
    decompose_checks(cases, N_CTS, "pairwise", gen, device, n=N_BIG, levels=(4, 3))
    torch.cuda.synchronize()


def butterfly_tables_mib(fntt, device) -> tuple:
    """(limbs, MiB) of the chain's butterfly tables on ``device``, one buffer
    for kernels 1, 1b, 4 and 5: the limbs uploaded so far and its size."""
    d = fntt.tables.streamed._dev.get(str(device))
    if d is None:
        return [], 0.0
    return sorted(d["limbs"]), d["tabs"].nbytes / 2 ** 20


def round16_route_check(sch, gen, device, card):
    """The big route's whole transform on the 60-bit limbs, forward and
    inverse over N_CTS polys, bit-equal to kernel 6's transform and kernel
    1b's, with the device time of all three."""
    import torch

    from ppqsflhe_tpu_torch.ops.cuda_mxu_ntt import route
    from ppqsflhe_tpu_torch.ops.cuda_ntt import CudaFourStepNtt

    ctx, n = sch.ctx, sch.params.n
    fntt, mq = ctx.fntt, ctx.moduli_qp
    big = [i for i, t in enumerate(fntt.tabs) if route(n, t.nd) == "big"]
    bf = CudaFourStepNtt(n, [mq[i] for i in big], [fntt.tabs[i].psi for i in big])
    x = rand_residues([mq[i] for i in big], (N_CTS,), n, gen, device)
    for fwd in (True, False):
        name = "ntt" if fwd else "intt"
        runs = {"big route (kernels 4+5)": lambda: getattr(fntt, name)(x, big),
                "kernel 6": lambda: getattr(bf, name)(x),
                "kernel 1b": lambda: fntt.fused(x, fwd, big, mont=True)}
        outs = [f() for f in runs.values()]
        if not all(torch.equal(outs[0], o) for o in outs[1:]):
            raise AssertionError(f"N=2^16 {name}: the big route, kernel 6 and kernel 1b differ")
        dev = [device_ms(f, 10) for f in runs.values()]
        wall = [cuda_ms(f, 10) for f in runs.values()]
        print(f"[route N=2^16] {'forward' if fwd else 'inverse'}, limbs {big} x {N_CTS} polys: "
              f"bit-equal (big route = kernel 6 = kernel 1b); device time per transform: "
              + ", ".join(f"{k} {show_us(d)}" for k, d in zip(runs, dev))
              + f"; wall mean {' / '.join(f'{v * 1e3:.1f}' for v in wall)} us ({card})")


def round16_phase(card, device, profile_on):
    """The server round at N=2^16 (8192 slots): set-up, kernel checks, main
    path in both schedules, decrypt, ms/round, the context's device memory,
    then the big route against kernels 6 and 1b. Returns the kernels' rows
    and the round's world."""
    import torch

    from ppqsflhe_tpu_torch.ops.cuda_mxu_ntt import route

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    w = round_world(N_BIG, device, slots=SLOTS)
    cases = KernelCases(card)
    round16_kernel_checks(cases, w.sch, w.rk12, w.gen, device)
    need = ("mxu_ntt_mont", "streamed_stage_a", "streamed_stage_b", "base_extend",
            "ks_inner_product", "decompose")
    _, launches = drive_round("round N=2^16", w.sch, w, {4: need, 0: need})
    time_round("round N=2^16", w.sch, w, card, profile_on)
    mib = lambda v: (v - base) / 2 ** 20
    fntt = w.sch.ctx.fntt
    limbs, tables = butterfly_tables_mib(fntt, device)
    per_limb = tables / len(limbs)
    fused = [i for i in limbs if route(N_BIG, fntt.tabs[i].nd) != "big"]
    print(f"[memory N=2^16] after the round: {mib(torch.cuda.memory_allocated()):.1f} MiB "
          f"allocated above the phase's start, peak {mib(torch.cuda.max_memory_allocated()):.1f}"
          f" MiB (context, keys, 2x{N_CTS} ciphertexts, the kernel checks); butterfly tables "
          f"(kernels 1, 1b, 4, 5; no digit matrix) {tables:.1f} MiB for limbs {limbs}, of which "
          f"the fused route's {per_limb * len(fused):.1f} MiB for limbs {fused}")
    round16_route_check(w.sch, w.gen, device, card)
    limbs, after = butterfly_tables_mib(fntt, device)
    print(f"[memory N=2^16] after the route check ran kernel 1b on the big-route limbs: "
          f"butterfly tables {after:.1f} MiB for limbs {limbs} (+{after - tables:.1f} MiB)")
    return cases.take_launches(launches), w


# ---------------------------------------------------------------------------
# Path 5: the butterfly configuration of the N=2^14 round
# ---------------------------------------------------------------------------

def butterfly_phase(card, device, w, default_outs, profile_on):
    """The N=2^14 round with ntt_impl="pallas" (kernel 6 runs every NTT) on
    the default round's keys and ciphertexts: kernel checks at its shapes,
    main path in both schedules, bit-equal to the default round, decrypt,
    ms/round. Returns the kernels' rows and the butterfly scheme."""
    import dataclasses

    import torch

    from ppqsflhe_tpu_torch.ckks.scheme import CkksScheme
    from ppqsflhe_tpu_torch.ops.cuda_ntt import BUTTERFLY

    t0 = time.perf_counter()
    sch = CkksScheme(dataclasses.replace(w.sch.params, ntt_impl=BUTTERFLY), device=device)
    print(f"[setup] the N={sch.params.n} round with ntt_impl={BUTTERFLY!r}: context "
          f"{time.perf_counter() - t0:.1f} s")
    bf, mq, n = sch.ctx.fntt, sch.ctx.moduli_qp, sch.params.n
    cases = KernelCases(card)
    # kernel 6 at the round's shapes: the lazy key switch's 2-limb transforms
    # over both components, and the full-level iNTT of c1 over Q
    for sel, polys, fwd in (((0, 1), 2 * N_CTS, True), ((0, 1), 2 * N_CTS, False),
                            ((0, 1, 2), N_CTS, False)):
        x = rand_residues([mq[i] for i in sel], (polys,), n, w.gen, device)
        run = lambda: (sch.ctx.ntt if fwd else sch.ctx.intt)(x, sel)
        plain = lambda: bf.plain(x, fwd, sel)
        cases.check(f"fourstep_ntt ({'forward' if fwd else 'inverse'}, limbs {list(sel)} x "
                    f"{polys} polys, N=2^14)", "fourstep_ntt", SRC_FS, K6, run(), plain(), run,
                    plain, 20, butterfly_work(len(sel), polys, bf.n1, bf.n2))
    torch.cuda.synchronize()

    mxu_route = ("mxu_ntt", "mxu_ntt_mont", "streamed_stage_a", "streamed_stage_b")
    need = ("fourstep_ntt", "base_extend", "ks_inner_product")
    outs, launches = drive_round("butterfly round", sch, w, {4: need, 0: need},
                                 absent=mxu_route)
    for lazy in (4, 0):
        same = all(torch.equal(a.data, b.data) for a, b in zip(outs[lazy], default_outs[lazy]))
        print(f"[butterfly round lazy={lazy}] bit-equal to the default round: {same}")
        if not same:
            raise AssertionError(f"butterfly round lazy={lazy} differs from the default round")
    time_round("butterfly round", sch, w, card, profile_on)
    # the two configurations in turns in this process: default, butterfly,
    # butterfly, default
    from ppqsflhe_tpu_torch.fl.api import server_round

    for lazy in (4, 0):
        turns = []
        for name, s in (("default", w.sch), ("butterfly", sch), ("butterfly", sch),
                        ("default", w.sch)):
            with eager_ops():
                times = median_ms(lambda: server_round(s, w.ct1, w.ct2, w.rk12, w.rk21, lazy),
                                  3)
            turns.append(f"{name} {statistics.median(times):.3f}")
        print(f"[A/B round lazy={lazy}] ms/round in turns: {', '.join(turns)} ({card})")
    return cases.take_launches(launches), sch


# ---------------------------------------------------------------------------
# Path 6: the seven FL tools on files at N=2^14
# ---------------------------------------------------------------------------

GRU_SHAPES = ([7, 192], [64, 192], [2, 192], [64, 192], [64, 192], [2, 192], [64, 1], [1])
# INDCCA hop: the flooding of 2^30 at Δ=2^40 costs about sqrt(N/2)·2^-10 per
# slot (docs/SECURITY.md:58): the RMS error must stay below it and the
# largest of the payload's 39,041 values below four times it
CCA_UNIT = (N_ROUND / 2) ** 0.5 * 2.0 ** -10
CONTEXTS = (("radix2/json", {}, "json"),
            ("fourstep/pqwd", {"ntt_backend": "fourstep", "ntt_impl": "pallas_mxu"}, "bin"))


def write_weights(path, rng):
    """One client's weights JSON in the GRU's Keras layout (39,041 values,
    uniform(-1, 1)) plus one optimizer layer the tools must skip."""
    import numpy as np

    summary = []
    for i, shape in enumerate(GRU_SHAPES):
        v = rng.uniform(-1, 1, int(np.prod(shape)))
        summary.append({"layer": f"param_{i}", "shape": shape, "mean": float(v.mean()),
                        "std_dev": float(v.std()), "values": v.tolist()})
    summary.append({"layer": "optimizer/iter", "shape": [1], "mean": 0.0, "std_dev": 0.0,
                    "values": [0.0]})
    with open(path, "w") as f:
        json.dump({"weights_summary": summary}, f)
    return {e["layer"]: np.asarray(e["values"]) for e in summary[:-1]}


def decrypt_err(doc, want):
    """(max, RMS) of |decrypted - want| over every value of every layer."""
    import numpy as np

    diffs = np.concatenate([np.asarray(e["values"]) - want[e["layer"]]
                            for e in doc["weights_summary"]])
    if len(doc["weights_summary"]) != len(want) or diffs.size != sum(v.size for v in want.values()):
        raise AssertionError("decrypted document lacks layers or values")
    return float(np.abs(diffs).max()), float(np.sqrt(np.mean(diffs ** 2)))


def files_kernel_checks(cases, sch, rk_mont, gen, device, tag):
    """Kernels 2 and 3 (and 1 for four-step) at the shapes the full-level
    changeCipherDomain of a 27-ciphertext document gives them."""
    import numpy as np
    import torch

    from ppqsflhe_tpu_torch.ckks.eval import _ks_decomp_consts
    from ppqsflhe_tpu_torch.ops import cuda_ext
    from ppqsflhe_tpu_torch.ops.cuda_ks import ks_inner_product, ks_inner_product_plain

    ctx, n = sch.ctx, sch.params.n
    mq, L, K = ctx.moduli_qp, sch.params.num_q, sch.params.num_p
    idx_ext = ctx.q_idx(L) + ctx.p_idx()
    groups, consts = _ks_decomp_consts(ctx, L)
    for src, dst, pre, lead in ((groups[0], tuple(i for i in idx_ext if i not in groups[0]),
                                 consts[0], (N_CTS,)), (ctx.p_idx(), ctx.q_idx(L), None,
                                                        (2, N_CTS))):
        ext = ctx.extender(src, dst)
        xe = rand_residues([mq[i] for i in src], lead, n, gen, device)
        cases.check(f"base_extend ({tag}, {len(src)}->{len(dst)} limbs, "
                    f"{'pre' if pre is not None else 'ModDown'}, {'x'.join(map(str, lead))} "
                    f"polys, N=2^14)", "base_extend", SRC_EXT, K2,
                    cuda_ext.fused_extend(xe, ext, pre), ext.extend(xe, pre),
                    lambda: cuda_ext.fused_extend(xe, ext, pre), lambda: ext.extend(xe, pre),
                    50, ext_work(int(np.prod(lead)), len(src), len(dst), n))
    limbs = tuple(range(L + K))
    q, qinv, _ = ctx.limb_consts(limbs, device)
    sel = ctx.consts(("limb_map", limbs), lambda: limbs, device)
    dig = rand_residues(mq, (N_CTS, len(ctx.digit_groups)), n, gen, device)
    args = (dig, rk_mont.data, sel, q, qinv)
    cases.check(f"ks_inner_product ({tag}, nd={len(ctx.digit_groups)}, LK={len(limbs)}, "
                f"{N_CTS} polys, N=2^14)", "ks_inner_product", SRC_KS, K3,
                ks_inner_product(*args), ks_inner_product_plain(*args),
                lambda: ks_inner_product(*args), lambda: ks_inner_product_plain(*args), 50,
                ks_work(N_CTS, len(ctx.digit_groups), len(limbs), n))
    if not ctx.radix2:
        # kernel 1: the iNTT of c1 over Q at the start of the key switch
        idx = ctx.q_idx(L)
        x = rand_residues([mq[i] for i in idx], (N_CTS,), n, gen, device)
        fused_case(cases, ctx.fntt, x, idx, False, False, lambda: ctx.intt(x, idx), 20,
                   f"{tag}, 3 limbs x {N_CTS} polys, N=2^14")
    torch.cuda.synchronize()


def file_round(cc, container, P, dev, tag=""):
    """The file round's eleven tool calls in order, {name: call}, every key
    and document named after ``tag``, and the paths they write."""
    from ppqsflhe_tpu_torch.fl import api

    e = lambda name: P(f"{name}{tag}.{container}")
    key = lambda name: P(f"{name}.key{tag}.{container}")
    d = lambda name: P(f"{name}{tag}.json")
    calls = {
        "keyGen 1": lambda: api.key_gen(cc, key("pk1"), key("sk1"), seed=SEED + 1, device=dev),
        "keyGen 2": lambda: api.key_gen(cc, key("pk2"), key("sk2"), seed=SEED + 2, device=dev),
        "REkeyGen 1->2": lambda: api.rekey_gen(cc, key("sk1"), key("pk2"), key("rk12"),
                                               seed=SEED + 3, device=dev),
        "REkeyGen 2->1": lambda: api.rekey_gen(cc, key("sk2"), key("pk1"), key("rk21"),
                                               seed=SEED + 4, device=dev),
        "encrypt pk (v2)": lambda: api.encrypt_weights(cc, key("pk1"), P("w1.json"), e("e1"),
                                                       seed=SEED + 5, container=container,
                                                       device=dev),
        "encrypt sk (v3)": lambda: api.encrypt_weights(cc, key("sk2"), P("w2.json"), e("e2"),
                                                       seed=SEED + 6, container=container,
                                                       device=dev),
        "changeCipherDomain 1->2": lambda: api.change_cipher_domain(cc, key("rk12"), e("e1"),
                                                                    e("c12"), device=dev),
        "aggregate": lambda: api.aggregate_encrypted_weights(cc, [e("c12"), e("e2")], e("agg"),
                                                             device=dev),
        "changeCipherDomain 2->1": lambda: api.change_cipher_domain(cc, key("rk21"), e("agg"),
                                                                    e("back"), device=dev),
        "decrypt 2": lambda: api.decrypt_weights(cc, key("sk2"), e("agg"), d("d2"), device=dev),
        "decrypt 1": lambda: api.decrypt_weights(cc, key("sk1"), e("back"), d("d1"), device=dev),
    }
    paths = ([key(k) for k in ("pk1", "sk1", "pk2", "sk2", "rk12", "rk21")]
             + [e(k) for k in ("e1", "e2", "c12", "agg", "back")] + [d("d2"), d("d1")])
    return calls, paths


def radix2_timing(sch, device, card):
    """The radix-2 transforms of 3 limbs x 27 polys at N=2^14: eagerly, as
    the cached CUDA graph the tools run (copy-in, replay, clone, scrub),
    and as the same graph unscrubbed: the scrub's cost is the difference."""
    import torch

    from ppqsflhe_tpu_torch.utils import graphs

    idx = (0, 1, 2)
    x = rand_residues(sch.ctx.moduli_qp[:3], (N_CTS,), sch.params.n,
                      torch.Generator().manual_seed(SEED), device)
    unscrubbed = graphs.GraphCache()
    for name in ("ntt", "intt"):
        f = getattr(sch.ctx, name)
        run = lambda: f(x, idx)
        plain = lambda: graphs.cached(unscrubbed, name, "an unscrubbed radix-2 transform",
                                      lambda y: f(y, idx), x)
        with eager_ops():
            e_dev, e_wall = device_ms(run, 3), cuda_ms(run, 3)
        warm = graphs.WARMUP + 2
        g_wall, p_wall = cuda_ms(run, ROUNDS, warm), cuda_ms(plain, ROUNDS, warm)
        g_dev, p_dev = device_ms(run, 3), device_ms(plain, 3)
        per = None if e_dev is None else e_dev / (3 * N_CTS)
        print(f"[timing radix2 {name}] 3 limbs x {N_CTS} polys, N=2^14 (plain torch, "
              f"{sch.params.n.bit_length() - 1} stages): eager device {show_us(e_dev)} per call, "
              f"{show_us(per)} per limb-NTT, wall {e_wall * 1e3:.1f} us per call; as the cached "
              f"graph device {show_us(g_dev)}, wall {g_wall * 1e3:.1f} us; unscrubbed device "
              f"{show_us(p_dev)}, wall {p_wall * 1e3:.1f} us (the scrub "
              f"{(g_wall - p_wall) * 1e3:+.1f} us of wall) ({card})")
    unscrubbed.release()


TOOL_TURNS = 3      # turns of the file round through the graphs and inside graphs.eager()
PROFILED_TOOLS = ("changeCipherDomain 1->2", "aggregate", "decrypt 2", "encrypt sk (v3)")
# the JAX functions of the tools' graph caches' keys, and those scrubbed
TOOL_KINDS = ("ntt", "intt", "expand_a", "api_ntt", "encrypt_sk", "decrypt_batch", "aggregate")
SCRUBBED_KINDS = ("ntt", "intt", "api_ntt", "encrypt_sk", "decrypt_batch")
# host calls that enqueue device work: launches, graph launches, copies, sets
HOST_LAUNCHES = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cuGraphLaunch", "cudaMemcpy",
                 "cudaMemset")


def key_kind(key) -> str:
    """The JAX function of a graph cache's key."""
    return key[0] if isinstance(key[0], str) else key[0][0]


def tool_profile(fn):
    """(device ms, of it copies and sets ms, device activities, host calls
    that enqueue work) of one call of ``fn``, from the raw events of one
    CPU + CUDA profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    evs = prof.profiler.kineto_results.events()
    dev = [(e.name(), e.duration_ns()) for e in evs if e.device_type() == cuda]
    copies = sum(ns for name, ns in dev if name.startswith(("Memcpy", "Memset")))
    host = sum(e.name().startswith(HOST_LAUNCHES) for e in evs if e.device_type() != cuda)
    return sum(ns for _, ns in dev) / 1e6, copies / 1e6, len(dev), host


def graphs_mib(ops):
    """MiB the captured graphs of ``ops`` (``utils.graphs.OpGraph``s) hold:
    the reserved segments of their memory pools once the allocator's free
    blocks are released, plus their static inputs; None where the
    allocator's snapshot does not name the segments' pools."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    captured = [op for op in ops if op.graph is not None]
    pools = {tuple(op.graph.graph.pool()) for op in captured}
    segments = torch.cuda.memory_snapshot()
    if any("segment_pool_id" not in seg for seg in segments):
        return None
    held = sum(seg["total_size"] for seg in segments if tuple(seg["segment_pool_id"]) in pools)
    held += sum(t.numel() * t.element_size() for op in captured for t in op.static)
    return held / 2 ** 20


def tool_graph_checks(card, device, tag, cc, container, P):
    """The file round's tools through their CUDA graphs and inside
    ``graphs.eager()``, in turns (after the cold and warm runs, so each key
    has had its warm-up calls): every file the graphs write byte-equal to
    the eager tools' in every turn; warm ms per tool both ways; device ms,
    device activities and host launch calls of four tools both ways; each
    new cache's graphs (captured, replayed), the scrubbed ones' static
    buffers zero after a call, and the device memory they hold."""
    from pathlib import Path

    import torch

    from ppqsflhe_tpu_torch.fl import api
    from ppqsflhe_tpu_torch.utils import graphs

    dev = str(device)
    read = lambda path: Path(path).read_bytes()
    rounds = {mode: file_round(cc, container, P, dev, f".{mode}") for mode in ("graphs", "eager")}
    scope = {"graphs": contextlib.nullcontext, "eager": eager_ops}
    times = {mode: {name: [] for name in calls} for mode, (calls, _) in rounds.items()}
    for turn in range(TOOL_TURNS):
        for mode, (calls, _) in rounds.items():
            with scope[mode]():
                for name, fn in calls.items():
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    times[mode][name].append((time.perf_counter() - t0) * 1e3)
        differ = [os.path.basename(g) for g, e in zip(rounds["graphs"][1], rounds["eager"][1])
                  if read(g) != read(e)]
        if differ:
            raise AssertionError(f"{tag}, turn {turn + 1}: the files the graphs wrote differ "
                                 f"from the eager tools' {differ}")
    warm = {mode: {name: statistics.median(t[1:]) for name, t in ts.items()}
            for mode, ts in times.items()}
    print(f"[files {tag} graphs] warm ms per tool (wall, file I/O included; median of turns "
          f"2-{TOOL_TURNS} of {TOOL_TURNS}), through the graphs vs inside graphs.eager(): "
          + ", ".join(f"{name} {warm['graphs'][name]:.1f} vs {warm['eager'][name]:.1f}"
                      for name in warm["graphs"])
          + f"; sum {sum(warm['graphs'].values()):.1f} vs {sum(warm['eager'].values()):.1f}; "
          f"all {len(rounds['graphs'][1])} files byte-equal in each turn ({card})")
    for name in PROFILED_TOOLS:
        parts = []
        for mode, (calls, _) in rounds.items():
            with scope[mode]():
                dms, copies, n_dev, n_host = tool_profile(calls[name])
            parts.append(f"{mode} device {dms:.3f} ms (copies and sets {copies:.3f}) in "
                         f"{n_dev} device activities, "
                         f"{n_host if n_host else 'not measured'} host launch calls")
        print(f"[files {tag} graphs] {name}: {'; '.join(parts)} (one call, profiler) ({card})")

    sch = api.load_scheme(cc, dev)
    caches = {"context": sch.ctx._graphs,
              "scheme": {k: op for k, op in sch._graphs.items() if key_kind(k) in TOOL_KINDS}}
    if sch.ctx.radix2:
        caches["radix-2"] = sch.ctx.fntt._graphs
    ops = [(key_kind(k), op) for cache in caches.values() for k, op in cache.items()]
    stats = {name: (sum(1 for n, _ in ops if n == name),
                    sum(op.graph is not None for n, op in ops if n == name),
                    sum(op.replays for n, op in ops if n == name)) for name, _ in ops}
    want = [k for k in TOOL_KINDS if sch.ctx.radix2 or k not in ("ntt", "intt")]
    unreplayed = [k for k in want if not stats.get(k, (0, 0, 0))[2]]
    held = sorted({name for name, op in ops if name in SCRUBBED_KINDS and op.graph is not None
                   and (not op.scrub or any(t.any() for t in [
                       *op.static, *graphs._tensors(op.graph.output)]))})
    per_cache = {name: sum(op.graph is not None for op in c.values())
                 for name, c in caches.items()}
    replayed = {k: sum(op.graph.launches[k] * op.replays for _, op in ops
                       if op.graph is not None) for k in graphs.COUNTERS}
    mib = graphs_mib([op for _, op in ops])
    print(f"[files {tag} graphs] the caches' keys by JAX function (entries, captured, "
          f"replays): {stats}; graphs captured per cache: {per_cache}; kernel launches "
          f"their replays ran: { {k: v for k, v in replayed.items() if v} }; the scrubbed "
          f"graphs' static buffers zero after a call: {not held}; device memory they hold "
          f"(their pools' reserved segments once free blocks are released, and their static "
          f"inputs): " + ("not measured" if mib is None else f"{mib:.1f} MiB") + f" ({card})")
    if unreplayed or held:
        raise AssertionError(f"{tag}: caches never replayed {unreplayed}; scrubbed graphs "
                             f"holding data {held}")


def files_phase(card, device, profile_on):
    """The file round through the port's tools, in the radix-2/JSON and the
    four-step/PQWD contexts, then one INDCCA hop; ms per tool, device ms of
    the server's tools, radix-2 transform time. Returns the kernels' rows."""
    import tempfile

    import numpy as np
    import torch

    from ppqsflhe_tpu_torch.ckks import serialize as ser
    from ppqsflhe_tpu_torch.fl import api

    dev = str(device)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        P = lambda name: os.path.join(tmp, name)
        rng = np.random.default_rng(SEED)
        want1, want2 = write_weights(P("w1.json"), rng), write_weights(P("w2.json"), rng)
        mean = {k: (want1[k] + want2[k]) / 2 for k in want1}
        with open(os.path.join(REPO, "configs", "config_cc.json")) as f:
            base_cfg = json.load(f)
        for tag, extra, container in CONTEXTS:
            cc = P(f"cc_{container}.json")
            e = lambda name: P(f"{name}.{container}")
            key = lambda name: P(f"{name}.key.{container}")
            api.gen_cc(dict(base_cfg, **extra), cc)
            calls = file_round(cc, container, P, dev)[0]
            ccd, agg = calls["changeCipherDomain 1->2"], calls["aggregate"]
            times, outs = {}, {}
            reset_counts()
            for rep in ("cold", "warm"):
                for name, fn in calls.items():
                    t0 = time.perf_counter()
                    outs[name] = fn()
                    torch.cuda.synchronize()
                    times[name] = (time.perf_counter() - t0) * 1e3
                d2, d1 = outs["decrypt 2"], outs["decrypt 1"]
                if rep == "cold":
                    launches = read_counts()
                print(f"[files {tag} {rep}] ms per tool (wall, file I/O included): "
                      + ", ".join(f"{k} {v:.1f}" for k, v in times.items()) + f" ({card})")
            sch = api.load_scheme(cc, dev)
            n_cts = len(ser.load_enc_doc(e("e1"))["weights_summary"])
            docs = {k: ser.load_enc_doc(e(k)) for k in ("e1", "c12")}
            loaded = {k: api._stack(api._load_cts([f[3] for f in api._doc_fields(d)], sch))
                      for k, d in docs.items()}
            B = loaded["e1"].data.shape[0]
            if (B != N_CTS or n_cts != len(GRU_SHAPES)
                    or ser.doc_is_binary(e("e1")) != (container == "bin")):
                raise AssertionError(f"{tag}: {B} ciphertexts over {n_cts} layers "
                                     f"(want {N_CTS} over {len(GRU_SHAPES)}), container")
            rk12 = api._load_rekey_mont(sch, key("rk12"))
            mem = api.change_cipher_domain_batch(sch, rk12, loaded["e1"])
            same = torch.equal(mem.data, loaded["c12"].data) and mem.scale == loaded["c12"].scale
            e2, r2 = decrypt_err(d2, mean)
            e1, r1 = decrypt_err(d1, mean)
            print(f"[files {tag}] {B} ciphertexts per client; changeCipherDomain bit-equal to "
                  f"change_cipher_domain_batch: {same}; decrypt max err vs the plaintext mean: "
                  f"client 2 {e2:.3e}, client 1 {e1:.3e} (gate {ERR_GATE}); kernel launches "
                  f"{ {k: v for k, v in launches.items() if v} }")
            if not same:
                raise AssertionError(f"{tag}: changeCipherDomain differs from the in-memory batch")
            if not (np.isfinite(e1) and np.isfinite(e2) and max(e1, e2) < ERR_GATE):
                raise AssertionError(f"{tag}: decrypt error {max(e1, e2)} over the gate")
            need = ("base_extend", "ks_inner_product") + (() if sch.ctx.radix2 else ("mxu_ntt",))
            ntt_kernels = ("mxu_ntt", "mxu_ntt_mont", "streamed_stage_a", "streamed_stage_b",
                           "fourstep_ntt")
            missing = [k for k in need if launches[k] == 0]
            wrong = [k for k in ntt_kernels if launches[k]] if sch.ctx.radix2 else []
            if missing or wrong:
                raise AssertionError(f"{tag}: never launched {missing}; launched {wrong}")
            for name, fn in (("changeCipherDomain", ccd), ("aggregate", agg)):
                print(f"[files {tag}] {name}: device {show_us(device_ms(fn, 1))} per call "
                      f"(profiler, all device activities) ({card})")
            busy_line(f"files {tag} changeCipherDomain", ccd, times["changeCipherDomain 1->2"])
            if profile_on:
                profile_table(f"files {tag} changeCipherDomain", ccd)
            if sch.ctx.radix2:
                radix2_timing(sch, device, card)
            cases = KernelCases(card)
            files_kernel_checks(cases, sch, rk12, torch.Generator().manual_seed(SEED), device,
                                tag)
            rows += cases.take_launches(launches)
            tool_graph_checks(card, device, tag, cc, container, P)

        # one INDCCA hop on the radix-2 round's keys (same chain and order)
        cca = P("cc_cca.json")
        with open(os.path.join(REPO, "configs", "config_cc_indcca.json")) as f:
            api.gen_cc(json.load(f), cca)
        if api.load_scheme(cca, dev).params.pre_mode != "INDCCA":
            raise AssertionError("config_cc_indcca.json did not give an INDCCA context")
        t0 = time.perf_counter()
        api.change_cipher_domain(cca, P("rk12.key.json"), P("e1.json"), P("cca.json"),
                                 pub_path=P("pk2.key.json"), seed=SEED, device=dev)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        err, rms = decrypt_err(api.decrypt_weights(cca, P("sk2.key.json"), P("cca.json"),
                                                   P("dcca.json"), device=dev), want1)
        print(f"[files INDCCA] one hop 1->2 with the target public key: {ms:.1f} ms; decrypt "
              f"err max {err:.4f}, RMS {rms:.4f} (gates: RMS < sqrt(N/2)*2^-10 = {CCA_UNIT:.4f}, "
              f"max < {4 * CCA_UNIT:.4f}; predicted RMS sqrt(N/2)*2^30/sqrt(3)/2^40 = "
              f"{CCA_UNIT / 3 ** 0.5:.4f}) ({card})")
        if not (np.isfinite(err) and rms < CCA_UNIT and err < 4 * CCA_UNIT):
            raise AssertionError(f"INDCCA hop: error max {err}, RMS {rms} over the gate")
    return rows


# ---------------------------------------------------------------------------
# Path 7: the 16-client multikey round of bench_multikey.py at N=2^14
# ---------------------------------------------------------------------------

def multikey_kernel_checks(cases, sch, w, gen, device):
    """Kernels 1, 2 and 3 against their plain versions at the multikey
    round's shapes: the 154 c1 polys of one PRE and the 308 polys (both
    components) of its ModDown."""
    import numpy as np

    from ppqsflhe_tpu_torch.ckks.eval import _ks_decomp_consts
    from ppqsflhe_tpu_torch.ops import cuda_ext
    from ppqsflhe_tpu_torch.ops.cuda_ks import ks_inner_product, ks_inner_product_plain

    ctx, n = sch.ctx, sch.params.n
    mq = ctx.moduli_qp
    B = w.stacks.data.shape[1]
    # kernel 1: the iNTT of c1 over Q_2 (154 polys), the NTT back over Q_2
    # after the ModDown's extension (308 polys)
    for fwd, B_k in ((False, B), (True, 2 * B)):
        idx = (0, 1)
        x = rand_residues([mq[i] for i in idx], (B_k,), n, gen, device)
        run = (lambda: ctx.ntt(x, idx)) if fwd else (lambda: ctx.intt(x, idx))
        fused_case(cases, ctx.fntt, x, idx, fwd, False, run, 10,
                   f"2 limbs x {B_k} polys, N=2^14, multikey")
    # kernel 2 at the inbound (l=2) and lazy-4 outbound (l=1) levels: the
    # digit's extension to P (its constant folded in) over the 154 c1 polys,
    # and the ModDown P -> Q_l over both components (308 polys)
    for l in (2, 1):
        groups, consts = _ks_decomp_consts(ctx, l)
        for src, dst, pre, lead in ((groups[0], ctx.p_idx(), consts[0], (B,)),
                                    (ctx.p_idx(), ctx.q_idx(l), None, (2, B))):
            ext = ctx.extender(src, dst)
            xe = rand_residues([mq[i] for i in src], lead, n, gen, device)
            cases.check(f"base_extend (l={l}, {len(src)}->{len(dst)} limbs, "
                        f"{'pre' if pre is not None else 'ModDown'}, "
                        f"{'x'.join(map(str, lead))} polys, N=2^14, multikey)", "base_extend",
                        SRC_EXT, K2, cuda_ext.fused_extend(xe, ext, pre), ext.extend(xe, pre),
                        lambda: cuda_ext.fused_extend(xe, ext, pre), lambda: ext.extend(xe, pre),
                        20, ext_work(int(np.prod(lead)), len(src), len(dst), n))
    # kernel 3: one digit over LK = 4 (l=2) and 3 (l=1) limbs, 154 polys
    for l in (2, 1):
        limbs = tuple(ctx.q_idx(l)) + ctx.p_idx()
        q, qinv, _ = ctx.limb_consts(limbs, device)
        sel = ctx.consts(("limb_map", limbs), lambda: limbs, device)
        dig = rand_residues([mq[i] for i in limbs], (B, 1), n, gen, device)
        args = (dig, w.rk_to[0].data, sel, q, qinv)
        run, plain = lambda: ks_inner_product(*args), lambda: ks_inner_product_plain(*args)
        cases.check(f"ks_inner_product (nd=1, LK={len(limbs)}, {B} polys, l={l}, N=2^14, "
                    f"multikey)", "ks_inner_product", SRC_KS, K3, run(), plain(), run, plain, 20,
                    ks_work(B, 1, len(limbs), n))
    moddown_checks(cases, 2 * B, "multikey", gen, device)
    decompose_checks(cases, B, "multikey", gen, device)


def multikey_phase(card, device):
    """16 clients × 154 ciphertexts (the LSTM export, 1,091,101 values) at
    N=2^14: prep on the card, kernel checks, the round in both schedules
    with fresh launch counters (decrypt gates: the whole average under the
    hub's key, the outbound ciphertexts of clients 0 and 14 under theirs),
    then ms per round, rounds/s and the device's busy share. Returns the
    kernels' rows and the phase's world (phase 16 compiles the round on
    it)."""
    import numpy as np
    import torch

    import types

    from ppqsflhe_tpu_torch.bench import multikey as mk
    from ppqsflhe_tpu_torch.ckks.scheme import CkksScheme

    sch = CkksScheme(mk.params(), device=device)
    vecs, n_params = mk.payloads(SEED, MK_CLIENTS, sch.encoder.slots)
    t0 = time.perf_counter()
    w = mk.prep(sch, vecs, torch.Generator(device=device).manual_seed(SEED))
    B = w.stacks.data.shape[1]
    print(f"[setup multikey] {MK_CLIENTS} clients x {B} ciphertexts ({n_params} values each), "
          f"N={sch.params.n}: prep {time.perf_counter() - t0:.1f} s on the card (keygen "
          f"{w.seconds['keygen']:.1f}, {2 * (MK_CLIENTS - 1)} rekeys {w.seconds['rekeys']:.1f}, "
          f"{MK_CLIENTS * B} encryptions {w.seconds['encrypt']:.1f}); stacks "
          f"{w.stacks.data.numel() * 8 / 1e9:.2f} GB ({card})")
    if B != 154 or n_params != 1_091_101:
        raise AssertionError(f"multikey payload: {B} ciphertexts, {n_params} values")
    cases = KernelCases(card)
    multikey_kernel_checks(cases, sch, w, torch.Generator().manual_seed(SEED), device)
    staged = {lazy: mk.stage(w.stacks, mk.inbound_level(sch, lazy)) for lazy in (4, 0)}
    torch.cuda.synchronize()

    need = ("mxu_ntt", "base_extend", "ks_inner_product", "moddown_tail", "decompose")
    reset_counts()
    per_sched = {}
    for lazy in (4, 0):
        before = read_counts()
        avg, outs = mk.server_round(sch, staged[lazy], w.rk_to, w.rk_from, lazy)
        torch.cuda.synchronize()
        per_sched[lazy] = {k: v - before[k] for k, v in read_counts().items()}
        errs = mk.check(sch, w, vecs, avg, outs)
        print(f"[multikey lazy={lazy}] kernel launches "
              f"{ {k: v for k, v in per_sched[lazy].items() if v} }; decrypt max err over all "
              f"{B} ciphertexts and slots: "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f" (gate {ERR_GATE}); average {tuple(avg.data.shape)} at {avg.nlimbs} limb(s), "
              f"outbound {tuple(outs.data.shape)} ({card})")
        missing = [k for k in need if per_sched[lazy][k] == 0]
        if missing:
            raise AssertionError(f"multikey lazy={lazy}: never launched {missing}")
        if not all(np.isfinite(e) and e < ERR_GATE for e in errs.values()):
            raise AssertionError(f"multikey lazy={lazy}: decrypt error {errs} over the gate")
        del avg, outs
    launches = read_counts()

    for lazy in (4, 0):
        m = mk.measure(sch, staged[lazy], w.rk_to, w.rk_from, lazy)
        print(f"[timing multikey lazy={lazy}] {m['ms']:.3f} ms/round, {m['rounds_per_sec']:.3f} "
              f"rounds/s ((t3 - t1)/2 over chained rounds: t1 {m['t1_ms']:.3f}, t3 "
              f"{m['t3_ms']:.3f} ms); {MK_CLIENTS} clients x {B} ciphertexts, N=2^14 ({card})")
        parts = ", ".join(f"{k} {v:.3f}" for k, v in m["by_kernel"].items())
        dev = "not measured" if m["device_ms"] is None else f"{m['device_ms']:.3f} ms"
        idle = "not measured" if m["idle_share"] is None else f"{m['idle_share']:.1%}"
        print(f"[busy multikey lazy={lazy}] device {dev} per round ({parts}); host enqueue "
              f"{m['enqueue_ms']:.3f} ms; idle share {idle} of {m['ms']:.3f} ms ({card})")
    del staged
    return cases.take_launches(launches), types.SimpleNamespace(sch=sch, w=w, vecs=vecs)


# ---------------------------------------------------------------------------
# Path 8: threshold CKKS at 16 parties, N=2^14
# ---------------------------------------------------------------------------

def smudge_sigma(parties, n, bits, scale):
    """The slot error's std-dev from ``parties`` floods uniform in
    ±2^bits per coefficient: √(P·N/6)·2^bits / scale."""
    return (parties * n / 6) ** 0.5 * 2.0 ** bits / scale


def slot_errors(sch, coeffs, ct, want):
    """(RMS, max) of decoded − want over every ciphertext of the batch and
    every slot."""
    import numpy as np

    from ppqsflhe_tpu_torch.bench.multikey import slot_diffs

    d = slot_diffs(sch, coeffs, ct, want)
    return float(np.sqrt(np.mean(d ** 2))), float(np.abs(d).max())


def threshold_phase(card, device):
    """16 parties on the N=2^14 chain: the CRS (bit-equal to the JAX
    package's, by hash), 16 key shares and the joint key, each party's
    154-ciphertext payload encrypted under it, ``multikey.aggregate_local``,
    16 batched partial decryptions and the fusion (smudging 2^30, then
    none), then Shamir 9-of-16: the sets {1..9} and {8..16} decrypt, {1..8}
    does not. Returns the kernels' rows and the encryptions' seconds split
    as ``bench.multikey.encrypt_split`` times them."""
    import hashlib

    import numpy as np
    import torch

    from ppqsflhe_tpu_torch.bench import multikey as mk
    from ppqsflhe_tpu_torch.ckks import multikey, threshold as th
    from ppqsflhe_tpu_torch.ckks.scheme import CkksScheme
    from ppqsflhe_tpu_torch.convert import residues_np
    from ppqsflhe_tpu_torch.core import jax_prng

    sch = CkksScheme(mk.params(), device=device)
    ctx, n = sch.ctx, sch.params.n
    cases = KernelCases(card)
    # kernel 1 at the CRS's shape: one poly over the 5 QP limbs, and the
    # Shamir coefficients' 8 polys
    all_idx = tuple(range(len(ctx.moduli_qp)))
    crs_coeff = torch.from_numpy(jax_prng.uniform_rns(CRS_SEED, ctx.moduli_qp, n).view(
        np.int64)).to(device)
    gen_k = torch.Generator().manual_seed(SEED)
    for tag, x in (("CRS", crs_coeff[None]),
                   ("Shamir", rand_residues(ctx.moduli_qp, (TH_T - 1,), n, gen_k, device))):
        fused_case(cases, ctx.fntt, x, all_idx, True, False, lambda: ctx.ntt(x, all_idx), 10,
                   f"5 QP limbs x {x.shape[0]} polys, N=2^14, threshold {tag}")
    vecs, _ = mk.payloads(SEED + 1, TH_PARTIES, sch.encoder.slots)
    mean = [np.mean([v[k] for v in vecs], axis=0) for k in range(len(vecs[0]))]
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    torch.cuda.synchronize()

    reset_counts()
    times = {}

    def step(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3
        return out

    a = step("CRS", lambda: th.common_random_poly(ctx, CRS_SEED, device))
    digest = hashlib.sha256(residues_np(a).astype("<u8").tobytes()).hexdigest()
    print(f"[threshold] CRS seed {CRS_SEED:#x}: SHA-256 of its {tuple(a.shape)} residues "
          f"{digest} (the JAX package's: {CRS_SHA256}) ({card})")
    if digest != CRS_SHA256:
        raise AssertionError("the CRS differs from the JAX package's")
    parts = step(f"{TH_PARTIES} partial_keygen", lambda: [th.partial_keygen(ctx, a, gen)
                                               for _ in range(TH_PARTIES)])
    shares = [s for s, _ in parts]
    pk = step("joint_public_key", lambda: th.joint_public_key(ctx, a, [b for _, b in parts]))
    cts, split = step(f"encrypt {TH_PARTIES} x {len(vecs[0])}",
                      lambda: mk.encrypt_split(sch, [pk] * TH_PARTIES, vecs, gen))
    agg = step("aggregate_local", lambda: multikey.aggregate_local(ctx, cts))
    del cts
    results = {}
    for bits in (th.DEFAULT_SMUDGING_BITS, 0):
        coeffs = step(f"{TH_PARTIES} partial_decrypt + fuse (bits={bits})",
                      lambda: th.fuse_partial_decryptions(
                          ctx, agg, [th.partial_decrypt(ctx, s, agg, gen, bits) for s in shares]))
        results[f"N-of-N bits={bits}"] = (slot_errors(sch, coeffs, agg, mean), TH_PARTIES, bits)
    outgoing = step(f"{TH_PARTIES} shamir_share_secret (t={TH_T})", lambda: [
        th.shamir_share_secret(ctx, s, TH_PARTIES, TH_T, gen) for s in shares])
    sigmas = step(f"{TH_PARTIES} aggregate_received_shares", lambda: {
        j: th.aggregate_received_shares(ctx, torch.stack([o[j - 1] for o in outgoing]))
        for j in range(1, TH_PARTIES + 1)})
    del outgoing
    for pset in (tuple(range(1, TH_T + 1)), tuple(range(TH_PARTIES - TH_T + 1, TH_PARTIES + 1)),
                 tuple(range(1, TH_T))):
        coeffs = step(f"t-of-N {pset[0]}..{pset[-1]}", lambda: th.fuse_partial_decryptions(
            ctx, agg, [th.partial_decrypt_t(ctx, sigmas[j], agg, pset, j, gen) for j in pset]))
        results[f"set {pset[0]}..{pset[-1]}"] = (slot_errors(sch, coeffs, agg, mean), len(pset),
                                                 th.DEFAULT_SMUDGING_BITS)
    launches = read_counts()
    print(f"[threshold] kernel launches { {k: v for k, v in launches.items() if v} }; ms per "
          f"step (synchronized): " + ", ".join(f"{k} {v:.1f}" for k, v in times.items())
          + f"; the encryptions split: " + ", ".join(f"{k} {v * 1e3:.1f}"
                                                      for k, v in split.items())
          + f" ({card})")
    if launches["mxu_ntt"] == 0 or launches["base_extend"] or launches["ks_inner_product"]:
        raise AssertionError("threshold: kernel 1 must launch, kernels 2 and 3 must not")
    failures = []
    for name, ((rms, mx), parties, bits) in results.items():
        sig = smudge_sigma(parties, n, bits, agg.scale)
        strict = name.endswith(f"1..{TH_T - 1}")
        if strict:
            ok, gate = mx > 1.0, "must fail: max > 1.0"
        elif bits == 0:
            ok, gate = mx < ERR_GATE, f"max < {ERR_GATE}"
        else:
            ok = 0.9 * sig <= rms <= 1.1 * sig and mx < 6 * sig
            gate = (f"RMS in 0.9-1.1 sigma, max < 6 sigma; sigma = "
                    f"sqrt({parties}*N/6)*2^{bits}/scale")
        print(f"[threshold {name}] {len(mean)} ciphertexts x {sch.encoder.slots} slots: error RMS "
              f"{rms:.4e}, max {mx:.4e}"
              + ("" if strict or bits == 0 else f", sigma {sig:.4f} (RMS/sigma {rms / sig:.3f}, "
                 f"max/sigma {mx / sig:.2f})")
              + f"; gate: {gate}: {'held' if ok else 'FAILED'} ({card})")
        if not ok:
            failures.append(name)
    if failures:
        raise AssertionError(f"threshold: gates failed for {failures}")
    return cases.take_launches(launches), split


# ---------------------------------------------------------------------------
# Path 9: kernel 7, the tensor-core / integer-chain overlap probe
# ---------------------------------------------------------------------------

def probe_work(kind, x8, m):
    """(bytes, int8 operations) of one probe launch over all K cells."""
    K, W, c = x8.shape
    out = 4 * K * m * c
    if kind == "vpu":
        return K * m * c + out, 0
    return K * W * c + m * W + out, 2 * K * m * W * c


def probe_library(x8, a, m, card):
    """The mxu order's library yardstick: one ``torch._int_mm(A[:m], B)``
    over all K cells, with B = the (W, K·c) operand Xp stored row-major and
    stored K-major (Xp transposed), each made before the timed window and
    timed on a line of its own; then K per-cell calls. → (device ms of the
    faster one-call layout, its output as (K, m, c) uint32 values)."""
    import torch

    K, W, c = x8.shape
    am = a[:m].contiguous()
    permute = lambda: x8.permute(1, 0, 2).reshape(W, K * c).contiguous()
    xp = permute()
    transpose = lambda: xp.t().contiguous()
    xk = transpose().t()                    # (W, K·c), strides (1, W): K-major
    outs = {}
    for tag, b in (("row-major", xp), ("K-major", xk)):
        one = lambda b=b: torch._int_mm(am, b)
        outs[tag] = (device_ms(one, 20), cuda_ms(one, 20), one())
    cells = [x8[k] for k in range(K)]
    per_cell = device_ms(lambda: [torch._int_mm(am, xc) for xc in cells], 3)
    if not torch.equal(outs["row-major"][2], outs["K-major"][2]):
        raise AssertionError("torch._int_mm differs between B row-major and B K-major")
    for tag, (dev, wall, _) in outs.items():
        print(f"[probe] library: one torch._int_mm(A[:m], B) over all {K} cells, B {tag}: "
              f"device {show_us(dev)}, wall {wall * 1e3:.1f} us ({card})")
    print(f"[probe] library operands (outside those windows): the permute that makes Xp "
          f"{show_us(device_ms(permute, 20))}, its transpose to K-major "
          f"{show_us(device_ms(transpose, 20))}; {K} calls, one per cell: device "
          f"{show_us(per_cell)} per set ({card})")
    timed = [(dev, tag) for tag, (dev, _, _) in outs.items() if dev is not None]
    best = min(timed) if timed else (None, "none")
    print(f"[probe] library_ms: the faster layout, {best[1]}: {show_us(best[0])}")
    want = outs["row-major"][2].reshape(m, K, c).permute(1, 0, 2).to(torch.int64) & 0xFFFFFFFF
    return best[0], want


def probe_phase(card, device):
    """Kernel 7 at the TPU probe's shapes: bit-equal to its plain version
    for the four kinds with carry 0, a chained carry and -91, in every call
    that is timed or profiled too; torch._int_mm (one call over all cells)
    as the mxu kind's library call; then µs/cell scan-marginally (the main
    path), which the JSON rows carry as ``ms``."""
    import torch

    from ppqsflhe_tpu_torch.probes import mxu_vpu_overlap as pr

    x8, a = pr.inputs(device, seed=0)
    K, W, c = x8.shape
    m = pr.M
    lib_ms, want_mxu = probe_library(x8, a, m, card)
    cases = KernelCases(card)
    crafted = torch.tensor([[[0x1A5]]], dtype=torch.int32, device=device)   # carry -91
    for kind in pr.KINDS:
        want = pr.probe_plain(kind, x8, a, None, m)
        got = pr.probe(kind, x8, a, None, m)
        # every output of the timed and profiled calls is kept (its own
        # buffer) and compared; none of them can reuse a freed buffer that
        # holds this answer, since every such buffer is kept or poisoned
        kept, kept_plain = [], []
        cases.check(f"overlap_probe ({kind}, K={K}, m={m}, nd={pr.ND}, c={pr.C})",
                    "overlap_probe", SRC_PROBE, K7, got, want,
                    lambda: kept.append(pr.probe(kind, x8, a, None, m)),
                    lambda: kept_plain.append(pr.probe_plain(kind, x8, a, None, m)), 20,
                    probe_work(kind, x8, m), library_ms=lib_ms if kind == "mxu" else None)
        bad = sum(not torch.equal(o, want) for o in kept)
        if bad:
            raise AssertionError(f"overlap_probe {kind}: {bad} of the {len(kept)} timed and "
                                 "profiled calls differ from plain")
        print(f"[probe] {kind}: all {len(kept)} timed and profiled calls bit-equal to plain")
        for prev in (got, crafted):       # a chained carry and a non-zero one
            if not torch.equal(pr.probe(kind, x8, a, prev, m),
                               pr.probe_plain(kind, x8, a, prev, m)):
                raise AssertionError(f"overlap_probe {kind}: differs from plain with carry "
                                     f"{pr.carry_byte(prev)}")
        if kind == "mxu" and not torch.equal(got.to(torch.int64) & 0xFFFFFFFF, want_mxu):
            raise AssertionError("overlap_probe mxu differs from torch._int_mm")
        for o in kept + kept_plain + [got, want]:
            o.fill_(pr.POISON)
        del kept, kept_plain, got, want
    print(f"[probe] kernel 7 bit-equal to its plain version for {list(pr.KINDS)} with carry 0 "
          f"and {pr.carry_byte(crafted)}; mxu = one torch._int_mm over all cells")
    torch.cuda.synchronize()

    reset_counts()
    us = pr.measure(x8, a, m)
    launches = read_counts()
    if launches["overlap_probe"] == 0:
        raise AssertionError("the probe never launched kernel 7")
    print(f"[probe] the main path's {launches['overlap_probe']} launches (each replay of a "
          f"chain counted) all bit-equal to plain")
    ctas = len(pr.cta_grid(K, m))
    print(f"[probe] design: wgmma, {ctas // K} CTAs a cell ({ctas} CTAs), "
          f"{pr.WARPGROUPS['consumer']} consumer + {pr.WARPGROUPS['producer']} producer "
          f"warpgroups a CTA")
    print(f"[probe] us/cell (scan-marginal over R={pr.R_LO} and R={pr.R_HI} chained launches, "
          f"each chain one CUDA graph, K={K} cells): "
          + ", ".join(f"{k} {v:.4f}" for k, v in us.items()) + "; us per launch: "
          + ", ".join(f"{k} {v * K:.2f}" for k, v in us.items()) + f" ({card})")
    for row, kind in zip(cases.rows, pr.KINDS):
        row.update(ms=us[kind] * K * 1e-3, timing="scan", profiler_ms=row["ms"])
        print(f"[probe] {kind}: row ms = the scan, {us[kind] * K:.2f} us per launch; the "
              f"profiler's per call {show_us(row['profiler_ms'])}")
    bound_ms, _ = bound(probe_work("mxu", x8, m))
    ops = probe_work("mxu", x8, m)[1]
    mxu_s = us["mxu"] * K * 1e-6
    ratio = "not measured" if lib_ms is None else f"{lib_ms * 1e-3 / mxu_s:.2f}x"
    print(f"[probe] mxu: {bound_ms * 1e-3 / mxu_s:.1%} of its {bound_ms * 1e3:.2f} us bound; "
          f"int8 rate {ops / mxu_s / 1e12:.1f} T/s = {ops / mxu_s / INT8_OPS:.1%} of "
          f"{INT8_OPS / 1e12:,.0f} T/s; one torch._int_mm {show_us(lib_ms)} ({ratio} the "
          f"kernel's time)")
    lo, hi = max(us["mxu"], us["vpu"]), us["mxu"] + us["vpu"]
    print(f"[probe] inter {us['inter']:.4f} vs max(mxu, vpu) {lo:.4f} and mxu+vpu {hi:.4f}: "
          f"{(hi - us['inter']) / max(hi - lo, 1e-9):.0%} of the possible overlap (the TPU "
          f"script's reading); serial {us['serial']:.4f}")
    # serial runs both chains exposed, inter only chain(dot1): chain(dot0)
    # is (serial - mxu) / 2 and inter hides serial - inter of it
    hideable = (us["serial"] - us["mxu"]) / 2
    print(f"[probe] inter hides {(us['serial'] - us['inter']) / max(hideable, 1e-9):.0%} of "
          f"chain(dot0) ({hideable:.4f} us/cell) behind dot1's products ({card})")
    return cases.take_launches(launches)


# ---------------------------------------------------------------------------
# Path 10: the orchestrated FL loop (training, artifact server, rounds)
# ---------------------------------------------------------------------------

ORCH_HOURS = 31 * 24     # the synthetic CSVs: hourly, 2024-07-01 to 2024-07-31
ORCH_EPOCHS = 3          # depth cut: the example configs say 100 (patience 4)
ORCH_BATCH = 32


def write_series(path, seed):
    """One client's training CSV in the reference layout (Timestamp as
    DD-MM-YYYY HH:MM, Data): hourly over July 2024, a daily sine plus
    normal(0, 2) noise from ``numpy.random.default_rng(seed)``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ts = np.datetime64("2024-07-01T00:00") + np.arange(ORCH_HOURS).astype("timedelta64[h]")
    vals = (100 + 20 * np.sin(2 * np.pi * (np.arange(ORCH_HOURS) % 24) / 24)
            + rng.normal(0, 2, ORCH_HOURS))
    with open(path, "w") as f:
        f.write("Timestamp,Data\n")
        for t, v in zip(ts.astype(object), vals):
            f.write(f"{t.strftime('%d-%m-%Y %H:%M')},{float(v)!r}\n")


def oconfig(name, tmp, tag, rounds, cc_extra=None):
    """An example oConfig as written, cut to ``rounds`` and ORCH_EPOCHS,
    with fail-fast on, its work dir under ``tmp`` and synthetic CSVs in
    place of the reference's (not in the repository)."""
    with open(os.path.join(REPO, "configs", name)) as f:
        doc = json.load(f)
    doc.update(ROUNDS=rounds, WORK_DIR=os.path.join(tmp, tag), FAIL_FAST=True)
    doc["CC_CONFIG"] = dict(doc["CC_CONFIG"], **(cc_extra or {}))
    clients = []
    for i, c in enumerate(doc["CLIENT_CONFIGS"], start=1):
        path = os.path.join(tmp, f"{tag}_client{i}.csv")
        write_series(path, SEED + 10 * ord(tag[0]) + i)
        clients.append(dict(c, data_file=path, epochs=ORCH_EPOCHS))
    doc["CLIENT_CONFIGS"] = clients
    return doc


def layers(path):
    import numpy as np

    with open(path) as f:
        return [np.asarray(e["values"]) for e in json.load(f)["weights_summary"]]


def decrypted_params(cfg, i, device):
    """Client ``i``'s decrypted weights as the GRU's parameter list."""
    from ppqsflhe_tpu_torch.train import gru

    with open(os.path.join(cfg.work_dir, f"client_{i}", "decrypted_weights.json")) as f:
        return gru.summary_to_params(json.load(f)["weights_summary"], device)


def aggregate_checks(tag, cfg, results, exported, sigma=None):
    """No client dropped in any round (a kernel failure must not turn into a
    dropout); every client's decrypt equals the mean of the exported
    weights — within ERR_GATE, or for threshold within the flood's σ (RMS
    0.9–1.1 σ, max < 6 σ, phase 8's gate) — and the clients agree."""
    import numpy as np

    dropped = [r["dropped"] for r in results]
    if any(dropped):
        raise AssertionError(f"orchestrated {tag}: clients dropped {dropped}")
    want = np.concatenate([np.mean(v, axis=0) for v in zip(*[layers(p) for p in exported])])
    decs = [np.concatenate(layers(os.path.join(cfg.work_dir, f"client_{i}",
                                               "decrypted_weights.json")))
            for i in range(1, cfg.n_clients + 1)]
    diff = np.stack(decs) - want          # every client's decrypt
    mx, rms = float(np.abs(diff).max()), float(np.sqrt(np.mean(diff ** 2)))
    agree = max(float(np.abs(d - decs[0]).max()) for d in decs)
    if sigma is None:
        ok, gate = mx < ERR_GATE, f"max < {ERR_GATE}"
    else:
        ok = 0.9 * sigma < rms < 1.1 * sigma and mx < 6 * sigma
        gate = f"RMS in 0.9-1.1 sigma, max < 6 sigma; sigma = sqrt(P*N/6)*2^30/scale = {sigma:.4f}"
    print(f"[orchestrated {tag}] rounds {[r['round'] for r in results]}, dropped {dropped}; "
          f"{want.size} values: each decrypt vs mean of the exports max {mx:.3e}, RMS {rms:.3e} "
          f"({gate}); clients agree within {agree:.3e}")
    if not (ok and np.isfinite(mx) and agree < ERR_GATE):
        raise AssertionError(f"orchestrated {tag}: aggregate gate failed (max {mx}, RMS {rms}, "
                             f"agreement {agree})")


def validation(ccfg, device):
    """A client's validation windows, as its trainer makes them, on ``device``."""
    import numpy as np
    import torch

    from ppqsflhe_tpu_torch.train import data as D
    from ppqsflhe_tpu_torch.train import trainer as T

    train_df, _, fs, ts = T._frames(ccfg)
    X, y = D.prepare_sequences(train_df, int(ccfg.get("lookback", 72)), fs, ts)
    X_tr, y_tr, X_val, y_val = D.train_val_split(X, y)
    dev = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)
    return dev(X_tr), dev(y_tr), dev(X_val), dev(y_val)


def training_checks(tag, cfg, results, device, warm=None):
    """Round 1 from a fresh init lowers every client's validation MSE; with
    ``warm`` (client → round 1's decrypted weights), round 2 started from
    exactly those weights (its validation MSE before the first step is
    theirs); the forward on the card matches the CPU's at the final
    decrypt (atol 1e-4)."""
    from ppqsflhe_tpu_torch.train import gru
    from ppqsflhe_tpu_torch.train import trainer as T

    for r in results:
        for i, t in sorted(r["training"].items()):
            print(f"[orchestrated {tag} round {r['round']}] client_{i}: {t['epochs']} epochs, "
                  f"val MSE {t['val_mse_init']:.5f} -> {t['val_mse']:.5f} (best epoch "
                  f"{t['best_epoch']}), warm start {'yes' if t['warm_start'] else 'no'}")
    first = next(r for r in results if r["round"] == 1)
    if len(first["training"]) != cfg.n_clients or any(
            t["warm_start"] or not t["val_mse"] < t["val_mse_init"]
            for t in first["training"].values()):
        raise AssertionError(f"orchestrated {tag}: round 1 did not lower every client's "
                             f"validation MSE from a fresh init")
    for i, params in (warm or {}).items():
        t = next(r for r in results if r["round"] == 2)["training"][i]
        *_, Xv, yv = validation(cfg.client_configs[i - 1], device)
        want = T.eval_mse(gru.Model(params).to(device), Xv, yv)
        print(f"[orchestrated {tag} round 2] client_{i} started from round 1's decrypt: val MSE "
              f"there {want:.6f}, the trainer's before its first step {t['val_mse_init']:.6f}")
        if t["warm_start"] is None or abs(want - t["val_mse_init"]) > 1e-6 * abs(want):
            raise AssertionError(f"orchestrated {tag}: client_{i} did not warm-start from "
                                 f"round 1's decrypt")
    *_, Xv, _ = validation(cfg.client_configs[0], device)
    params = decrypted_params(cfg, 1, "cpu")
    got = T.predict(gru, [p.to(device) for p in params], Xv.cpu().numpy(), device)
    want = T.predict(gru, params, Xv.cpu().numpy(), "cpu")
    err = float(abs(got - want).max())
    print(f"[orchestrated {tag}] GRU forward on the card vs the CPU at client_1's final decrypt, "
          f"{tuple(Xv.shape)} windows: max |diff| {err:.3e} (gate 1e-4)")
    if not err < 1e-4:
        raise AssertionError(f"orchestrated {tag}: card forward differs from the CPU's by {err}")


def print_rounds(tag, log, card):
    from ppqsflhe_tpu_torch.bench.orchestrated import step_tables

    for t in step_tables(log):
        print(f"[timing orchestrated {tag} round {t['round']}] {t['total_s']} s (host clock, "
              f"step log): " + ", ".join(f"{s['step']} {s['ms']}" for s in t["steps"])
              + f" ms ({card})")


def orchestrated_kernel_checks(cases, cfg, device, tag):
    """Kernels 2 and 3 (PRE) or 1 (threshold, four-step) against their plain
    versions at the run's shapes: one client's ciphertext batch at each level
    the run's key switches use (lazy: l = L - 1 in, l = 1 out), or over Q
    forward and back."""
    import numpy as np
    import torch

    from ppqsflhe_tpu_torch.ckks import serialize as ser
    from ppqsflhe_tpu_torch.ckks.eval import _ks_decomp_consts
    from ppqsflhe_tpu_torch.fl import api
    from ppqsflhe_tpu_torch.ops import cuda_ext
    from ppqsflhe_tpu_torch.ops.cuda_ks import ks_inner_product, ks_inner_product_plain

    store = os.path.join(cfg.work_dir, "server_storage")
    sch = api.load_scheme(os.path.join(store, "CC.json"), device)
    ctx, n, L = sch.ctx, sch.params.n, sch.params.num_q
    mq = ctx.moduli_qp
    doc = ser.load_enc_doc(os.path.join(store, "client_1", "encrypted_weights_c1.json"))
    B = len(list(api._doc_fields(doc)))
    gen = torch.Generator().manual_seed(SEED)
    where = f"N=2^{n.bit_length() - 1}, orchestrated {tag}"
    if cfg.protocol == "threshold":
        idx = ctx.q_idx(L)
        x = rand_residues([mq[i] for i in idx], (B,), n, gen, device)
        for fwd in (True, False):
            run = (lambda: ctx.ntt(x, idx)) if fwd else (lambda: ctx.intt(x, idx))
            fused_case(cases, ctx.fntt, x, idx, fwd, False, run, 20,
                       f"{L} limbs x {B} polys, {where}")
        return
    rk = api._load_rekey_mont(sch, os.path.join(store, "client_1", "client_1-to-2-ReKey.key"))
    for l in (L - 1, 1) if cfg.lazy_levels else (L,):
        groups, consts = _ks_decomp_consts(ctx, l)
        idx_ext = ctx.q_idx(l) + ctx.p_idx()
        steps = [(g, tuple(i for i in idx_ext if i not in g), c, (B,))
                 for g, c in zip(groups, consts)] + [(ctx.p_idx(), ctx.q_idx(l), None, (2, B))]
        for src, dst, pre, lead in steps:
            ext = ctx.extender(src, dst)
            xe = rand_residues([mq[i] for i in src], lead, n, gen, device)
            cases.check(f"base_extend (l={l}, {len(src)}->{len(dst)} limbs, "
                        f"{'pre' if pre is not None else 'ModDown'}, "
                        f"{'x'.join(map(str, lead))} polys, {where})", "base_extend", SRC_EXT, K2,
                        cuda_ext.fused_extend(xe, ext, pre), ext.extend(xe, pre),
                        lambda: cuda_ext.fused_extend(xe, ext, pre), lambda: ext.extend(xe, pre),
                        20, ext_work(int(np.prod(lead)), len(src), len(dst), n))
        limbs = ctx.q_idx(l) + ctx.p_idx()
        q, qinv, _ = ctx.limb_consts(limbs, device)
        sel = ctx.consts(("limb_map", limbs), lambda: limbs, device)
        dig = rand_residues([mq[i] for i in limbs], (B, len(groups)), n, gen, device)
        args = (dig, rk.data, sel, q, qinv)
        run, plain = lambda: ks_inner_product(*args), lambda: ks_inner_product_plain(*args)
        cases.check(f"ks_inner_product (nd={len(groups)}, LK={len(limbs)}, l={l}, {B} polys, "
                    f"{where})",
                    "ks_inner_product", SRC_KS, K3, run(), plain(), run, plain, 20,
                    ks_work(B, len(groups), len(limbs), n))
    torch.cuda.synchronize()


def host_ms_once(fn):
    """Host milliseconds of one call of ``fn``, the device drained before and
    after."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def drive(tag, cfg, need, resume=False):
    """One drive of ``cfg`` through ``Orchestrator.run`` (its step log on
    stderr), the launch counts set to 0 just before and read just after;
    fails unless every kernel of ``need`` launched. Returns (results, log,
    counts)."""
    import torch

    from ppqsflhe_tpu_torch.bench.orchestrated import run

    reset_counts()
    t0 = time.perf_counter()
    results, log, _ = run(cfg, resume)
    torch.cuda.synchronize()
    counts = read_counts()
    missing = [k for k in need if counts[k] == 0]
    print(f"[orchestrated {tag}] {time.perf_counter() - t0:.1f} s; kernel launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    if missing:
        raise AssertionError(f"orchestrated {tag}: never launched {missing}")
    return results, log, counts


def orchestrated_phase(card, device):
    """Runs A (PRE with training, 2 rounds), B (the bench twin) and C
    (threshold at 4 clients with training, four-step NTT), each with
    fail-fast in a temporary directory; their gates, kernel checks, warm
    rounds, ms per training step and epoch, and the device's idle share
    over one epoch and one warm round. Returns the kernels' rows."""
    import dataclasses
    import tempfile

    import torch

    from ppqsflhe_tpu_torch.bench import orchestrated
    from ppqsflhe_tpu_torch.ckks import serialize as ser
    from ppqsflhe_tpu_torch.ckks.threshold import DEFAULT_SMUDGING_BITS
    from ppqsflhe_tpu_torch.fl import api
    from ppqsflhe_tpu_torch.orchestration import cli
    from ppqsflhe_tpu_torch.train import gru
    from ppqsflhe_tpu_torch.train import trainer as T

    dev = str(device)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the trainer's matmuls must stay float32")
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        # run A: PRE with training, round 1 then round 2 through resume
        doc = oconfig("oConfig.example.json", tmp, "A", rounds=1)
        cfg1 = cli.config(doc, dev)
        res1, log1, c1 = drive("A round 1", cfg1, ("base_extend", "ks_inner_product"))
        clients = range(1, cfg1.n_clients + 1)
        warm = {i: decrypted_params(cfg1, i, dev) for i in clients}
        cfg = dataclasses.replace(cfg1, rounds=2)
        res2, log2, c2 = drive("A round 2 (resume)", cfg, ("base_extend", "ks_inner_product"),
                               resume=True)
        results = res1 + res2
        aggregate_checks("A", cfg, results,
                         [os.path.join(cfg.work_dir, f"client_{i}", "weights.json")
                          for i in clients])
        training_checks("A", cfg, results, device, warm)
        print_rounds("A", log1, card)
        print_rounds("A", log2, card)
        cases = KernelCases(card)
        orchestrated_kernel_checks(cases, cfg, device, "A")
        rows += cases.take_launches({k: c1[k] + c2[k] for k in c1})

        # ms per training step and epoch at full width, and the epoch's idle share
        Xt, yt, _, _ = validation(cfg.client_configs[0], device)
        model = gru.Model(warm[1]).to(device)
        opt = T.make_optimizer(model)
        shuffle, drop = torch.Generator().manual_seed(SEED), torch.Generator(
            device=device).manual_seed(SEED)

        def epoch():
            n_steps = len(T.run_epoch(model, opt, Xt, yt, ORCH_BATCH, shuffle, drop))
            torch.cuda.synchronize()
            return n_steps

        steps = epoch()
        epoch_ms = host_ms_once(epoch)
        xb, yb = Xt[:ORCH_BATCH], yt[:ORCH_BATCH]
        step_ms = statistics.median(host_ms_once(
            lambda: (T.train_step(model, opt, xb, yb, drop), torch.cuda.synchronize()))
            for _ in range(5))
        print(f"[timing orchestrated train] GRU 7 -> 64 -> 64 -> 1 (39,041 params), lookback "
              f"{tuple(Xt.shape)[1]}, batch {ORCH_BATCH}: {step_ms:.2f} ms per step (median of "
              f"5), {epoch_ms:.1f} ms per epoch of {steps} steps ("
              f"{epoch_ms / steps:.2f} ms per step), synchronized host clock ({card})")
        t0 = time.perf_counter()
        busy_line("orchestrated epoch", epoch, epoch_ms, once=True)
        print(f"[orchestrated] the epoch's profile took {time.perf_counter() - t0:.1f} s")

        # run B: the bench twin (train=False, reference chain, PQWD wire)
        work = os.path.join(tmp, "B")
        os.makedirs(work)
        cfgb = dataclasses.replace(orchestrated.config(work, dev), fail_fast=True)
        resb, logb, cb = drive("B", cfgb, ("base_extend", "ks_inner_product"))
        aggregate_checks("B", cfgb, resb, [os.path.join(work, f"w{i}.json") for i in (1, 2)])
        print_rounds("B", logb, card)
        bench = orchestrated.summary(logb, 0.0)
        print(f"[timing orchestrated B] warm round {bench['value']} s "
              f"(orchestrated_round_s_warm) ({card})")
        cases = KernelCases(card)
        orchestrated_kernel_checks(cases, cfgb, device, "B")
        rows += cases.take_launches(cb)
        state = os.path.join(cfgb.work_dir, "orchestrator_state.json")

        def warm_round():
            with open(state) as f:
                done = json.load(f)["completed_rounds"]
            orchestrated.run(dataclasses.replace(cfgb, rounds=done + 1), resume=True)

        round_ms = statistics.median(host_ms_once(warm_round) for _ in range(2))
        busy_line("orchestrated B warm round", warm_round, round_ms, once=True)

        # run C: threshold at 4 clients with training, the four-step NTT
        doc = oconfig("oConfig.threshold.example.json", tmp, "C", rounds=1,
                      cc_extra={"ntt_backend": "fourstep"})
        cfgc = cli.config(doc, dev)
        resc, logc, cc = drive("C", cfgc, ("mxu_ntt",))
        agg = ser.load_enc_doc(os.path.join(cfgc.work_dir, "server_storage",
                                            "aggregated_weights.json"))
        sch = api.load_scheme(os.path.join(cfgc.work_dir, "server_storage", "CC.json"), dev)
        scale = api._load_cts([next(api._doc_fields(agg))[3]], sch)[0].scale
        aggregate_checks("C", cfgc, resc,
                         [os.path.join(cfgc.work_dir, f"client_{i}", "weights.json")
                          for i in range(1, cfgc.n_clients + 1)],
                         sigma=smudge_sigma(cfgc.n_clients, sch.params.n, DEFAULT_SMUDGING_BITS,
                                            scale))
        training_checks("C", cfgc, resc, device)
        print_rounds("C", logc, card)
        threshold_tool_graphs(cfgc, sch, card)
        cases = KernelCases(card)
        orchestrated_kernel_checks(cases, cfgc, device, "C")
        rows += cases.take_launches(cc)
    return rows


def threshold_tool_graphs(cfg, sch, card):
    """Run C's threshold tools went through the scheme's graph cache: the
    partial decryption (one call a client) and the fusion (one a client,
    all on the same inputs) each captured a graph past its warm-up and
    replayed it; the fused documents of the eager calls and of the replays
    are the same bytes, client 1's partial decryption made again (a replay)
    with the round's seed is its file's bytes, and each graph's static
    buffers are zero after its call."""
    import tempfile

    from ppqsflhe_tpu_torch.fl import api
    from ppqsflhe_tpu_torch.utils import graphs

    client = lambda i, name: os.path.join(cfg.work_dir, f"client_{i}", name)
    read = lambda path: open(path, "rb").read()
    fused = {read(client(i, "decrypted_weights.json")) for i in range(1, cfg.n_clients + 1)}
    with tempfile.TemporaryDirectory() as tmp:
        again = os.path.join(tmp, "partial_c1.json")
        api.threshold_partial_decrypt(client(1, "CC.json"), client(1, "client_1-share.key"),
                                      client(1, "aggregated_for_me.json"), again,
                                      seed=cfg.seed + 3000 + 1, smudging_bits=cfg.smudging_bits,
                                      device=cfg.device)
        same_partial = read(again) == read(client(1, "partial_c1.json"))
    ops = {k[0]: op for k, op in sch._graphs.items()
           if k[0] in ("threshold_partial_decrypt", "threshold_fuse_decrypt")}
    seen = {name: (op.graph is not None, op.replays) for name, op in ops.items()}
    zero = all(op.graph is not None and not any(t.any() for t in [
        *op.static, *graphs._tensors(op.graph.output)]) for op in ops.values())
    print(f"[orchestrated C threshold graphs] {seen} (captured, replays); {cfg.n_clients} fused "
          f"documents, eager and replayed: {len(fused)} distinct; client 1's partial "
          f"decryption again from its seed: same bytes {same_partial}; static buffers zero "
          f"{zero} ({card})")
    if (len(seen) != 2 or not all(c and r >= 2 for c, r in seen.values()) or len(fused) != 1
            or not same_partial or not zero):
        raise AssertionError(f"run C's threshold tools: graphs {seen}, {len(fused)} distinct "
                             f"fusions, partial same {same_partial}, static zero {zero}")


# ---------------------------------------------------------------------------
# Path 11: the bench twins, and the FLEXIBLEAUTOEXT chain and OpenFHE wire
# ---------------------------------------------------------------------------

TWIN_REPS = 2        # repetitions of each timed chain (the twins' own default: 3)


def flexext_kernel_checks(cases, gen, device):
    """Kernels 1, 2 and 3 at the FLEXIBLEAUTOEXT chain's new shapes
    (``CkksParams.generate(n=2^14, mult_depth=2, dnum=2, extra_mod_bits=20)``:
    Q = 60/40/40 + 20 bits, P = 2 x 60, digits {q0, q1} and {q2, q3}):
    kernel 1 on the 20-bit limb, kernel 2 from the digit {q2, q3} and the
    ModDown onto the four Q limbs, kernel 3 at nd=2, LK=6 over 27 polys."""
    import numpy as np
    import torch

    from ppqsflhe_tpu_torch.ckks.eval import _ks_decomp_consts
    from ppqsflhe_tpu_torch.ckks.params import CkksParams
    from ppqsflhe_tpu_torch.ckks.scheme import CkksScheme
    from ppqsflhe_tpu_torch.ops import cuda_ext
    from ppqsflhe_tpu_torch.ops.cuda_ks import ks_inner_product, ks_inner_product_plain
    from ppqsflhe_tpu_torch.ops.cuda_mxu_ntt import route

    params = CkksParams.generate(n=N_ROUND, mult_depth=2, scale_bits=40, dnum=2,
                                 extra_mod_bits=20)
    sch = CkksScheme(params, device=device)
    ctx, n = sch.ctx, params.n
    mq, L = ctx.moduli_qp, params.num_q
    ext = (L - 1,)
    nd = ctx.fntt.tabs[ext[0]].nd
    routes = [route(n, t.nd) for t in ctx.fntt.tabs]
    print(f"[flexext] N={n}, Q={[q.bit_length() for q in params.q_moduli]} bits, "
          f"P={[p.bit_length() for p in params.p_moduli]} bits, digits {ctx.digit_groups}; "
          f"digit counts {[t.nd for t in ctx.fntt.tabs]}, routes {routes}")
    if routes[ext[0]] != "fused":
        raise AssertionError(f"the 20-bit limb routes to {routes[ext[0]]}, not kernel 1")
    x = rand_residues([mq[ext[0]]], (2 * N_CTS,), n, gen, device)
    for fwd in (True, False):
        run = lambda: (ctx.ntt if fwd else ctx.intt)(x, ext)
        fused_case(cases, ctx.fntt, x, ext, fwd, False, run, 20,
                   f"the 20-bit limb q3 (nd={nd}) x {2 * N_CTS} polys, N=2^14")
    idx_ext = ctx.q_idx(L) + ctx.p_idx()
    groups, consts = _ks_decomp_consts(ctx, L)
    if tuple(groups[1]) != (2, 3):
        raise AssertionError(f"digit groups {groups}: the second is not {{q2, q3}}")
    todo = ((groups[1], tuple(i for i in idx_ext if i not in groups[1]), consts[1], (N_CTS,)),
            (ctx.p_idx(), ctx.q_idx(L), None, (2, N_CTS)))
    for src, dst, pre, lead in todo:
        e = ctx.extender(src, dst)
        xe = rand_residues([mq[i] for i in src], lead, n, gen, device)
        tag = "digit {q2, q3}, pre" if pre is not None else "ModDown"
        cases.check(f"base_extend (FLEXIBLEAUTOEXT, {len(src)}->{len(dst)} limbs, {tag}, "
                    f"{'x'.join(map(str, lead))} polys, N=2^14)", "base_extend", SRC_EXT, K2,
                    cuda_ext.fused_extend(xe, e, pre), e.extend(xe, pre),
                    lambda: cuda_ext.fused_extend(xe, e, pre), lambda: e.extend(xe, pre), 50,
                    ext_work(int(np.prod(lead)), len(src), len(dst), n))
    limbs = tuple(range(len(mq)))
    q, qinv, _ = ctx.limb_consts(limbs, device)
    sel = ctx.consts(("limb_map", limbs), lambda: limbs, device)
    ndg = len(ctx.digit_groups)
    dig = rand_residues(mq, (N_CTS, ndg), n, gen, device)
    key = rand_residues(mq, (ndg, 2), n, gen, device)
    args = (dig, key, sel, q, qinv)
    cases.check(f"ks_inner_product (FLEXIBLEAUTOEXT, nd={ndg}, LK={len(limbs)}, {N_CTS} polys, "
                f"N=2^14)", "ks_inner_product", SRC_KS, K3, ks_inner_product(*args),
                ks_inner_product_plain(*args), lambda: ks_inner_product(*args),
                lambda: ks_inner_product_plain(*args), 50,
                ks_work(N_CTS, ndg, len(limbs), n))
    torch.cuda.synchronize()


def openfhe_wire_round(device, card):
    """One changeCipherDomain and one aggregation on the OpenFHE cereal wire
    (``wire="openfhe"``) through the port's tools on the card, from two
    clients' GRU weights encrypted on that wire (client 2 with its secret
    key, shipped dense); every field parsed back as cereal-BINARY, the
    aggregate decrypted against the plaintext mean (< 1e-3)."""
    import base64
    import tempfile

    import numpy as np

    from ppqsflhe_tpu_torch.ckks import openfhe_emit
    from ppqsflhe_tpu_torch.ckks import serialize as ser
    from ppqsflhe_tpu_torch.fl import api

    dev = str(device)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        P = lambda name: os.path.join(tmp, name)
        rng = np.random.default_rng(SEED)
        want1, want2 = write_weights(P("w1.json"), rng), write_weights(P("w2.json"), rng)
        with open(os.path.join(REPO, "configs", "config_cc.json")) as f:
            api.gen_cc(json.load(f), P("cc.json"))
        cc = P("cc.json")
        for i in (1, 2):
            api.key_gen(cc, P(f"pk{i}"), P(f"sk{i}"), seed=SEED + 10 + i, device=dev)
        api.rekey_gen(cc, P("sk1"), P("pk2"), P("rk12"), seed=SEED + 13, device=dev)
        api.encrypt_weights(cc, P("pk1"), P("w1.json"), P("e1.json"), seed=SEED + 14,
                            wire="openfhe", device=dev)
        api.encrypt_weights(cc, P("sk2"), P("w2.json"), P("e2.json"), seed=SEED + 15,
                            wire="openfhe", device=dev)
        t1 = time.perf_counter()
        api.change_cipher_domain(cc, P("rk12"), P("e1.json"), P("e12.json"), wire="openfhe",
                                 device=dev)
        api.aggregate_encrypted_weights(cc, [P("e12.json"), P("e2.json")], P("agg.json"),
                                        wire="openfhe", device=dev)
        t2 = time.perf_counter()
        doc = ser.load_enc_doc(P("agg.json"))
        n_fields = 0
        for entry in doc["weights_summary"]:
            for field in [entry["mean"], entry["std_dev"]] + entry["values"]:
                rec = openfhe_emit.parse_ciphertext_binary(base64.b64decode(field))
                if rec["towers"].shape[0] != 2:
                    raise AssertionError("an aggregate field is not a 2-component ciphertext")
                n_fields += 1
        dec = api.decrypt_weights(cc, P("sk2"), P("agg.json"), P("dec.json"), device=dev)
        mx, rms = decrypt_err(dec, {k: (want1[k] + want2[k]) / 2 for k in want1})
        size = os.path.getsize(P("agg.json"))
    print(f"[openfhe wire] changeCipherDomain + aggregate of 2 x {n_fields} cereal-BINARY "
          f"ciphertexts in {(t2 - t1) * 1e3:.1f} ms (set-up {t1 - t0:.1f} s); the aggregate "
          f"({size:,} B) parsed back field by field; decrypt max err {mx:.3e}, RMS {rms:.3e} "
          f"(gate {ERR_GATE}) ({card})")
    if not (np.isfinite(mx) and mx < ERR_GATE):
        raise AssertionError(f"OpenFHE-wire aggregate: decrypt error {mx} over the gate")


def twins_phase(card, device):
    """The four bench twins on the card — the server round in all five
    schedules, the rotations, the NTT and key-switch benches (the second
    key switch on the FLEXIBLEAUTOEXT chain), the artifact sizes — and one
    OpenFHE-wire PRE round, after the kernel checks at the new shapes.
    Prints each twin's JSON line and the phase's seconds; returns the
    kernels' rows."""
    import torch

    from ppqsflhe_tpu_torch.bench import kernels, rotations, server_round, sizes

    t0 = time.perf_counter()
    cases = KernelCases(card)
    flexext_kernel_checks(cases, torch.Generator().manual_seed(SEED), device)
    t_checks = time.perf_counter() - t0
    lines = []

    def out(line):
        print(f"[twin json] {line}")
        lines.append(json.loads(line))

    reset_counts()
    secs = {}
    for name, run in (
            ("server_round", lambda: [server_round.bench(device, lazy=lazy, reps=TWIN_REPS,
                                                         out=out) for lazy in (4, 0, 1, 2, 3)]),
            ("rotations", lambda: rotations.bench(device, reps=TWIN_REPS, out=out)),
            ("kernels", lambda: kernels.bench(device, reps=TWIN_REPS, out=out)),
            ("sizes", lambda: sizes.bench(device, out=out)),
            ("openfhe wire", lambda: openfhe_wire_round(device, card))):
        t1 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t1
    launches = read_counts()
    print(f"[twins] kernel launches: { {k: v for k, v in launches.items() if v} }")
    missing = [k for k in ("mxu_ntt", "mxu_ntt_mont", "streamed_stage_a", "streamed_stage_b",
                           "base_extend", "ks_inner_product", "fourstep_ntt") if not launches[k]]
    if missing:
        raise AssertionError(f"the bench twins never launched {missing}")
    for r in lines:
        if r["metric"] == server_round.METRIC:
            print(f"[timing twins] server round lazy={r['lazy']}: {r['value']:.3f} ms/round "
                  f"marginal (vs_baseline {r['vs_baseline']:.1f}), device "
                  f"{show_us(r['device_ms'])} a round, host enqueue {r['enqueue_ms']:.3f} ms, "
                  f"decrypt err {r['err']:.2e} at {r['out_limbs']} limb(s) ({card})")
    print(f"[twins] phase 11: {time.perf_counter() - t0:.1f} s (kernel checks {t_checks:.1f} "
          f"s; " + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()) + f") ({card})")
    return cases.take_launches(launches)


# ---------------------------------------------------------------------------
# Path 12: the sharded server round on a one-rank NCCL group, and runtime/
# ---------------------------------------------------------------------------

SHARD_COUNTS = (2, 4, 8)        # the coef axis sizes whose per-shard shapes are checked


def shard_stage_checks(cases, runner, x, tag, shards=SHARD_COUNTS, timed=True):
    """Kernels 4 and 5 at every per-shard shape of a D-rank coef axis, on one
    card: x (B, L, N) over all L limbs of ``runner`` (a CudaMxuNtt). Per
    direction and D: kernel 4 on every shard k's
    column block at col0 = k·c, bit-equal to the same columns of
    ``stage_a_plain`` over the whole matrix (the plain stage transforms each
    column on its own, so one call holds every shard), the blocks exchanged
    as ``all_to_all_tiled`` exchanges them (``mesh.exchange_tiled``, one
    process), kernel 5 over each rank's m1/D rows, bit-equal to the same
    rows of ``stage_b_plain`` over the whole matrix, and the stitched result
    bit-equal to the replicated transform. One JSON row per stage of the
    forward transform, timed on the last shard (col0 ≠ 0 where D > 1); the
    inverse's shards are held bit-equal the same way, untimed (and the
    forward's too unless ``timed``). A D that does not divide n1 and n2 is
    skipped; a shard narrower than 16 columns or rows runs the kernels'
    narrow tiles."""
    import torch

    from ppqsflhe_tpu_torch.ops import streamed_ntt as sn
    from ppqsflhe_tpu_torch.parallel.mesh import exchange_tiled

    B, L, n = x.shape
    n1, n2 = runner.n1, runner.n2
    sel, chain = list(range(L)), runner.tables.streamed
    limbs = [chain.limb(i) for i in sel]
    for fwd in (True, False):
        m1, m2 = (n1, n2) if fwd else (n2, n1)
        xm = x.reshape(B, L, m1, m2)
        want = (runner.ntt if fwd else runner.intt)(x)
        plain_all_a = sn.stage_a_plain(xm, limbs, fwd)                  # (B, L, m1, m2)
        plain_all_b = sn.stage_b_plain(plain_all_a, limbs, fwd)         # (B, L, m2, m1)
        tabs, info_a, info_b = chain.device(x.device, sel, fwd)
        way = "forward" if fwd else "inverse"
        for D in shards:
            if m1 % D or m2 % D:
                continue
            c, rows = m2 // D, m1 // D
            blocks = [xm[..., k * c:(k + 1) * c].contiguous() for k in range(D)]
            run_a = lambda k: sn.stage_a(blocks[k], torch.empty_like(blocks[k]), tabs, info_a,
                                         fwd, m2, k * c)
            plain_a = lambda k: sn.stage_a_plain(blocks[k], limbs, fwd, k * c)
            ys = [run_a(k).clone() for k in range(D)]
            for k in range(D):
                if not torch.equal(ys[k], plain_all_a[..., k * c:(k + 1) * c]):
                    raise AssertionError(f"kernel 4 shard {k} of {D} ({way}, {tag}) differs "
                                         f"from stage_a_plain")
            k = D - 1
            if fwd and timed:
                cases.check(f"streamed_stage_a (sharded {way}, D={D}: shard {k} at col0="
                            f"{k * c}, c={c}, m={m1}, {L} limbs x {B} polys, {tag}; all {D} "
                            f"shards and the inverse's bit-equal)", "streamed_stage_a",
                            SRC_STREAMED, K4, ys[k], plain_a(k), lambda: run_a(k),
                            lambda: plain_a(k), 10, stage_work(L, B, m1, c, 16))
            ts = [t.contiguous() for t in exchange_tiled(ys, 2, 3)]     # (B, L, m1/D, m2)
            run_b = lambda d: sn.stage_b(ts[d], torch.empty((B, L, m2, rows), dtype=torch.int64,
                                                            device=x.device), tabs, info_b, fwd)
            plain_b = lambda d: sn.stage_b_plain(ts[d], limbs, fwd)
            zs = [run_b(d) for d in range(D)]
            for d in range(D):
                if not torch.equal(zs[d], plain_all_b[..., d * rows:(d + 1) * rows]):
                    raise AssertionError(f"kernel 5 rank {d} of {D} ({way}, {tag}) differs "
                                         f"from stage_b_plain")
            if fwd and timed:
                cases.check(f"streamed_stage_b (sharded {way}, D={D}: rank {D - 1}, {rows} rows "
                            f"x m={m2}, {L} limbs x {B} polys, {tag}; all {D} ranks and the "
                            f"inverse's bit-equal)", "streamed_stage_b", SRC_STREAMED, K5,
                            zs[-1], plain_b(D - 1), lambda: run_b(D - 1),
                            lambda: plain_b(D - 1), 10, stage_work(L, B, m2, rows))
            if not torch.equal(torch.cat(zs, -1).reshape(B, L, n), want):
                raise AssertionError(f"D={D} shards stitched ({way}, {tag}) differ from the "
                                     f"replicated transform")
        print(f"[shards {tag}] {way}: kernels 4 and 5 on every shard of D in "
              f"{[D for D in shards if not (m1 % D or m2 % D)]}, stitched = "
              f"the replicated transform bit for bit")


def shard_local_checks(cases, sch, rk_mont, gen, device):
    """Kernels 2 and 3 at a shard's local width N/D (D = 2 and 8) on the
    round's shapes: the l=3 digit {q0, q1}'s extension (constant folded, 27
    polys) and the nd=2, LK=5 inner product over 27 polys."""
    from ppqsflhe_tpu_torch.ckks.eval import _ks_decomp_consts
    from ppqsflhe_tpu_torch.ops import cuda_ext
    from ppqsflhe_tpu_torch.ops.cuda_ks import ks_inner_product, ks_inner_product_plain

    ctx = sch.ctx
    mq, L, K = ctx.moduli_qp, sch.params.num_q, sch.params.num_p
    groups, consts = _ks_decomp_consts(ctx, L)
    src, pre = groups[0], consts[0]
    dst = tuple(i for i in ctx.q_idx(L) + ctx.p_idx() if i not in src)
    ext = ctx.extender(src, dst)
    limbs = tuple(range(L + K))
    q, qinv, _ = ctx.limb_consts(limbs, device)
    lmap = ctx.consts(("limb_map", limbs), lambda: limbs, device)
    nd = len(ctx.digit_groups)
    for D in (SHARD_COUNTS[0], SHARD_COUNTS[-1]):
        w = sch.params.n // D
        xe = rand_residues([mq[i] for i in src], (N_CTS,), w, gen, device)
        cases.check(f"base_extend (l={L}, {len(src)}->{len(dst)} limbs, pre, {N_CTS} polys, "
                    f"a shard's width N/D = {w}, D={D})", "base_extend", SRC_EXT, K2,
                    cuda_ext.fused_extend(xe, ext, pre), ext.extend(xe, pre),
                    lambda: cuda_ext.fused_extend(xe, ext, pre), lambda: ext.extend(xe, pre), 20,
                    ext_work(N_CTS, len(src), len(dst), w))
        dig = rand_residues(mq, (N_CTS, nd), w, gen, device)
        key = rk_mont.data[..., :w].contiguous()
        args = (dig, key, lmap, q, qinv)
        cases.check(f"ks_inner_product (nd={nd}, LK={len(limbs)}, {N_CTS} polys, a shard's width "
                    f"N/D = {w}, D={D})", "ks_inner_product", SRC_KS, K3,
                    ks_inner_product(*args), ks_inner_product_plain(*args),
                    lambda: ks_inner_product(*args), lambda: ks_inner_product_plain(*args), 20,
                    ks_work(N_CTS, nd, len(limbs), w))


def runtime_check(card):
    """runtime/: build with make, start the artifact server, fetch /getCC and
    one /download/ path."""
    import subprocess
    import tempfile
    import urllib.request

    from ppqsflhe_tpu_torch.runtime import NativeSerde, build_native, native_server_binary

    t0 = time.perf_counter()
    if not build_native():
        raise AssertionError("runtime: make of the artifact server and serde failed")
    t_build = time.perf_counter() - t0
    if not NativeSerde().is_native or NativeSerde().decode(NativeSerde().encode(b"ppq")) != b"ppq":
        raise AssertionError("runtime: libserde did not load or round-trip")
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(os.path.join(tmp, "client_1"))
        with open(os.path.join(tmp, "CC.json"), "w") as f:
            f.write('{"cc": 1}')
        with open(os.path.join(tmp, "client_1", "w.json"), "w") as f:
            f.write("WEIGHTS" * 1000)
        proc = subprocess.Popen([native_server_binary(), tmp, "0"], stdout=subprocess.PIPE,
                                text=True)
        try:
            line = proc.stdout.readline().strip()
            if not line.startswith("LISTENING "):
                raise AssertionError(f"runtime: the server printed {line!r}")
            base = f"http://127.0.0.1:{int(line.split()[1])}"
            with urllib.request.urlopen(base + "/getCC", timeout=5) as r:
                cc = r.read()
            with urllib.request.urlopen(base + "/download/client_1/w.json", timeout=5) as r:
                body = r.read()
        finally:
            proc.terminate()
            proc.wait(timeout=5)
    if cc != b'{"cc": 1}' or body != b"WEIGHTS" * 1000:
        raise AssertionError("runtime: the artifact server answered wrongly")
    print(f"[runtime] make built the artifact server and libserde in {t_build:.1f} s; the server "
          f"answered /getCC and /download/ ({len(body)} B) ({card})")


MESH_GRAPH_REPLAYS = 3      # replays of each mesh graph, each on fresh inputs


def mesh_graph_checks(card, device, w, sctx, cmesh, s_parties, a, rot_keys, conj_key):
    """The mesh compositions through their graph caches on the one-rank
    NCCL group: the sharded context's re-encryption, rotation and
    conjugation (``("galois", g, l)``), hoisted rotations by 1 and 2 and
    FedAvg round (``sctx.cached_graph``), and ``aggregate_sharded``, the
    joint key and ``partial_decrypt_psum`` (``graphs.group_cache``). Each
    runs WARMUP + MESH_GRAPH_REPLAYS calls on fresh uniform residues (the
    floods from fresh seeds), each ``torch.equal`` to its eager body on the
    same inputs (the same draws); then every key must have captured its
    graph and replayed it MESH_GRAPH_REPLAYS times or more, the FedAvg
    graph must hold 11 all-to-alls and one all-reduce, and one replay must
    add its collectives to the replays' tally. Prints each graph's launches
    and collectives a replay, then releases the graphs and prints the MiB
    they reserved; a replay after that must raise. Returns the caches'
    keys."""
    import torch

    from ppqsflhe_tpu_torch.ckks import multikey
    from ppqsflhe_tpu_torch.ckks import threshold as th
    from ppqsflhe_tpu_torch.ckks.scheme import WARMUP
    from ppqsflhe_tpu_torch.ckks.types import Ciphertext, KeySwitchKey
    from ppqsflhe_tpu_torch.parallel import mesh as pm
    from ppqsflhe_tpu_torch.parallel import sharded_scheme as ss
    from ppqsflhe_tpu_torch.utils import graphs

    sch, ctx = w.sch, w.sch.ctx
    L, n, nloc, scale = sch.params.num_q, sch.params.n, sctx.local_n, w.ct1.scale
    mq = ctx.moduli_qp
    gen = torch.Generator().manual_seed(SEED + 14)
    key = lambda k: KeySwitchKey(sctx.local(k.data), k.mont)
    rk12, rk21, kc = key(w.rk12), key(w.rk21), key(conj_key)
    rks = {r: key(k) for r, k in rot_keys.items()}
    cts = lambda width, lead=(N_CTS,): Ciphertext(rand_residues(mq[:L], lead + (2,), width, gen,
                                                                device), scale)
    datas = lambda *outs: [o.data if isinstance(o, Ciphertext) else o for o in outs]
    cases = (
        ("reenc", lambda: (cts(nloc),), lambda c: [ss.re_encrypt_sharded(sctx, c, rk12).data]),
        ("galois rotate 1", lambda: (cts(nloc),),
         lambda c: [ss.rotate_sharded(sctx, c, 1, rks[1]).data]),
        ("galois conjugate", lambda: (cts(nloc),),
         lambda c: [ss.conjugate_sharded(sctx, c, kc).data]),
        ("hoisted (1, 2)", lambda: (cts(nloc),),
         lambda c: datas(*ss.rotate_hoisted_sharded(sctx, c, [1, 2], rks))),
        ("fedavg", lambda: (cts(nloc, (2, N_CTS)).data,),
         lambda st: list(ss.fedavg_round_sharded(sctx, st, rk12, rk21, scale))),
        ("aggregate_sharded", lambda: (cts(n, (4, N_CTS)).data,),
         lambda st: [multikey.aggregate_sharded(ctx, st, cmesh, scale, 4).data]),
        ("joint_public_key_sharded",
         lambda: (rand_residues(mq, (TH_PARTIES,), n, gen, device),),
         lambda b: [th.joint_public_key_sharded(ctx, a, b, cmesh).data]),
        ("partial_decrypt_psum",
         lambda: (cts(n), int(torch.randint(1 << 30, (), generator=gen))),
         lambda c, seed: [th.partial_decrypt_psum(
             ctx, c, s_parties, [torch.Generator(device=device).manual_seed(seed + i)
                                 for i in range(TH_PARTIES)], cmesh)]),
    )
    t0 = time.perf_counter()
    for name, make, fn in cases:
        for _ in range(WARMUP + MESH_GRAPH_REPLAYS):
            inputs = make()
            got = fn(*inputs)
            with graphs.eager():
                want = fn(*inputs)
            if not all(torch.equal(g, e) for g, e in zip(got, want)):
                raise AssertionError(f"mesh graph {name}: a call differs from its eager body")
    torch.cuda.synchronize()
    t_calls = time.perf_counter() - t0
    ops = {k: op for k, op in sctx._graphs.items()}
    ops.update(graphs.group_cache(pm.axis_group(cmesh, "client")).items())
    names = sorted({k[0][0] for k in ops})
    lacking = [k[0] for k, op in ops.items()
               if op.graph is None or op.replays < MESH_GRAPH_REPLAYS]
    want_names = ["aggregate_sharded", "fedavg", "galois", "hoisted", "joint_public_key_sharded",
                  "partial_decrypt_psum", "reenc"]
    if names != want_names or lacking or len([k for k in ops if k[0][0] == "galois"]) != 2:
        raise AssertionError(f"mesh graphs: keys {names}, not captured or replayed "
                             f"{MESH_GRAPH_REPLAYS} times: {lacking}")
    for k, op in ops.items():
        launches = {c: v for c, v in op.graph.launches.items() if v}
        colls = {c: v for c, v in op.graph.collectives.items() if v["ops"]}
        shown = tuple(x for x in k[0] if isinstance(x, (str, int, float, tuple)))
        print(f"[mesh graphs] {shown}: captured, {op.replays} replays each torch.equal to the "
              f"eager body; a replay: kernel launches {launches}, collectives {colls} ({card})")
    (fedavg,) = [op.graph for k, op in ops.items() if k[0][0] == "fedavg"]
    colls = fedavg.collectives
    graphs.reset_replayed()
    fedavg.replay()
    torch.cuda.synchronize()
    if (colls["all_to_all"]["ops"] != 11 or colls["all_reduce"]["ops"] != 1
            or graphs.replayed_collectives != colls):
        raise AssertionError(f"the fedavg graph holds {colls}, one replay tallied "
                             f"{graphs.replayed_collectives}: 11 all-to-alls and one all-reduce "
                             f"expected")
    ran = {c: sum(op.replays * op.graph.launches[c] for op in ops.values())
           + fedavg.launches[c] for c in fedavg.launches}
    print(f"[mesh graphs] kernel launches the {sum(op.replays for op in ops.values()) + 1} "
          f"replays ran: { {c: v for c, v in ran.items() if v} } ({card})")
    held = reserved_bytes(device)
    pm.release_graphs()
    freed = held - reserved_bytes(device)
    try:
        fedavg.replay()
    except RuntimeError as e:
        refused = str(e)[str(e).find("its graph"):]
    else:
        raise AssertionError("a mesh graph replayed after its release")
    print(f"[mesh graphs] {len(ops)} graphs on the one-rank NCCL group, {len(cases)} "
          f"compositions x {WARMUP + MESH_GRAPH_REPLAYS} calls in {t_calls:.1f} s (each beside "
          f"its eager body); fedavg_round_sharded a replay: {colls['all_to_all']['ops']} "
          f"all-to-alls, {colls['all_reduce']['ops']} all-reduce, tallied; released before the "
          f"group: {freed / 2**20:.1f} MiB reserved freed; a replay after: {refused!r} ({card})")
    return names


def sharded_phase(card, device, w, outs):
    """The sharded server round on a one-rank NCCL group (client 1 × coef 1)
    at full width, after the per-shard kernel checks: ``fedavg_round_sharded``
    and ``fl.api.server_round`` over the sharded context (lazy-4 and full)
    bit-equal to phase 1's replicated round on its world ``w``, ``outs``, and
    decrypting within 1e-3; a sharded rotation and conjugation; the threshold
    key and fused decryption of 16 local parties; the mesh compositions'
    CUDA graphs (:func:`mesh_graph_checks`: the five sharded compositions,
    ``rotate_hoisted_sharded`` included, ``aggregate_sharded``, the joint key
    and ``partial_decrypt_psum``, each captured and replayed on fresh inputs
    ``torch.equal`` to its eager body, their launches and collectives a
    replay, the MiB they reserved, released before the group); then the
    twin of ``bench_sharded.py`` in both schedules (the eager and the
    compiled sharded round) beside phase 1's replicated round compiled, and
    ``runtime/``. Returns the kernels' rows."""
    import numpy as np
    import torch

    from ppqsflhe_tpu_torch.bench import server_round as round_twin
    from ppqsflhe_tpu_torch.bench import sharded as sharded_twin
    from ppqsflhe_tpu_torch.ckks import threshold as th
    from ppqsflhe_tpu_torch.ckks.types import Ciphertext, KeySwitchKey
    from ppqsflhe_tpu_torch.core import primes
    from ppqsflhe_tpu_torch.fl.api import server_round
    from ppqsflhe_tpu_torch.ops.cuda_mxu_ntt import CudaMxuNtt
    from ppqsflhe_tpu_torch.parallel import mesh as pm
    from ppqsflhe_tpu_torch.parallel import sharded_scheme as ss

    t0 = time.perf_counter()
    cases = KernelCases(card)
    gen = torch.Generator().manual_seed(SEED + 12)
    sch, ctx = w.sch, w.sch.ctx
    x = rand_residues(ctx.moduli_qp, (N_CTS,), N_ROUND, gen, device)
    shard_stage_checks(cases, ctx.fntt, x, "N=2^14, the round's QP chain")
    for n, b, shards in ((N_BIG, 8, SHARD_COUNTS), (1 << 12, 8, (2, 4)), (1 << 10, 8, (2,))):
        moduli = [primes.first_prime_down(59, 2 * n)] + [primes.first_prime_down(40 + i, 2 * n)
                                                         for i in range(3)]
        runner = CudaMxuNtt(n, moduli, [primes.root_of_unity(2 * n, q) for q in moduli])
        shard_stage_checks(cases, runner, rand_residues(moduli, (b,), n, gen, device),
                           f"N=2^{n.bit_length() - 1}, bench_kernels' chain", shards)
    shard_local_checks(cases, sch, w.rk12, gen, device)
    torch.cuda.synchronize()
    t_checks = time.perf_counter() - t0

    with pm.single_process_group(device):
        mesh = pm.make_mesh({"client": 1, "coef": 1}, device.type)
        sctx = ss.ShardedEvalContext(sch.params, mesh)
        view = ss.scheme_view(sch, sctx)
        key = lambda k: KeySwitchKey(sctx.local(k.data), k.mont)
        loc = lambda ct: Ciphertext(sctx.local(ct.data), ct.scale)
        rot_keys = sch.rotation_key_gen(w.sk2, [1, 2], w.gen)
        rot_key = rot_keys[1]
        conj_key = sch.conjugation_key_gen(w.sk2, w.gen)
        torch.cuda.synchronize()

        reset_counts()
        pm.reset_collectives()
        agg, back = ss.fedavg_round_sharded(sctx, sctx.local(torch.stack([w.ct1.data,
                                                                          w.ct2.data])),
                                            key(w.rk12), key(w.rk21), w.ct1.scale)
        torch.cuda.synchronize()
        colls = pm.read_collectives()
        per_sched = {lazy: server_round(view, loc(w.ct1), loc(w.ct2), key(w.rk12),
                                        key(w.rk21), lazy) for lazy in (4, 0)}
        rot = ss.rotate_sharded(sctx, loc(w.ct2), 1, key(rot_key))
        conj = ss.conjugate_sharded(sctx, loc(w.ct2), key(conj_key))
        torch.cuda.synchronize()
        launches = read_counts()
        print(f"[sharded] main path (fedavg_round_sharded, server_round lazy 4 and 0 over the "
              f"sharded context, a rotation and a conjugation) kernel launches: "
              f"{ {k: v for k, v in launches.items() if v} }; collectives of one "
              f"fedavg_round_sharded: {colls} ({card})")
        missing = [k for k in ("streamed_stage_a", "streamed_stage_b", "base_extend",
                               "ks_inner_product") if not launches[k]]
        if missing or launches["mxu_ntt"] or launches["mxu_ntt_mont"]:
            raise AssertionError(f"the sharded path never launched {missing}, or launched "
                                 f"kernel 1/1b: {launches}")
        if colls["all_to_all"]["ops"] != 11 or colls["all_reduce"]["ops"] != 1:
            raise AssertionError(f"fedavg_round_sharded issued {colls}: 11 all-to-alls and one "
                                 f"all-reduce expected")
        checks = [("fedavg_round_sharded average", agg, outs[0][0].data),
                  ("fedavg_round_sharded re-encrypted", back, outs[0][1].data),
                  ("rotate_sharded r=1", rot.data, sch.rotate(w.ct2, 1, rot_key).data),
                  ("conjugate_sharded", conj.data, sch.conjugate(w.ct2, conj_key).data)]
        for lazy, (a, b) in per_sched.items():
            checks += [(f"server_round lazy={lazy} average", a.data, outs[lazy][0].data),
                       (f"server_round lazy={lazy} re-encrypted", b.data, outs[lazy][1].data)]
        for name, got, want in checks:
            if not torch.equal(got, sctx.local(want)):
                raise AssertionError(f"sharded {name} differs from the replicated one")
        e2 = max_err(sch, w.sk2, Ciphertext(sctx.gather(agg), w.ct1.scale), w.want)
        e1 = max_err(sch, w.sk1, Ciphertext(sctx.gather(back), w.ct1.scale), w.want)
        print(f"[sharded] bit-equal to the replicated path: " + ", ".join(c[0] for c in checks)
              + f"; fedavg_round_sharded decrypt max err {e2:.3e} / {e1:.3e} (gate {ERR_GATE}) "
              f"({card})")
        if not max(e1, e2) < ERR_GATE:
            raise AssertionError(f"fedavg_round_sharded decrypt error {max(e1, e2)}")

        # threshold: 16 local parties on one rank of the client axis
        cmesh = pm.make_mesh({"client": 1}, device.type)
        tgen = torch.Generator(device=device).manual_seed(SEED + 13)
        a = th.common_random_poly(ctx, CRS_SEED, device)
        parts = [th.partial_keygen(ctx, a, tgen) for _ in range(TH_PARTIES)]
        b_local = torch.stack([b for _, b in parts])
        pk = th.joint_public_key_sharded(ctx, a, b_local, cmesh)
        if not torch.equal(pk.data, th.joint_public_key(ctx, a, [b for _, b in parts]).data):
            raise AssertionError("joint_public_key_sharded differs from joint_public_key")
        payload = list(w.want)
        ct = sch.encrypt_values(pk, payload, tgen)
        fgens = lambda: [torch.Generator(device=device).manual_seed(SEED + 200 + i)
                         for i in range(TH_PARTIES)]
        t1 = time.perf_counter()
        coeffs = th.partial_decrypt_psum(ctx, ct, torch.stack([s.s_eval for s, _ in parts]),
                                         fgens(), cmesh)
        torch.cuda.synchronize()
        t_psum = (time.perf_counter() - t1) * 1e3
        single = th.fuse_partial_decryptions(ctx, ct, [th.partial_decrypt(ctx, s, ct, g)
                                                       for (s, _), g in zip(parts, fgens())])
        if not torch.equal(coeffs, single):
            raise AssertionError("partial_decrypt_psum differs from the single-device fusion")
        rms, mx = slot_errors(sch, coeffs, ct, payload)
        sig = smudge_sigma(TH_PARTIES, N_ROUND, th.DEFAULT_SMUDGING_BITS, ct.scale)
        print(f"[sharded threshold] {TH_PARTIES} local parties: joint_public_key_sharded = "
              f"joint_public_key; partial_decrypt_psum = the single-device fusion bit for bit, "
              f"{t_psum:.1f} ms for {N_CTS} ciphertexts; error RMS {rms:.4e}, max {mx:.4e}, "
              f"sigma {sig:.4f} (RMS/sigma {rms / sig:.3f}, max/sigma {mx / sig:.2f}; gate "
              f"0.9-1.1, < 6) ({card})")
        if not (0.9 * sig <= rms <= 1.1 * sig and mx < 6 * sig):
            raise AssertionError(f"partial_decrypt_psum error RMS {rms / sig:.3f} sigma")

        mesh_graph_checks(card, device, w, sctx, cmesh,
                          torch.stack([s.s_eval for s, _ in parts]), a, rot_keys, conj_key)

        lines = []
        t2 = time.perf_counter()
        for lazy in (4, 0):
            sharded_twin.bench(device, lazy, reps=TWIN_REPS,
                               out=lambda s: (print(f"[twin json] {s}"),
                                              lines.append(json.loads(s))))
        t_twin = time.perf_counter() - t2
    replicated = {lazy: round_twin.measure_compiled(sch, w, lazy, card, TWIN_REPS)
                  for lazy in (4, 0)}
    share = lambda x: "not measured" if x is None else f"{x:.1%}"
    for r in lines:
        rc = replicated[r["lazy"]]
        print(f"[timing sharded] lazy={r['lazy']}: sharded round eager {r['value']:.3f} ms/round "
              f"marginal on a 1-rank NCCL coef mesh (device {show_us(r['device_ms'])}, enqueue "
              f"{r['enqueue_ms']:.3f} ms, idle {share(r['idle_share'])}), compiled "
              f"{r['compiled_ms']:.3f} ms (device {show_us(r['compiled_device_ms'])}, enqueue "
              f"{r['compiled_enqueue_ms']:.3f} ms, idle {share(r['compiled_idle_share'])}, "
              f"capture {r['compiled_capture_s']:.1f} s, equal {r['compiled_equal']}); "
              f"replicated: per-op cached {r['replicated_ms']:.3f} ms, compiled "
              f"{rc['compiled_ms']:.3f} ms (device {show_us(rc['compiled_device_ms'])}, idle "
              f"{share(rc['compiled_idle_share'])}); {r['collectives']} ({card})")
    runtime_check(card)
    print(f"[sharded] phase 12: {time.perf_counter() - t0:.1f} s (kernel checks {t_checks:.1f} "
          f"s, bench twin {t_twin:.1f} s) ({card})")
    return cases.take_launches(launches)


# ---------------------------------------------------------------------------
# Path 13: small rings and narrow shards
# ---------------------------------------------------------------------------

SMALL_RINGS = (1 << 6, 1 << 7, 1 << 8, 1 << 9)     # n1, n2 = 8 or 16: the m = 8, 16 instances
SMALL_ROUNDS = (1 << 8, 1 << 9)                    # bench.py's round on the smallest rings
SMALL_TIMED = (1 << 7,)     # the ring whose kernel rows are timed: n1 = 8, n2 = 16, so each
#                             transform runs the m = 8 and the m = 16 instances, and 8-wide tiles
# (N, timed coef axis sizes, untimed ones) whose shards are narrower than a 16-wide tile:
# c = n2/D = 8, 4, 2, 1; every shard of every D is held bit-equal, and the timed rows are
# cut to the narrowest tile, c = 1 at m = 64 (the phase's time limit; the 8-wide tile is
# timed at N = 2^7)
NARROW_SHARDS = ((1 << 12, (64,), (8, 16, 32)), (1 << 14, (), (16, 32)), (1 << 16, (), (32,)))


def kernels_chain(n):
    """bench_kernels.py's chain at ring size n: first_prime_down(59, 2n)
    and three primes of 40, 41, 42 bits, with their 2n-th roots."""
    from ppqsflhe_tpu_torch.core import primes

    moduli = [primes.first_prime_down(59, 2 * n)] + [primes.first_prime_down(40 + i, 2 * n)
                                                     for i in range(3)]
    return moduli, [primes.root_of_unity(2 * n, q) for q in moduli]


def small_ring_checks(cases, n, gen, device, timed):
    """Kernels 1, 1b, 4, 5 and 6 at ring size n ≤ 2^9 (m = 8 and 16), 4
    limbs × N_CTS polys: every launch of 1, 1b (both stages) and 6 (both
    passes), forward and inverse, bit-equal to its plain version, and 4 and
    5 as a coef axis of one rank; with ``timed``, the whole forward
    transforms of 1, 1b and 6 timed against theirs (1 and 1b also against
    the digit transform) and the forward stages of 4 and 5."""
    import torch

    from ppqsflhe_tpu_torch.ops import cuda_mxu_ntt as cm
    from ppqsflhe_tpu_torch.ops import cuda_ntt

    moduli, psis = kernels_chain(n)
    runner, bf = cm.CudaMxuNtt(n, moduli, psis), cuda_ntt.CudaFourStepNtt(n, moduli, psis)
    B, L, sel = N_CTS, len(moduli), list(range(len(moduli)))
    st = runner.tables.streamed
    limbs = [st.limb(i) for i in sel]
    tag = f"N=2^{n.bit_length() - 1}, n1={runner.n1}, n2={runner.n2}"
    x = rand_residues(moduli, (B,), n, gen, device)
    empty = lambda *shape: torch.empty(shape, dtype=torch.int64, device=device)
    held = []
    for fwd in (True, False):
        way = "forward" if fwd else "inverse"
        m1, m2 = (runner.n1, runner.n2) if fwd else (runner.n2, runner.n1)
        xb = x.reshape(B, L, m1, m2)
        launches = []
        for mont in (False, True):
            buf, info1, info2 = st.device(device, sel, fwd, mont)
            y = cm.ntt_stage(xb, empty(B, L, m2, m1), buf, info1, fwd, True, mont)
            z = cm.ntt_stage(y, empty(B, L, m2, m1), buf, info2, fwd, False, mont)
            k = "1b" if mont else "1"
            launches += [(f"kernel {k} stage 1 (m={m1})", y, cm.stage1_plain(xb, limbs, fwd, mont)),
                         (f"kernel {k} stage 2 (m={m2})", z, cm.stage2_plain(y, limbs, fwd))]
        tabs, info1, info2 = bf.device(device, sel, fwd)
        y = cuda_ntt.fourstep_pass(xb, empty(B, L, m2, m1), tabs, info1, fwd, True)
        z = cuda_ntt.fourstep_pass(y, empty(B, L, m2, m1), tabs, info2, fwd, False)
        launches += [(f"kernel 6 pass 1 (m={m1})", y, bf.plain_pass(xb, fwd, True, sel)),
                     (f"kernel 6 pass 2 (m={m2})", z, bf.plain_pass(y, fwd, False, sel))]
        for name, got, want in launches:
            if not torch.equal(got, want):
                raise AssertionError(f"{name} ({way}, {tag}) differs from its plain version")
        held += [f"{name} {way}" for name, _, _ in launches]
    print(f"[small rings {tag}] bit-equal launch by launch: {', '.join(held)}")
    shard_stage_checks(cases, runner, x, tag, shards=(1,), timed=timed)
    if not timed:
        return
    for mont in (False, True):
        run = lambda: runner.fused(x, True, sel, mont)
        fused_case(cases, runner, x, sel, True, mont, run, 10, f"{L} limbs x {B} polys, {tag}")
    run, plain = lambda: bf.ntt(x), lambda: bf.plain(x, True, sel)
    cases.check(f"fourstep_ntt (forward, {L} limbs x {B} polys, {tag})", "fourstep_ntt", SRC_FS,
                K6, run(), plain(), run, plain, 10, butterfly_work(L, B, bf.n1, bf.n2))


def small_round_checks(cases, sch, rk_mont, gen, device, timed):
    """Kernels 2 and 3 at the small round's shapes, bit-equal to their plain
    versions (timed with ``timed``): the full level's first digit
    decomposed and extended (its constant folded, N_CTS polys), the ModDown
    P → Q (both components), and the nd=2 inner product over LK=5."""
    import torch

    from ppqsflhe_tpu_torch.ckks.eval import _ks_decomp_consts
    from ppqsflhe_tpu_torch.ops import cuda_ext
    from ppqsflhe_tpu_torch.ops.cuda_ks import ks_inner_product, ks_inner_product_plain

    ctx, n, L = sch.ctx, sch.params.n, sch.params.num_q
    mq, tag = ctx.moduli_qp, f"N=2^{n.bit_length() - 1}"
    groups, consts = _ks_decomp_consts(ctx, L)
    src = groups[0]
    cases_2 = ((src, tuple(i for i in ctx.q_idx(L) + ctx.p_idx() if i not in src), consts[0],
                (N_CTS,)), (ctx.p_idx(), ctx.q_idx(L), None, (2, N_CTS)))
    limbs = tuple(range(L + sch.params.num_p))
    q, qinv, _ = ctx.limb_consts(limbs, device)
    lmap = ctx.consts(("limb_map", limbs), lambda: limbs, device)
    nd = len(ctx.digit_groups)
    args = (rand_residues(mq, (N_CTS, nd), n, gen, device), rk_mont.data, lmap, q, qinv)
    runs = []
    for src, dst, pre, lead in cases_2:
        ext = ctx.extender(src, dst)
        xe = rand_residues([mq[i] for i in src], lead, n, gen, device)
        runs.append((f"base_extend (l={L}, {len(src)}->{len(dst)} limbs, "
                     f"{'pre' if pre is not None else 'ModDown'}, {'x'.join(map(str, lead))} "
                     f"polys, {tag})", "base_extend", SRC_EXT, K2,
                     lambda ext=ext, xe=xe, pre=pre: cuda_ext.fused_extend(xe, ext, pre),
                     lambda ext=ext, xe=xe, pre=pre: ext.extend(xe, pre),
                     ext_work(xe.numel() // (len(src) * n), len(src), len(dst), n)))
    runs.append((f"ks_inner_product (nd={nd}, LK={len(limbs)}, {N_CTS} polys, {tag})",
                 "ks_inner_product", SRC_KS, K3, lambda: ks_inner_product(*args),
                 lambda: ks_inner_product_plain(*args), ks_work(N_CTS, nd, len(limbs), n)))
    for name, counter, src_file, replaces, run, plain, work in runs:
        if timed:
            cases.check(name, counter, src_file, replaces, run(), plain(), run, plain, 20, work)
        elif not torch.equal(run(), plain()):
            raise AssertionError(f"{name}: kernel differs from plain version")
    print(f"[small rings {tag}] kernels 2 and 3 bit-equal at the round's shapes: "
          f"{', '.join(r[0] for r in runs)}")


def small_rings_phase(card, device):
    """Small rings and narrow shards: kernels 1, 1b, 4, 5 and 6 at m = 8
    and 16 (N = 2^6 … 2^9) and kernels 4 and 5 on shards narrower than a
    16-wide tile, held to their plain versions; then the main path:
    bench.py's server round at N = 2^8 and 2^9 in both schedules through
    the default route (kernels 1, 2 and 3), decrypting within 1e-3 and
    bit-equal to the same round run on the CPU, and ``bench.scaling``'s
    three paths at D = 1 on the JAX bench's shapes (the aggregation at
    N = 256) on a one-rank NCCL group; the N = 2^8 round also in the
    butterfly configuration (kernel 6, bit-equal to the default round).
    Kernel 1b is on no small-ring path: the JAX runner routes every limb at
    N ≤ 2^9 to the fused Shoup kernel. Returns the kernels' rows."""
    import dataclasses

    import torch

    from ppqsflhe_tpu_torch.bench import scaling
    from ppqsflhe_tpu_torch.ckks.scheme import CkksScheme
    from ppqsflhe_tpu_torch.ckks.types import Ciphertext, KeySwitchKey
    from ppqsflhe_tpu_torch.fl.api import server_round
    from ppqsflhe_tpu_torch.ops.cuda_mxu_ntt import CudaMxuNtt
    from ppqsflhe_tpu_torch.ops.cuda_ntt import BUTTERFLY
    from ppqsflhe_tpu_torch.parallel import mesh as pm

    t0 = time.perf_counter()
    cases = KernelCases(card)
    gen = torch.Generator().manual_seed(SEED + 14)
    for n in SMALL_RINGS:
        small_ring_checks(cases, n, gen, device, timed=n in SMALL_TIMED)
    for n, timed_shards, untimed_shards in NARROW_SHARDS:
        moduli, psis = kernels_chain(n)
        runner, x = CudaMxuNtt(n, moduli, psis), rand_residues(moduli, (8,), n, gen, device)
        for shards, timed in ((timed_shards, True), (untimed_shards, False)):
            if shards:
                shard_stage_checks(cases, runner, x,
                                   f"N=2^{n.bit_length() - 1}, bench_kernels' chain", shards,
                                   timed=timed)

    worlds = {n: round_world(n, device) for n in SMALL_ROUNDS}
    for n, w in worlds.items():
        small_round_checks(cases, w.sch, w.rk12, gen, device, timed=n == SMALL_ROUNDS[-1])
    torch.cuda.synchronize()
    t_checks = time.perf_counter() - t0
    need = ("mxu_ntt", "base_extend", "ks_inner_product")
    launches = dict.fromkeys(COUNTERS, 0)
    outs = {}
    for n, w in worlds.items():
        outs[n], counts = drive_round(f"small round N=2^{n.bit_length() - 1}", w.sch, w,
                                      {4: need, 0: need})
        launches = {k: v + counts[k] for k, v in launches.items()}
    # the butterfly configuration (ntt_impl="pallas": kernel 6 runs every NTT)
    # of the smallest round, on its keys and ciphertexts
    n, w = SMALL_ROUNDS[0], worlds[SMALL_ROUNDS[0]]
    bf_sch = CkksScheme(dataclasses.replace(w.sch.params, ntt_impl=BUTTERFLY), device=device)
    need_bf = ("fourstep_ntt", "base_extend", "ks_inner_product")
    bf_outs, counts = drive_round(f"small butterfly round N=2^{n.bit_length() - 1}", bf_sch, w,
                                  {4: need_bf, 0: need_bf},
                                  absent=("mxu_ntt", "mxu_ntt_mont", "streamed_stage_a",
                                          "streamed_stage_b"))
    launches = {k: v + counts[k] for k, v in launches.items()}
    for lazy in (4, 0):
        if not all(torch.equal(a.data, b.data) for a, b in zip(bf_outs[lazy], outs[n][lazy])):
            raise AssertionError(f"the N={n} butterfly round lazy={lazy} differs from the "
                                 f"default round")
    with pm.single_process_group(device):
        reset_counts()
        row = scaling.run_one(device, reps=2)
        torch.cuda.synchronize()
        counts = read_counts()
    launches = {k: v + counts[k] for k, v in launches.items()}
    diff = scaling.model_diff({1: row})[1]
    print(f"[small rings scaling] bench.scaling at D=1: NTT N=2^14 {row['ntt_ms']:.3f} ms, "
          f"aggregation N={scaling.N_AGG} {row['agg_ms']:.3f} ms, round N=2^12 "
          f"{row['round_ms']:.3f} ms; collectives {row['collective_bytes']}, model_diff "
          f"{diff or 'none'}; kernel launches {({k: v for k, v in counts.items() if v})} "
          f"({card})")
    if diff:
        raise AssertionError(f"bench.scaling D=1 collectives differ from the model: {diff}")
    missing = [k for k in ("streamed_stage_a", "streamed_stage_b", "mxu_ntt") if not counts[k]]
    if missing:
        raise AssertionError(f"bench.scaling at D=1 never launched {missing}")

    for n, w in worlds.items():
        cpu = CkksScheme(w.sch.params, device="cpu")
        ct = lambda c: Ciphertext(c.data.cpu(), c.scale)
        key = lambda k: KeySwitchKey(k.data.cpu(), k.mont)
        for lazy in (4, 0):
            got = server_round(cpu, ct(w.ct1), ct(w.ct2), key(w.rk12), key(w.rk21), lazy)
            if not all(torch.equal(a.data, b.data.cpu()) for a, b in zip(got, outs[n][lazy])):
                raise AssertionError(f"the N={n} round lazy={lazy} on the card differs from the "
                                     f"same round run on the CPU")
            run = lambda: server_round(w.sch, w.ct1, w.ct2, w.rk12, w.rk21, lazy)
            with eager_ops():
                times = median_ms(run, 3)
            print(f"[timing small round N=2^{n.bit_length() - 1} lazy={lazy}] bit-equal to the "
                  f"CPU run; {statistics.median(times):.3f} ms/round (median of {len(times)}; "
                  f"2x{N_CTS} ciphertexts) ({card})")
    print(f"[small rings] phase 13: {time.perf_counter() - t0:.1f} s (kernel checks and the "
          f"rounds' set-up {t_checks:.1f} s) ({card})")
    return cases.take_launches(launches)


# ---------------------------------------------------------------------------
# Path 14: the compiled server round (one CUDA graph) against the eager round
# ---------------------------------------------------------------------------

COMPILED_CHAIN = 20     # chained replays per case, each held to the eager round


def compiled_case(tag, sch, w, lazy, need, card):
    """One schedule of a round world ``w`` as a :class:`CompiledRound`:
    COMPILED_CHAIN replays, the first on the clients' stacks and each later
    one after rewriting one residue of client 1's stack from the previous
    replay's checksum, every replay's outputs poisoned before it and then
    held with ``torch.equal`` to the eager round on the same inputs; the
    first replay decrypts within the gate, and a replay on the restored
    stacks gives it again. Then the eager and compiled wall (median of
    ROUNDS per-call CUDA-event times), host enqueue, device ms and idle.
    Returns the compiled round's launches per replay."""
    import numpy as np
    import torch

    from ppqsflhe_tpu_torch.ckks.types import Ciphertext
    from ppqsflhe_tpu_torch.fl.api import server_round
    from ppqsflhe_tpu_torch.fl.compiled import CompiledRound

    t0 = time.perf_counter()
    cr = CompiledRound(sch, w.rk12, w.rk21, lazy, w.ct1.data.shape[:-3], w.ct1.scale)
    t_capture = time.perf_counter() - t0
    missing = [k for k in need if not cr.launches[k]]
    if missing:
        raise AssertionError(f"compiled {tag} lazy={lazy}: the graph holds no launch of {missing}")
    x1 = w.ct1.data.clone()
    flat = x1.view(-1)
    base = flat[0].clone()
    first = carry = None
    for i in range(COMPILED_CHAIN):
        if i:
            flat[0] = (base >> 1) + (carry & 1)
        for t in (cr.avg.data, cr.back.data):
            t.fill_(-1)
        with eager_ops():
            eager = server_round(sch, Ciphertext(x1, w.ct1.scale), w.ct2, w.rk12, w.rk21, lazy)
        got = cr(Ciphertext(x1, w.ct1.scale), w.ct2)
        if not all(torch.equal(a.data, b.data) and a.scale == b.scale
                   for a, b in zip(got, eager)):
            raise AssertionError(f"compiled {tag} lazy={lazy}: replay {i + 1} of "
                                 f"{COMPILED_CHAIN} differs from the eager round")
        carry = sum(c.data.sum() for c in got)
        if first is None:
            first = [Ciphertext(c.data.clone(), c.scale) for c in got]
    flat[0] = base
    again = cr(Ciphertext(x1, w.ct1.scale), w.ct2)
    if not all(torch.equal(a.data, b.data) for a, b in zip(again, first)):
        raise AssertionError(f"compiled {tag} lazy={lazy}: a replay on the restored stacks "
                             f"differs from the first replay")
    e2, e1 = max_err(sch, w.sk2, first[0], w.want), max_err(sch, w.sk1, first[1], w.want)
    if not (np.isfinite(e1) and np.isfinite(e2) and max(e1, e2) < ERR_GATE):
        raise AssertionError(f"compiled {tag} lazy={lazy}: decrypt error {max(e1, e2)} over "
                             f"the gate")
    print(f"[compiled {tag} lazy={lazy}] capture {t_capture:.2f} s; {COMPILED_CHAIN} chained "
          f"replays torch.equal to the eager round; decrypt max err: average under sk2 "
          f"{e2:.3e}, re-encrypted under sk1 {e1:.3e} (gate {ERR_GATE}); "
          f"{sum(cr.launches.values())} kernel launches a replay: "
          f"{ {k: v for k, v in cr.launches.items() if v} }")
    runs = (("eager", lambda: server_round(sch, w.ct1, w.ct2, w.rk12, w.rk21, lazy)),
            ("compiled", cr.replay))
    for name, run in runs:
        with eager_ops():
            wall = statistics.median(median_ms(run, 3))
            dev = sum(us for _, us in device_events_once(run)) / 1e3
            enqueue = host_ms(run)
        dev_s, idle = (("not measured (no device activity in the profile)", "not measured")
                       if not dev else (f"{dev:.3f} ms", f"{max(0.0, 1 - dev / wall):.1%}"))
        print(f"[timing compiled {tag} lazy={lazy}] {name}: wall {wall:.3f} ms/round (median of "
              f"{ROUNDS}), host enqueue {enqueue:.3f} ms, device {dev_s}, idle {idle} "
              f"({card})")
    return cr.launches


def compiled_phase(card, device, rounds):
    """The compiled server round: for each (tag, scheme, world, schedules,
    kernels) of ``rounds``, :func:`compiled_case` per schedule. The launch
    counts are reset first; the kernels of each round must have launched
    in its replays (``fl.compiled.replayed``: a replay runs the captured
    launches; a capture launches nothing, so the wrappers do not count
    them)."""
    from ppqsflhe_tpu_torch.fl import compiled

    t0 = time.perf_counter()
    reset_counts()
    compiled.reset_replayed()
    for tag, sch, w, schedules, need in rounds:
        before = dict(compiled.replayed)
        for lazy in schedules:
            compiled_case(tag, sch, w, lazy, need, card)
        ran = {k: v - before[k] for k, v in compiled.replayed.items()}
        missing = [k for k in need if not ran[k]]
        if missing:
            raise AssertionError(f"compiled {tag}: replays never launched {missing}")
    wrappers = compiled.wrapper_counts()
    print(f"[compiled] kernel launches: replayed "
          f"{ {k: v for k, v in compiled.replayed.items() if v} }; by the wrappers (warm-up, "
          f"eager references) { {k: v for k, v in wrappers.items() if v} }")
    print(f"[compiled] phase 14: {time.perf_counter() - t0:.1f} s ({card})")


# ---------------------------------------------------------------------------
# Path 15: the compiled training step and validation MSE (CUDA graphs)
# ---------------------------------------------------------------------------

TRAIN_FAMILIES = ("gru", "lstm", "mlp", "transformer")
TRAIN_EPOCHS = 2        # epochs of each trajectory held eager against compiled
TRAIN_TIMED = 3         # timed epochs a path (median)
STEP_TIMED = 10         # timed steps a path (median)


def fresh_client(ccfg, seed, device):
    """What ``train_client(ccfg, seed)`` starts from on ``device`` with no
    warm start: the family's model from the seeded initializer, its
    optimizer, the data and the shuffle and dropout generators."""
    import torch

    from ppqsflhe_tpu_torch.train import mlp
    from ppqsflhe_tpu_torch.train import trainer as T

    mdl = T.MODEL_FAMILIES[ccfg.get("model", "gru")]
    data = validation(ccfg, device)
    kw = {"lookback": int(ccfg.get("lookback", 72))} if mdl is mlp else {}
    params = mdl.init_params(torch.Generator().manual_seed(seed), data[0].shape[-1], **kw)
    model = mdl.Model(params).to(device)
    opt = T.make_optimizer(model, float(ccfg.get("learning_rate", 1e-3)))
    return (model, opt, data, torch.Generator().manual_seed(seed + 1),
            torch.Generator(device=device).manual_seed(seed + 2))


def eager_fit(ccfg, seed, device, epochs):
    """``train_client``'s loop run eagerly (:func:`run_epoch` with
    ``train_step``, ``eval_mse``) for ``epochs`` epochs, no early stop:
    the model and optimizer after it, the batch MSEs by epoch, the
    validation MSE before and after each epoch, the best epoch and its
    weights, and the training windows' shape."""
    from types import SimpleNamespace

    import torch

    from ppqsflhe_tpu_torch.train import trainer as T

    model, opt, (Xt, yt, Xv, yv), shuffle, drop = fresh_client(ccfg, seed, device)
    batch = int(ccfg.get("batch_size", ORCH_BATCH))
    r = SimpleNamespace(model=model, opt=opt, mses=[], val0=T.eval_mse(model, Xv, yv), vals=[],
                        best_epoch=-1, best_params=None, windows=tuple(Xt.shape))
    best = float("inf")
    for epoch in range(epochs):
        r.mses.append([float(v) for v in torch.stack(
            T.run_epoch(model, opt, Xt, yt, batch, shuffle, drop)).cpu()])
        r.vals.append(T.eval_mse(model, Xv, yv))
        if r.vals[-1] < best - 1e-12:
            best, r.best_epoch = r.vals[-1], epoch
            r.best_params = [p.detach().clone() for p in model.parameters()]
    return r


def trajectory_check(family, ccfg, seed, device):
    """``train_client`` on the card (the compiled step and eval) against
    :func:`eager_fit` from the same weights and seeds: every batch MSE,
    validation MSE, the best epoch and its weights, and after the last
    epoch the weights, Adam moments and count, ``torch.equal``; the graphs
    replayed at every step after the warm-up and at every evaluation.
    Returns the steps of an epoch."""
    import torch

    from ppqsflhe_tpu_torch.train import compiled
    from ppqsflhe_tpu_torch.train import trainer as T

    compiled.reset_replays()
    res = T.train_client(ccfg, seed=seed, verbose=False, device=str(device))
    replays = dict(compiled.replays)
    e = eager_fit(ccfg, seed, device, TRAIN_EPOCHS)
    steps = sum(map(len, e.mses))
    want = {"step": steps - compiled.WARMUP, "eval": TRAIN_EPOCHS + 1}
    if replays != want:
        raise AssertionError(f"compiled train {family}: replays {replays}, want {want} (the "
                             f"step and eval must run as graphs after the warm-up)")
    diff = [(k, i, a, b) for k, (ra, rb) in enumerate(zip(res.batch_mse, e.mses))
            for i, (a, b) in enumerate(zip(ra, rb)) if a != b]
    if diff or [len(r) for r in res.batch_mse] != [len(r) for r in e.mses]:
        raise AssertionError(f"compiled train {family}: batch MSEs differ from the eager "
                             f"trajectory at (epoch, step, compiled, eager) {diff[:4]}")
    copt = res.optimizer
    cparams = copt.param_groups[0]["params"]
    unequal = [i for i, (a, b) in enumerate(zip(cparams, e.model.parameters()))
               if not torch.equal(a, b)]
    state = lambda o: [t for p in o.param_groups[0]["params"] for t in o.state[p].values()]
    unequal_state = [i for i, (a, b) in enumerate(zip(state(copt), state(e.opt)))
                     if not torch.equal(a, b)]
    if (unequal or unequal_state or res.val_mse_init != e.val0
            or res.history["val_loss"] != e.vals or res.best_epoch != e.best_epoch
            or not torch.equal(copt.param_groups[0]["count"], e.opt.param_groups[0]["count"])
            or not all(torch.equal(a, b) for a, b in zip(res.params, e.best_params))):
        raise AssertionError(
            f"compiled train {family}: after {TRAIN_EPOCHS} epochs the weights {unequal} / "
            f"moments {unequal_state} differ, or the val MSEs {res.val_mse_init} "
            f"{res.history['val_loss']} vs {e.val0} {e.vals}, or the best epoch "
            f"{res.best_epoch} vs {e.best_epoch} or its weights")
    print(f"[compiled train {family}] {sum(p.numel() for p in cparams):,} params, {steps} steps "
          f"in {TRAIN_EPOCHS} epochs on {e.windows} windows: train_client's graphs (replays "
          f"{replays}) torch.equal to the eager trajectory: {steps} batch MSEs, "
          f"{TRAIN_EPOCHS + 1} val MSEs ({e.val0:.6f} -> {e.vals[-1]:.6f}), best epoch "
          f"{e.best_epoch} and its weights, last weights, Adam moments and count")
    return len(e.mses[0])


def dropout_replays_check(ccfg, device):
    """The GRU's step at lr = 0 (the weights stay, the masks move) on one
    batch, compiled and eager from generators with one seed: every call's
    MSE equal, and the replays' MSEs pairwise different — each replay
    draws its own mask, the one the eager step draws."""
    import torch

    from ppqsflhe_tpu_torch.train import compiled
    from ppqsflhe_tpu_torch.train import trainer as T

    cfg = dict(ccfg, model="gru", learning_rate=0.0)
    (m1, o1, (Xt, yt, _, _), _, g1), (m2, o2, _, _, g2) = (fresh_client(cfg, SEED, device)
                                                           for _ in range(2))
    cs = compiled.CompiledStep(m1, o1, Xt, yt, ORCH_BATCH, g1)
    sel = torch.arange(ORCH_BATCH, device=device)
    got, want = [], []
    for _ in range(compiled.WARMUP + 4):
        got.append(float(cs(sel)))
        want.append(float(T.train_step(m2, o2, Xt[sel], yt[sel], g2)))
    replayed = got[compiled.WARMUP:]
    if got != want or len(set(replayed)) != len(replayed):
        raise AssertionError(f"compiled train: dropout at lr=0, compiled {got} vs eager {want}")
    if not all(torch.equal(a, b) for a, b in zip(m1.parameters(), m2.parameters())):
        raise AssertionError("compiled train: lr=0 moved the weights")
    print(f"[compiled train] dropout: one batch at lr=0, {len(got)} steps ({compiled.WARMUP} "
          f"eager warm-up, then replays): MSEs {[f'{v:.6f}' for v in got]}, each equal to the "
          f"eager step's from the same generator state, the replays' pairwise different")


def train_timing(family, ccfg, device, card, n_steps):
    """Eager vs compiled on one fresh model each: ms a step (median of
    STEP_TIMED) and an epoch (median of TRAIN_TIMED), synchronized host
    clock; device ms and launches of one step and device ms of one epoch
    from one CUDA-only profile each, the epoch's idle share; the capture's
    seconds; ms of a validation MSE."""
    import torch

    from ppqsflhe_tpu_torch.train import compiled
    from ppqsflhe_tpu_torch.train import trainer as T

    out = {}
    for name in ("eager", "compiled"):
        model, opt, (Xt, yt, Xv, yv), shuffle, drop = fresh_client(ccfg, SEED, device)
        sel = torch.arange(ORCH_BATCH, device=device)
        if name == "eager":
            step = lambda: T.train_step(model, opt, Xt[sel], yt[sel], drop)
            epoch = lambda: T.run_epoch(model, opt, Xt, yt, ORCH_BATCH, shuffle, drop)
            evaluate = lambda: T.eval_mse(model, Xv, yv)
            capture = ""
        else:
            cs = compiled.CompiledStep(model, opt, Xt, yt, ORCH_BATCH, drop)
            for _ in range(compiled.WARMUP + 1):
                cs(sel)
            t0 = time.perf_counter()
            ce = compiled.CompiledEval(model, Xv, yv)
            t_eval = time.perf_counter() - t0
            step = lambda: cs(sel)
            epoch = lambda: T.run_epoch(model, opt, Xt, yt, ORCH_BATCH, shuffle, drop, cs)
            evaluate = ce
            capture = f"; capture: step {cs.capture_s:.3f} s, eval {t_eval:.3f} s"
        step()
        step_ms = statistics.median(host_ms_once(step) for _ in range(STEP_TIMED))
        epoch()
        epoch_ms = statistics.median(host_ms_once(epoch) for _ in range(TRAIN_TIMED))
        eval_ms = statistics.median(host_ms_once(evaluate) for _ in range(STEP_TIMED))
        evs = device_events_once(step)
        step_dev = sum(us for _, us in evs) / 1e3
        epoch_dev = sum(us for _, us in device_events_once(epoch)) / 1e3
        idle = (f"{max(0.0, 1 - epoch_dev / epoch_ms):.1%}" if epoch_dev else "not measured")
        out[name] = step_ms
        print(f"[timing compiled train {family}] {name}: {step_ms:.3f} ms a step (median of "
              f"{STEP_TIMED}), {epoch_ms:.2f} ms an epoch of {n_steps} steps (median of "
              f"{TRAIN_TIMED}), synchronized host clock; one step on the device {step_dev:.3f} "
              f"ms in {len(evs)} launches; one epoch on the device {epoch_dev:.2f} ms, idle "
              f"{idle}; validation MSE {eval_ms:.3f} ms{capture} ({card})")
    return out


def compiled_train_phase(card, device):
    """The compiled training step and validation MSE for the four model
    families at their default widths (the GRU 7 -> 64 -> 64 -> 1) on run
    A's client 1 data: :func:`trajectory_check`, :func:`train_timing`,
    then :func:`dropout_replays_check`. The launch counts are reset
    first: this path launches none of the port's hand-written kernels
    (its float GEMMs are cuBLAS, its pointwise ops torch's)."""
    import tempfile

    import torch

    from ppqsflhe_tpu_torch.fl import compiled as fl_compiled

    t0 = time.perf_counter()
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the trainer's matmuls must stay float32")
    reset_counts()
    fl_compiled.reset_replayed()
    with tempfile.TemporaryDirectory() as tmp:
        base = oconfig("oConfig.example.json", tmp, "A", rounds=1)["CLIENT_CONFIGS"][0]
        base = dict(base, epochs=TRAIN_EPOCHS, patience=TRAIN_EPOCHS)
        for family in TRAIN_FAMILIES:
            ccfg = dict(base, model=family)
            n_steps = trajectory_check(family, ccfg, SEED, device)
            train_timing(family, ccfg, device, card, n_steps)
        dropout_replays_check(base, device)
    counts, replayed = read_counts(), dict(fl_compiled.replayed)
    if any(counts.values()) or any(replayed.values()):
        raise AssertionError(f"compiled train: the training path launched the port's kernels "
                             f"{counts} / {replayed}")
    print(f"[compiled train] kernel launches: none of the seven kernels (wrappers {counts}, "
          f"replayed {replayed})")
    print(f"[compiled train] phase 15: {time.perf_counter() - t0:.1f} s ({card})")


# ---------------------------------------------------------------------------
# Path 16: the compiled scheme (per-op CUDA graphs), the rotation units and
# the multikey round as CUDA graphs
# ---------------------------------------------------------------------------

SCHEME_SCALAR = 0.37     # the mult_scalar constant of phase 16
# phase 16's interleaving of cached operations, each result kept and held to
# its eager reference only at the end (a later replay must change none)
INTERLEAVE = ("rotate 1", "mult", "rotate 2", "re_encrypt", "rotate 1", "add", "conjugate",
              "rotate 2", "mult_scalar", "rotate 1", "sub", "decrypt")


def scheme_ops(rw, conj, rekey):
    """Each cached operation of phase 2's scheme as (the scheme's call, its
    eager body through ``ckks.eval`` / ``ckks.rlwe``), both on (a, b, pt)."""
    from ppqsflhe_tpu_torch.ckks import eval as ev
    from ppqsflhe_tpu_torch.ckks import rlwe

    sch, ctx, keys, relin = rw.sch, rw.sch.ctx, rw.rot_keys, rw.relin
    c = SCHEME_SCALAR
    return {
        "add": (lambda a, b, p: sch.add(a, b), lambda a, b, p: ev.add(ctx, a, b)),
        "sub": (lambda a, b, p: sch.sub(a, b), lambda a, b, p: ev.sub(ctx, a, b)),
        "add_plain": (lambda a, b, p: sch.add_plain(a, p),
                      lambda a, b, p: ev.add_plain(ctx, a, p)),
        "mult_plain": (lambda a, b, p: sch.mult_plain(a, p),
                       lambda a, b, p: ev.rescale(ctx, ev.mult_plain(ctx, a, p))),
        "mult_scalar": (lambda a, b, p: sch.mult_scalar(a, c),
                        lambda a, b, p: ev.mult_scalar(ctx, a, c)),
        "mult": (lambda a, b, p: sch.mult(a, b, relin), lambda a, b, p: ev.mult(ctx, a, b, relin)),
        "rescale": (lambda a, b, p: sch.rescale(a), lambda a, b, p: ev.rescale(ctx, a)),
        "rotate 1": (lambda a, b, p: sch.rotate(a, 1, keys),
                     lambda a, b, p: ev.rotate(ctx, a, 1, keys[1])),
        "rotate 2": (lambda a, b, p: sch.rotate(a, 2, keys),
                     lambda a, b, p: ev.rotate(ctx, a, 2, keys[2])),
        "conjugate": (lambda a, b, p: sch.conjugate(a, conj),
                      lambda a, b, p: ev.conjugate(ctx, a, conj)),
        "re_encrypt": (lambda a, b, p: sch.re_encrypt(a, rekey),
                       lambda a, b, p: ev.re_encrypt(ctx, a, rekey)),
        "decrypt": (lambda a, b, p: sch.decrypt(rw.sk, a),
                    lambda a, b, p: rlwe.decrypt(ctx, rw.sk, a, sch.encoder)),
    }


def same_result(x, y) -> bool:
    """Ciphertexts: ``torch.equal`` residues and equal scales; decrypted
    slots: equal arrays."""
    import numpy as np
    import torch

    if isinstance(x, np.ndarray):
        return np.array_equal(x, y)
    return torch.equal(x.data, y.data) and x.scale == y.scale


def timed_pair(fn, eager_fn, per=1):
    """(wall ms, device ms, idle) of ``eager_fn`` under :func:`eager_ops` and
    of ``fn``: median of ROUNDS CUDA-event times after 3 warm-up calls, the
    device time from one CUDA-only profile; each divided by ``per``."""
    out = []
    for f, scope in ((eager_fn, eager_ops), (fn, contextlib.nullcontext)):
        with scope():
            wall = statistics.median(median_ms(f, 3))
            dev = sum(us for _, us in device_events_once(f)) / 1e3
        out.append((wall / per, dev / per if dev else None,
                    max(0.0, 1 - dev / wall) if dev else None))
    return out


def show_pair(pair, names=("eager", "cached")):
    """:func:`timed_pair`'s numbers in µs."""
    return ", ".join(
        f"{name} {w * 1e3:.1f} us (device "
        + ("not measured" if d is None else f"{d * 1e3:.1f} us")
        + ", idle " + ("not measured" if i is None else f"{i:.1%}") + ")"
        for name, (w, d, i) in zip(names, pair))


def reserved_bytes(device) -> int:
    """Reserved device memory once the allocator's free blocks are released
    (a capture releases them too)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved(device)


def compiled_scheme_phase(card, device, rw, mw, t_script):
    """The compiled scheme on phase 2's N=2^15 world ``rw``: every cached
    operation called WARMUP + 3 times on fresh uniform residues, each
    result ``torch.equal`` to the eager body on the same inputs (every
    key then holds one graph); one interleaving of cached operations, all
    results held at the end; the inner product (its cached mult, rotations
    and adds) within 1e-3 of np.dot, WARMUP + 1 times; µs per operation
    eager -> cached. Then the rotation bench's units captured whole
    (``bench.rotations.CompiledUnit``) ``torch.equal`` to the eager units,
    µs per rotation; then phase 7's multikey world ``mw`` as
    ``bench.multikey.CompiledMultikeyRound`` in both schedules,
    ``torch.equal`` to the eager round and decrypting within 1e-3, ms per
    round eager -> compiled. Last, the replays' kernel launches, the graphs
    cached, the growth of the reserved device memory and the seconds."""
    import numpy as np
    import torch

    from ppqsflhe_tpu_torch.bench import multikey as mk
    from ppqsflhe_tpu_torch.bench import rotations
    from ppqsflhe_tpu_torch.ckks import eval as ev
    from ppqsflhe_tpu_torch.ckks import scheme as scheme_mod
    from ppqsflhe_tpu_torch.ckks.types import Ciphertext, Plaintext
    from ppqsflhe_tpu_torch.utils import graphs

    reserved = lambda: reserved_bytes(device)
    t0 = time.perf_counter()
    reserved0 = reserved()
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    sch, ctx = rw.sch, rw.sch.ctx
    gen = torch.Generator().manual_seed(SEED + 16)
    conj = ev.ksk_to_mont(ctx, sch.conjugation_key_gen(rw.sk, gen))
    _, pk2 = sch.keygen(gen)
    rekey = ev.ksk_to_mont(ctx, sch.rekey_gen(rw.sk, pk2, gen))
    ops = scheme_ops(rw, conj, rekey)
    moduli = ctx.moduli_qp[: sch.params.num_q]
    scale = rw.ct.scale

    def fresh():
        a, b = (Ciphertext(rand_residues(moduli, (2,), N_ROT, gen, device), scale)
                for _ in range(2))
        return a, b, Plaintext(rand_residues(moduli, (), N_ROT, gen, device), scale)

    graphs_before = {k for k, op in sch._graphs.items() if op.graph is not None}
    calls = scheme_mod.WARMUP + 3
    for name, (cached, eager) in ops.items():
        for i in range(calls):
            args = fresh()
            if not same_result(cached(*args), eager(*args)):
                raise AssertionError(f"compiled scheme: {name}, call {i + 1} of {calls}, "
                                     f"differs from the eager operation")
    captured = {k for k, op in sch._graphs.items() if op.graph is not None}
    print(f"[compiled scheme] {len(ops)} cached operations x {calls} calls on fresh inputs "
          f"(N=2^15, {scheme_mod.WARMUP} eager warm-ups a key, then the capture and replays), "
          f"each torch.equal to its eager body; {len(captured)} keys captured "
          f"({len(captured - graphs_before)} in this phase), "
          f"{len(sch._graphs)} keys cached on the scheme ({card})")
    kept = []
    for name in INTERLEAVE:
        args = fresh()
        kept.append((name, ops[name][0](*args), ops[name][1](*args)))
    bad = [i for i, (_, got, want) in enumerate(kept) if not same_result(got, want)]
    if bad:
        raise AssertionError(f"compiled scheme: interleaved results {bad} "
                             f"({[kept[i][0] for i in bad]}) changed or differ")
    print(f"[compiled scheme] interleaving of {len(INTERLEAVE)} cached operations "
          f"({', '.join(INTERLEAVE)}), every result kept and held at the end: all "
          f"torch.equal to the eager ones")
    ips = []
    for _ in range(scheme_mod.WARMUP + 1):
        ips.append(sch.inner_product(rw.cu1, rw.cu2, rw.relin, rw.rot_keys))
    err_ip = max(float(np.abs(sch.decrypt(rw.sk, ip) - np.dot(rw.u1, rw.u2)).max())
                 for ip in ips)
    if not (np.isfinite(err_ip) and err_ip < ERR_GATE
            and all(same_result(ip, ips[0]) for ip in ips)):
        raise AssertionError(f"compiled scheme: inner product err {err_ip} or its calls differ")
    print(f"[compiled scheme] inner product of {sch.encoder.slots} slots through the cached "
          f"mult, rotations and adds, {len(ips)} calls: err {err_ip:.3e} (gate {ERR_GATE}), "
          f"the calls equal")
    for name, (cached, eager) in ops.items():
        args = fresh()
        pair = timed_pair(lambda: cached(*args), lambda: eager(*args))
        print(f"[timing compiled scheme] {name}: {show_pair(pair)}; eager/cached "
              f"{pair[0][0] / pair[1][0]:.2f}x (N=2^15; {card})")
    reserved_ops = reserved()

    for name in ("plain", "hoisted", "rot_sum"):
        eager = rotations.units(sch, rw.ct, rw.rot_keys, ROTS)[name]
        cu = rotations.CompiledUnit(sch, name, rw.ct, rw.rot_keys, ROTS)
        if not all(same_result(a, b) for a, b in zip(cu.replay(), eager())):
            raise AssertionError(f"compiled rotations {name}: differs from the eager unit")
        pair = timed_pair(lambda: [o.data for o in cu.replay()], eager, per=len(ROTS))
        print(f"[timing compiled rotations] {name}: torch.equal to the eager unit; per rotation "
              f"(R={len(ROTS)}) {show_pair(pair, ('eager', 'compiled'))}; "
              f"eager/compiled {pair[0][0] / pair[1][0]:.2f}x; capture {cu.capture_s:.3f} s "
              f"(N=2^15; {card})")
        del cu

    msch, w = mw.sch, mw.w
    mk_graph = {}
    for lazy in (4, 0):
        staged = mk.stage(w.stacks, mk.inbound_level(msch, lazy))
        eager = mk.server_round(msch, staged, w.rk_to, w.rk_from, lazy)
        before = reserved()
        cr = mk.CompiledMultikeyRound(msch, w.rk_to, w.rk_from, lazy, staged.data.shape,
                                      staged.scale)
        mk_graph[lazy] = reserved() - before
        got = cr(staged)
        if not all(same_result(a, b) for a, b in zip(got, eager)):
            raise AssertionError(f"compiled multikey lazy={lazy}: differs from the eager round")
        errs = mk.check(msch, w, mw.vecs, *got)
        if not all(np.isfinite(e) and e < ERR_GATE for e in errs.values()):
            raise AssertionError(f"compiled multikey lazy={lazy}: decrypt error {errs}")
        del eager, got
        e, c = mk.measure(msch, staged, w.rk_to, w.rk_from, lazy), mk.measure_replays(cr)
        print(f"[compiled multikey lazy={lazy}] torch.equal to the eager round; decrypt max err "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f" (gate {ERR_GATE}); {sum(cr.launches.values())} kernel launches a replay; "
              f"capture {cr.capture_s:.2f} s (2 warm-up rounds included)")
        for name, m in (("eager", e), ("compiled", c)):
            dev = "not measured" if m["device_ms"] is None else f"{m['device_ms']:.3f} ms"
            idle = "not measured" if m["idle_share"] is None else f"{m['idle_share']:.1%}"
            print(f"[timing compiled multikey lazy={lazy}] {name}: {m['ms']:.3f} ms/round, "
                  f"{m['rounds_per_sec']:.3f} rounds/s ((t3 - t1)/2), device {dev}, host "
                  f"enqueue {m['enqueue_ms']:.3f} ms, idle {idle} ({MK_CLIENTS} clients x "
                  f"{staged.data.shape[1]} ciphertexts, N=2^14; {card})")
        del cr, staged
    torch.cuda.synchronize()
    replayed = {k: v for k, v in graphs.replayed.items() if v}
    missing = [k for k in ("mxu_ntt", "streamed_stage_a", "streamed_stage_b", "base_extend",
                           "ks_inner_product") if not replayed.get(k)]
    if missing:
        raise AssertionError(f"compiled scheme: replays never launched {missing}")
    mib = lambda b: b / 2**20
    print(f"[compiled scheme] kernel launches by replays: {replayed}; by the wrappers (warm-ups, "
          f"eager references) { {k: v for k, v in graphs.wrapper_counts().items() if v} }")
    n_captured = sum(op.graph is not None for op in sch._graphs.values())
    print(f"[memory compiled scheme] {len(sch._graphs)} keys cached on the N=2^15 scheme, "
          f"{n_captured} of them captured; reserved device memory (free blocks released "
          f"before each read): {mib(reserved0):.1f} MiB at the phase's start, "
          f"{mib(reserved_ops):.1f} MiB after the cached operations (+"
          f"{mib(reserved_ops - reserved0):.1f}); a multikey round's graph, its static stacks "
          f"included: lazy-4 +{mib(mk_graph[4]):.1f} MiB, full +{mib(mk_graph[0]):.1f} MiB; "
          f"{mib(reserved()):.1f} MiB at the end, peak "
          f"{mib(torch.cuda.max_memory_reserved(device)):.1f} MiB ({card})")
    now = time.perf_counter()
    print(f"[compiled scheme] phase 16: {now - t0:.1f} s; the script so far "
          f"{now - t_script:.1f} s ({card})")


# ---------------------------------------------------------------------------
# Path 17: the randomized scheme (draws outside, bodies through the per-op
# graph cache)
# ---------------------------------------------------------------------------

RANDOM_CALLS_EXTRA = 3      # calls of each randomized operation past its warm-up
CCA_BATCH = 32              # the INDCCA hop's ciphertexts (client 0's first)


def twin(gen):
    """A generator in ``gen``'s state: it makes again the draws ``gen`` is
    about to make (a clone of them)."""
    import torch

    return torch.Generator(gen.device).set_state(gen.get_state())


def random_ops(rw, mw, ind, pk2, sk2, pt, cca):
    """Each randomized operation as (its call through the scheme on a
    generator, its draws on a generator, its eager body on those draws, a
    check of one result that uses it and returns its decryption error).
    The key generators, keygen and encrypt run on phase 2's N=2^15 world,
    INDCCA re_encrypt on phase 7's multikey world (N=2^14) in PREMode
    INDCCA."""
    import numpy as np
    import torch

    from ppqsflhe_tpu_torch.ckks import eval as ev
    from ppqsflhe_tpu_torch.ckks import rlwe

    sch, ctx, sk, dev = rw.sch, rw.sch.ctx, rw.sk, rw.sch.device
    free = torch.Generator().manual_seed(SEED + 170)    # encryptions that only check a key
    L = sch.params.num_q
    s = sk.s_eval
    idx = tuple(range(L))
    g1, gc = ev.rot_to_galois(1, sch.params.n), 2 * sch.params.n - 1
    ct, v = rw.ct, rw.v
    err = lambda c, want, key=sk: float(np.abs(sch.decrypt(key, c) - want).max())
    sk_path = lambda target: (lambda g: ev.ksk_draws(ctx, g, dev, pk_path=False),
                              lambda d: ev.ksk_body(ctx, target, s, False, *d))

    def check_cca(c):
        from ppqsflhe_tpu_torch.bench.multikey import slot_diffs

        coeffs = rlwe.decrypt_to_coeffs(ind.ctx, mw.w.sks[-1].s_eval, c)
        d = slot_diffs(ind, coeffs, c, mw.vecs[0][:CCA_BATCH])
        return float(np.sqrt(np.mean(d ** 2))), float(np.abs(d).max())

    ccts, rk_cca, pk_hub = cca
    return {
        "keygen": (lambda g: sch.keygen(g), lambda g: rlwe.keygen_draws(ctx, g, dev),
                   lambda d: rlwe.keygen_body(ctx, *d),
                   lambda r: err(sch.encrypt(r[1], pt, free), v, r[0])),
        "relin_key_gen": (lambda g: sch.relin_key_gen(sk, g),
                          *sk_path(rlwe._poly_mul(ctx, s[:L], s[:L], idx)),
                          lambda k: err(ev.mult(ctx, ct, ct, k), v * v)),
        "rot_key_gen": (lambda g: sch.rotation_key_gen(sk, [1], g)[1],
                        *sk_path(ev.automorphism(ctx, s[:L], g1)),
                        lambda k: err(ev.rotate(ctx, ct, 1, k), np.roll(v, -1))),
        "conj_key_gen": (lambda g: sch.conjugation_key_gen(sk, g),
                         *sk_path(ev.automorphism(ctx, s[:L], gc)),
                         lambda k: err(ev.conjugate(ctx, ct, k), v)),
        "rekey_gen": (lambda g: sch.rekey_gen(sk, pk2, g),
                      lambda g: ev.ksk_draws(ctx, g, dev, pk_path=True),
                      lambda d: ev.ksk_body(ctx, s[:L], pk2.data, True, *d),
                      lambda k: err(ev.re_encrypt(ctx, ct, k), v, sk2)),
        "encrypt": (lambda g: sch.encrypt(rw.pk, pt, g),
                    lambda g: rlwe.encrypt_draws(ctx, g, (), dev),
                    lambda d: rlwe.encrypt_body(ctx, rw.pk, pt, *d),
                    lambda c: err(c, v)),
        "re_encrypt INDCCA": (lambda g: ind.re_encrypt(ccts, rk_cca, pk_hub, g),
                              lambda g: rlwe.zero_draws(ind.ctx, g, ccts.data.shape[:-3],
                                                        ccts.data.device,
                                                        ind.params.pre_flood_bits),
                              lambda d: ev.re_encrypt_indcca(ind.ctx, ccts, rk_cca, pk_hub, *d),
                              check_cca),
    }


def randomized_phase(card, device, rw, mw, th_split, t_script):
    """The randomized scheme: keygen, relin_key_gen, rot_key_gen (r = 1),
    conj_key_gen, rekey_gen and encrypt on phase 2's N=2^15 world and
    INDCCA re_encrypt on phase 7's multikey world (its scheme in PREMode
    INDCCA, its context shared), each called WARMUP + 3 times on a CUDA
    generator and as often on a CPU generator: every result ``torch.equal``
    to the eager body on the same draws (a twin generator makes them
    again), every key used once in a key switch (keygen's pair in an
    encryption) and every encryption and INDCCA hop decrypted within its
    gate; each of the seven keys must have captured its graph and replayed
    it. Then µs per operation eager -> cached (CUDA generator, draws
    included), the multikey prep's and the threshold phase's encryptions
    split into encode, draws and body, the replays' kernel launches (each
    of kernels 1-5 required), the graphs cached, the reserved memory's
    growth and the seconds."""
    import copy
    import dataclasses

    import numpy as np
    import torch

    from ppqsflhe_tpu_torch.ckks import eval as ev
    from ppqsflhe_tpu_torch.ckks import scheme as scheme_mod
    from ppqsflhe_tpu_torch.ckks.types import Ciphertext
    from ppqsflhe_tpu_torch.utils import graphs

    t0 = time.perf_counter()
    reserved0 = reserved_bytes(device)
    reset_counts()
    sch, msch, w = rw.sch, mw.sch, mw.w
    ind = copy.copy(msch)           # phase 7's scheme, its context shared, in PREMode INDCCA
    ind.params = dataclasses.replace(msch.params, pre_mode="INDCCA")
    ind._graphs = graphs.GraphCache()
    gens = {"CUDA": torch.Generator(device=device).manual_seed(SEED + 17),
            "CPU": torch.Generator().manual_seed(SEED + 17)}
    sk2, pk2 = sch.keygen(gens["CPU"])
    pt = sch.make_plaintext(rw.v)
    cca = (Ciphertext(w.stacks.data[0, :CCA_BATCH], w.stacks.scale), w.rk_to[0], w.pks[-1])
    ops = random_ops(rw, mw, ind, pk2, sk2, pt, cca)
    graphs_before = len(sch._graphs)
    calls = scheme_mod.WARMUP + RANDOM_CALLS_EXTRA
    errs = {}
    for name, (cached, draw, body, check) in ops.items():
        for kind, gen in gens.items():
            for i in range(calls):
                again = twin(gen)
                got = cached(gen)
                want = body(draw(again))
                pairs = (list(zip((got[0].s_eval, got[1].data), want)) if name == "keygen"
                         else [(got.data, want.data)])
                if not all(torch.equal(a, b) for a, b in pairs):
                    raise AssertionError(f"randomized scheme: {name}, {kind} generator, call "
                                         f"{i + 1} of {calls}, differs from the eager body on "
                                         f"the same draws")
                errs.setdefault(name, []).append(check(got))
    print(f"[randomized] {len(ops)} randomized operations x {calls} calls x {len(gens)} "
          f"generators (CUDA, CPU), each torch.equal to its eager body on the same draws "
          f"({scheme_mod.WARMUP} eager warm-ups a key, then the capture and replays) ({card})")
    failures = []
    for name, es in errs.items():
        if name == "re_encrypt INDCCA":
            rms, mx = max(e[0] for e in es), max(e[1] for e in es)
            ok = rms < CCA_UNIT and mx < 4 * CCA_UNIT
            what = (f"error RMS {rms:.4e}, max {mx:.4e} (the worst of the calls); gate RMS < "
                    f"{CCA_UNIT:.4f}, max < {4 * CCA_UNIT:.4f}")
        else:
            mx = max(es)
            ok = mx < ERR_GATE
            use = "" if name in ("encrypt", "keygen") else ", each key used once in a key switch"
            what = f"decrypt max err {mx:.3e} (the worst of the calls{use}); gate {ERR_GATE}"
        print(f"[randomized {name}] {what}: {'held' if ok else 'FAILED'} ({card})")
        if not (np.isfinite(mx) and ok):
            failures.append(name)
    if failures:
        raise AssertionError(f"randomized scheme: gates failed for {failures}")
    g1 = ev.rot_to_galois(1, sch.params.n)
    for owner, keys in ((sch, ("keygen", "relin_key_gen", ("rot_key_gen", g1), "conj_key_gen",
                               "rekey_gen", "encrypt")), (ind, (("re_encrypt", "INDCCA"),))):
        for key in keys:
            held = [op for k, op in owner._graphs.items() if k[0] == key]
            if not any(op.graph is not None and op.replays for op in held):
                raise AssertionError(f"randomized scheme: {key} captured no graph or never "
                                     f"replayed it")
    replayed = {k: v for k, v in graphs.replayed.items() if v}
    missing = [k for k in ("mxu_ntt", "streamed_stage_a", "streamed_stage_b", "base_extend",
                           "ks_inner_product") if not replayed.get(k)]
    if missing:
        raise AssertionError(f"randomized scheme: replays never launched {missing}")
    print(f"[randomized] kernel launches by replays: {replayed}; by the wrappers (warm-ups, "
          f"eager bodies, key checks) { {k: v for k, v in graphs.wrapper_counts().items() if v} }")
    reserved_ops = reserved_bytes(device)

    gen = gens["CUDA"]
    for name, (cached, _, _, _) in ops.items():
        pair = timed_pair(lambda: cached(gen), lambda: cached(gen))
        print(f"[timing randomized] {name}: {show_pair(pair)}; eager/cached "
              f"{pair[0][0] / pair[1][0]:.2f}x (draws included, CUDA generator; "
              f"{'N=2^14, ' + str(CCA_BATCH) + ' ciphertexts' if 'INDCCA' in name else 'N=2^15'}"
              f"; {card})")
    mk_s = w.seconds
    print(f"[randomized] multikey prep (phase 7): {MK_CLIENTS * w.stacks.data.shape[1]} "
          f"encryptions {mk_s['encrypt']:.3f} s = encode {mk_s['encode']:.3f} + draws "
          f"{mk_s['draws']:.3f} + body {mk_s['body']:.3f} s (synchronized); keygen "
          f"{mk_s['keygen']:.3f} s, "
          f"{2 * (MK_CLIENTS - 1)} rekeys {mk_s['rekeys']:.3f} s ({card})")
    th_ms = sum(th_split.values()) * 1e3
    print(f"[randomized] threshold (phase 8): {TH_PARTIES} x {w.stacks.data.shape[1]} "
          f"encryptions {th_ms:.1f} ms = encode {th_split['encode'] * 1e3:.1f} + draws "
          f"{th_split['draws'] * 1e3:.1f} + body {th_split['body'] * 1e3:.1f} ms "
          f"(synchronized) ({card})")
    n_rand = {k for k in list(sch._graphs) + list(ind._graphs)
              if k[0] in ("keygen", "relin_key_gen", "conj_key_gen", "rekey_gen", "encrypt",
                          ("re_encrypt", "INDCCA")) or k[0][0] == "rot_key_gen"}
    mib = lambda b: b / 2**20
    print(f"[memory randomized] {len(sch._graphs) - graphs_before} keys added on the N=2^15 "
          f"scheme ({len(sch._graphs)} in all), {len(ind._graphs)} on the INDCCA twin; "
          f"{len(n_rand)} randomized keys on the two, "
          f"{sum(1 for k in n_rand if (sch._graphs.get(k) or ind._graphs.get(k)).graph)} "
          f"captured; reserved device memory {mib(reserved0):.1f} MiB at the phase's start, "
          f"{mib(reserved_ops):.1f} MiB after the checks (+{mib(reserved_ops - reserved0):.1f}), "
          f"{mib(reserved_bytes(device)):.1f} MiB at the end ({card})")
    now = time.perf_counter()
    print(f"[randomized] phase 17: {now - t0:.1f} s; the whole script {now - t_script:.1f} s "
          f"({card})")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — needs a CUDA GPU")
    from ppqsflhe_tpu_torch.ops import cuda_lib

    t_script = time.perf_counter()
    device = torch.device("cuda", 0)
    card = sh(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    print(f"[card] {card}")
    print(f"[toolchain] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"torch.version.cuda {torch.version.cuda}")
    print("[toolchain] nvcc: " + sh([cuda_lib.nvcc(), "--version"]).splitlines()[-1])

    t0 = time.perf_counter()
    cuda_lib.library()
    print(f"[build] kernels built in {cuda_lib.build_seconds or 0.0:.1f} s "
          f"(load {time.perf_counter() - t0:.1f} s) -> {cuda_lib.build()}")

    kernels, world, outs = round_phase(card, device, args.profile)
    rows, rot_world = rotation_phase(card, device, args.profile)
    kernels += rows
    kernels += ntt_phase(card, device)
    rows, world16 = round16_phase(card, device, args.profile)
    kernels += rows
    rows, butterfly = butterfly_phase(card, device, world, outs, args.profile)
    kernels += rows
    kernels += files_phase(card, device, args.profile)
    rows, mk_world = multikey_phase(card, device)
    kernels += rows
    rows, th_split = threshold_phase(card, device)
    kernels += rows
    kernels += probe_phase(card, device)
    kernels += orchestrated_phase(card, device)
    kernels += twins_phase(card, device)
    kernels += sharded_phase(card, device, world, outs)
    kernels += small_rings_phase(card, device)
    mxu_need = ("mxu_ntt", "base_extend", "ks_inner_product")
    radix2 = round_world(N_ROUND, device, backend="radix2")
    compiled_phase(card, device, (
        ("round", world.sch, world, (4, 0, 1, 2, 3), mxu_need),
        ("radix-2 round", radix2.sch, radix2, (4, 0), ("base_extend", "ks_inner_product")),
        ("butterfly round", butterfly, world, (4, 0),
         ("fourstep_ntt", "base_extend", "ks_inner_product")),
        ("round N=2^16", world16.sch, world16, (4, 0),
         ("mxu_ntt_mont", "streamed_stage_a", "streamed_stage_b", "base_extend",
          "ks_inner_product"))))
    del radix2
    compiled_train_phase(card, device)
    compiled_scheme_phase(card, device, rot_world, mk_world, t_script)
    randomized_phase(card, device, rot_world, mk_world, th_split, t_script)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
