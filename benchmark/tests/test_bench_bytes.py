"""The byte counts of the three rooflines against hand counts at N = 2^6
(chain 60/40/40 + 2 × 60, dnum 2: L = 3, K = 2, digits of 2 limbs; and the
configurations' 60/40/40/20 FLEXIBLEAUTOEXT chain: L = 4, K = 2), B = 3
ciphertexts a client, and the trace readers on hand-made spans.

Hand counts, in limb-polys of 64 × 8 bytes. A PRE at level l with digits
d_g does l + Σ(l + K − d_g) + 2K + 2l transforms per poly; its base
extensions move Σ(d_g + l + K − d_g) per poly plus 2(K + l) for ModDown's
two components; its inner product reads nd(l + K) digit rows per poly and
nd·2(l + K) key rows, and writes 2(l + K) per poly.

- lazy-4, 2 clients (PRE at l = 2, digits [2]; back at l = 1, digits [1]):
  transforms 3·(2+2+4+4) + 3·(1+2+4+2) = 36 + 27 = 63; key-switch polys
  (3·4 + 6·4) + (12 + 8 + 24) = 80 at l = 2, (3·3 + 6·3) + (9 + 6 + 18) = 60
  at l = 1: 140; round: inputs 2·3·2·2 = 24, rekeys 8 + 6 = 14, outputs
  2·3·2·1 = 12: 50.
- full, 2 clients (PRE at l = 3, digits [2, 1]; rescale of 2·3 polys; back
  at l = 2): transforms 3·(3+3+4+4+6) + 36 + 2·3·3 = 60 + 36 + 18 = 114;
  key-switch (3·(5+5) + 6·5) + (2·5·3 + 2·2·5 + 2·5·3) = 140 at l = 3, + 80
  = 220; round: inputs 36, rekeys 20 + 8, outputs 24: 88.
- lazy-4, 16 clients: 15 PREs each way: transforms 15·63 = 945; key-switch
  15·140 = 2,100; round: inputs 16·3·2·2 = 192, rekeys 15·14 = 210, outputs
  16·3·2·1 = 96: 498.
- 60/40/40/20, lazy-4, 2 clients (the 20-bit limb dropped; PRE at l = 3,
  digits [2, 1]; back at l = 2, digits [2]): transforms 60 + 36 = 96;
  key-switch 140 + 80 = 220; round: inputs 2·3·2·3 = 36, rekeys 20 + 8,
  outputs 2·3·2·2 = 24: 88.
- 60/40/40/20, full, 2 clients (PRE at l = 4, digits [2, 2]; rescale of
  2·3 polys; back at l = 3): transforms 3·(4+4+4+4+8) + 60 + 2·3·4 = 72 +
  60 + 24 = 156; key-switch (3·12 + 6·6) + (2·6·3 + 2·2·6 + 2·6·3) = 168 at
  l = 4, + 140 = 308; round: inputs 48, rekeys 24 + 20, outputs 36: 128.
"""

import importlib.util
import types
from pathlib import Path

import pytest

from benchmark import trace, work
from benchmark.peaks import HBM_BPS
from benchmark.reference import chain

METRICS = Path(__file__).resolve().parents[1] / "metrics"
POLY = 64 * 8


def metric(name):
    spec = importlib.util.spec_from_file_location(f"m_{name}", METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("ext, clients, lazy, ntt, ks, rnd", [
    (0, 2, work.LAZY, 63, 140, 50),
    (0, 2, work.FULL, 114, 220, 88),
    (0, 16, work.LAZY, 945, 2100, 498),
    (20, 2, work.LAZY, 96, 220, 88),
    (20, 2, work.FULL, 156, 308, 128),
])
def test_hand_counts(ext, clients, lazy, ntt, ks, rnd):
    w = work.of(chain.chain(64, 2, 60, 40, 2, ext), clients, 3, lazy)
    assert (w.L, w.K, w.alpha) == (4 if ext else 3, 2, 2)
    assert metric("ntt.bytes_roofline").least_bytes(w) == ntt * 2 * POLY
    assert metric("keyswitch.bytes_roofline").least_bytes(w) == ks * POLY
    assert metric("round.bytes_roofline").least_bytes(w) == rnd * POLY


def span(rounds, device, start=0, end=1000, host=()):
    return trace.Span(rounds, start, end, list(device), sorted(host, key=lambda h: h[2] - h[1]))


def test_readers_on_a_hand_made_span():
    w = work.of(chain.chain(64, 2, 60, 40, 2), 2, 3, work.LAZY)
    s = span(2, [("void mxu_ntt_stage_kernel<128>(...)", 0, 100),
                 ("ks_ip_kernel", 100, 150), ("base_extend_kernel", 150, 250),
                 ("elementwise_kernel", 300, 500), ("Memcpy DtoD (Device -> Device)", 500, 600),
                 ("elementwise_kernel", 550, 650)],
             host=[("cudaEventSynchronize", 0, 1000), ("cudaGraphLaunch", 260, 280)])
    rec = types.SimpleNamespace(work=w, spans=[s], mean_round_s=1e-3)
    assert s.busy() == [[0, 250], [300, 650]]
    assert s.gaps() == [("cudaGraphLaunch", 50), ("cudaEventSynchronize", 350)]
    assert metric("device.idle_share").read(rec) == pytest.approx(100 * (1 - 600 / 1000))
    assert metric("server.host_gap_ms").read(rec) == pytest.approx(400 / 2 / 1e6)
    assert metric("elementwise.device_ms").read(rec) == pytest.approx(300 / 2 / 1e6)
    ntt_s = 100 / 2 / 1e9
    assert metric("ntt.bytes_roofline").read(rec) == pytest.approx(
        100 * 63 * 2 * POLY / HBM_BPS / ntt_s)
    assert metric("keyswitch.bytes_roofline").read(rec) == pytest.approx(
        100 * 140 * POLY / HBM_BPS / (150 / 2 / 1e9))
    assert metric("round.bytes_roofline").read(rec) == pytest.approx(
        100 * 50 * POLY / HBM_BPS / 1e-3)
    empty = types.SimpleNamespace(work=w, spans=[], mean_round_s=None)
    for name in ("device.idle_share", "server.host_gap_ms", "elementwise.device_ms",
                 "ntt.bytes_roofline", "keyswitch.bytes_roofline", "round.bytes_roofline"):
        assert metric(name).read(empty) is None


def test_incomplete_spans_are_dropped():
    full = [("mxu_ntt_stage_kernel", 0, 1), ("mxu_ntt_stage_kernel", 1, 2), ("add_kernel", 2, 3)]
    copy = [("Memcpy DtoD (Device -> Device)", 3, 4)]
    spans = [span(1, full), span(1, full[1:]), span(1, full[:2]), span(2, full + full + copy)]
    kept, dropped = trace.complete(spans, {"mxu_ntt": 2, "base_extend": 0})
    assert kept == [spans[0], spans[3]]
    assert len(dropped) == 2
    assert trace.top([("a", 3), ("b", 5), ("a", 4)], 1) == [["a", 7e-9]]
