"""ntt.bytes_roofline: the round's transforms at the least bytes they need
(each limb-poly read once and written once per transform, however many
passes a kernel makes) over 3.35 TB/s, as a share of the device time of the
NTT kernels (``csrc/mxu_ntt.cu``, ``streamed_ntt.cu``, ``fourstep_ntt.cu``),
in %."""

from benchmark.peaks import HBM_BPS

SYMBOLS = ("mxu_ntt_stage_kernel", "mxu_ntt_stage_mont_kernel", "streamed_stage_a_kernel",
           "streamed_stage_b_kernel", "fourstep_ntt_kernel")


def transforms(w) -> int:
    """Limb-poly transforms of one round (see ``benchmark/work.py``)."""
    total = 0
    for l, pres in w.hops():
        per = l + sum(l + w.K - d for d in w.digits(l)) + 2 * w.K + 2 * l
        total += pres * w.batch * per
    if w.rescale:                    # top limb back, then L−1 limbs forward, 2B polys
        total += 2 * w.batch * w.L
    return total


def least_bytes(w) -> int:
    return transforms(w) * 2 * w.poly_bytes


def read(rec):
    rounds = sum(s.rounds for s in rec.spans)
    ns = sum(e - b for s in rec.spans for name, b, e in s.device
             if any(sym in name for sym in SYMBOLS))
    if not rounds or not ns:
        return None
    return 100.0 * least_bytes(rec.work) / HBM_BPS / (ns / rounds / 1e9)
