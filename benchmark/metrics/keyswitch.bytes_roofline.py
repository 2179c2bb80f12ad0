"""keyswitch.bytes_roofline: the round's base extensions and key-switch
inner products at the least bytes they need, over 3.35 TB/s, as a share of
the device time of ``base_extend_kernel`` (``csrc/base_ext.cu``) and
``ks_ip_kernel`` (``csrc/ks_ip.cu``), in %. A base extension reads its
source limbs and writes its target limbs once; the inner product reads the
digits and the rekey's active rows once and writes both components once."""

from benchmark.peaks import HBM_BPS

SYMBOLS = ("base_extend_kernel", "ks_ip_kernel")


def polys(w) -> int:
    """Limb-polys the round's key switches move (see ``benchmark/work.py``)."""
    total = 0
    for l, pres in w.hops():
        ds = w.digits(l)
        ext = w.batch * sum(d + (l + w.K - d) for d in ds) + 2 * w.batch * (w.K + l)
        ip = len(ds) * (l + w.K) * w.batch + len(ds) * 2 * (l + w.K) + 2 * (l + w.K) * w.batch
        total += pres * (ext + ip)
    return total


def least_bytes(w) -> int:
    return polys(w) * w.poly_bytes


def read(rec):
    rounds = sum(s.rounds for s in rec.spans)
    ns = sum(e - b for s in rec.spans for name, b, e in s.device
             if any(sym in name for sym in SYMBOLS))
    if not rounds or not ns:
        return None
    return 100.0 * least_bytes(rec.work) / HBM_BPS / (ns / rounds / 1e9)
