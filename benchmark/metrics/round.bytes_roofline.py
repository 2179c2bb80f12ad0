"""round.bytes_roofline: the least bytes the whole round needs — each
client's input read once at the level the round uses it, each rekey's
active digits read once, the average and every re-encryption written once
(see ``benchmark/work.py``) — over 3.35 TB/s, as a share of the mean round
time of the traced run's untraced rounds (host clock), in %."""

from benchmark.peaks import HBM_BPS


def polys(w) -> int:
    inputs = w.clients * w.batch * 2 * w.l_in
    rekeys = sum(pres * len(w.digits(l)) * 2 * (l + w.K) for l, pres in w.hops())
    outputs = w.clients * w.batch * 2 * w.l_out
    return inputs + rekeys + outputs


def least_bytes(w) -> int:
    return polys(w) * w.poly_bytes


def read(rec):
    if not rec.mean_round_s:
        return None
    return 100.0 * least_bytes(rec.work) / HBM_BPS / rec.mean_round_s
