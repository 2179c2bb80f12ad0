"""A whole run of each cell on the CPU (the look for a card skipped, the
program's eager round in place of its CUDA graph) comes out correct; with
the timed path broken underneath it comes out not correct, once for each
fault such a round can have: the state returned unchanged (the inputs
handed back as outputs), half the clients left out of the mean, and one
residue of an answer altered where it is produced. One chip has no
exchange between chips to leave out. The control (the program on the
configuration's 30-bit ``control`` chain) fails the check at the cell's own
ring, with a few ciphertexts a client (2 GRU vectors; a one-layer export's
3), where the stated chain passes."""

import pytest
import torch

from benchmark.tests import cells
from ppqsflhe_tpu_torch.bench.multikey import server_round
from ppqsflhe_tpu_torch.ckks import eval as ev
from ppqsflhe_tpu_torch.ckks.types import Ciphertext
from ppqsflhe_tpu_torch.fl.api import aggregate_batch, change_cipher_domain_batch


def unchanged(entry, rnd):
    """The round hands its inputs back: the hub's as the average, the
    others' as the re-encryptions."""
    if hasattr(entry, "pool0"):
        return lambda a, b: (b, a)
    return lambda st: (Ciphertext(st.data[-1], st.scale), Ciphertext(st.data[:-1], st.scale))


def half(entry, rnd):
    """The mean over the second half of the clients, re-keyed back to all."""
    sch, lazy = entry.sch, entry.lazy
    if hasattr(entry, "pool0"):
        def pair(a, b):
            level = sch.params.num_q - (1 if lazy else 0)
            avg = aggregate_batch(sch, [ev.level_reduce(sch.ctx, b, level)], lazy == 4)
            return avg, change_cipher_domain_batch(sch, entry.rk10, avg)
        return pair

    def many(st):
        h = st.data.shape[0] // 2
        avg, _ = server_round(sch, Ciphertext(st.data[h:], st.scale), entry.rk_to[h:],
                              entry.rk_from[h:], lazy)
        outs = torch.stack([ev.re_encrypt(sch.ctx, avg, rk).data for rk in entry.rk_from])
        return avg, Ciphertext(outs, avg.scale)
    return many


def altered(entry, rnd):
    """One residue of the average changed by one."""
    q0 = entry.sch.params.q_moduli[0]

    def bad(*stacks):
        avg, back = rnd(*stacks)
        data = avg.data.clone()
        data.view(-1)[123] = (data.view(-1)[123] + 1) % q0
        return Ciphertext(data, avg.scale), back
    return bad


@pytest.mark.parametrize("cell", cells.CELLS)
def test_a_sound_run_is_correct(monkeypatch, cell):
    res = cells.drive(monkeypatch, *cells.load(cell))
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-2:] == ["checks", "notes"]


@pytest.mark.parametrize("fault", [unchanged, half, altered], ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", cells.CELLS)
def test_a_broken_round_is_not_correct(monkeypatch, cell, fault):
    res = cells.drive(monkeypatch, *cells.load(cell), wrap=fault)
    assert not res["correct"] and res["failed"] >= 1


CONTROL_PAYLOAD = {"vectors": {"count": 2}, "layers": {"shapes": [[8192]]}}


@pytest.mark.parametrize("cell", cells.CELLS)
def test_the_control_is_not_correct(monkeypatch, cell):
    kind = cells.load(cell)[2]["payload"]["kind"]
    cell_, cfg, traffic, plan = cells.load(cell, 1 << 14, CONTROL_PAYLOAD[kind])
    traffic["input_sets"] = 1
    sound = cells.drive(monkeypatch, cell_, cfg, traffic, plan)
    cfg["scaling_mod_size"] = cfg["control"]["scaling_mod_size"]
    control = cells.drive(monkeypatch, cell_, cfg, traffic, plan)
    assert sound["correct"]
    assert not control["correct"]
    assert control["checks"]["max_err"]["value"] > control["checks"]["max_err"]["limit"]
