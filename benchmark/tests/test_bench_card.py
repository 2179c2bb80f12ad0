"""On the card (skipped without one): each cell's compiled round, run by
:func:`benchmark.run.run` at its own sizes for a second, comes out
correct with every end-to-end metric read, as the command's own runs do.
Run on the card with ``python3 -m pytest benchmark/tests -m card``."""

import time

import pytest

from benchmark import run
from benchmark.tests import cells


@pytest.mark.card
@pytest.mark.parametrize("cell", cells.CELLS)
def test_a_cell_runs_on_the_card(card, cell):
    c, cfg, traffic, plan = run.load(cells.SPEC, cell, cells.ROOT)
    metrics = run.metrics(cells.SPEC, "end_to_end", cell)
    res = run.run(c, cfg, traffic, plan, metrics, 2**31 + 99, 1.0, False, card,
                  t0=time.perf_counter())
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert set(res["metrics"]) == {m[0] for m in metrics}
