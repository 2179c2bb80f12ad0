"""fedavg.device_ms: device ms a round in the program's ``fedavg`` spans
(``fl/api.py`` ``aggregate_batch`` and the lazy-2/3 add; in
``bench/multikey.py`` ``server_round`` each client's add and the ÷C, its
``mult_scalar`` and rescale included), from timing events captured into the
instrumented round's CUDA graph (``benchmark/spans.py``)."""

from benchmark import spans


def read(rec):
    return spans.device_ms(rec, "fedavg")
