"""ntt.device_ms: device ms a round in the program's ``ntt`` spans
(``ckks/params.py`` ``CkksContext.ntt`` and ``.intt``, wherever the round
calls them: the NTT kernels with their limb gathers and glue), from timing
events captured into the instrumented round's CUDA graph
(``benchmark/spans.py``)."""

from benchmark import spans


def read(rec):
    return spans.device_ms(rec, "ntt")
