"""pre.decompose_ms: device ms a round in the program's ``ks.decompose``
spans (``ckks/eval.py`` ``keyswitch_core``: the inverse transform, each
digit's base extension, forward transform, constant product and
concatenation), from timing events captured into the instrumented round's
CUDA graph (``benchmark/spans.py``)."""

from benchmark import spans


def read(rec):
    return spans.device_ms(rec, "ks.decompose")
