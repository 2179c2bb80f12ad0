"""pre.mod_down_ms: device ms a round in the program's ``ks.mod_down``
spans (``ckks/eval.py`` ``_mod_down``: the P limbs' inverse transform,
base extension and forward transform, the subtraction and the product by
P⁻¹), from timing events captured into the instrumented round's CUDA graph
(``benchmark/spans.py``)."""

from benchmark import spans


def read(rec):
    return spans.device_ms(rec, "ks.mod_down")
