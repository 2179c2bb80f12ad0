"""pre.inner_product_ms: device ms a round in the program's
``ks.inner_product`` spans (``ckks/eval.py`` ``keyswitch_ip``: the digits'
stack and ``ks_ip_kernel``), from timing events captured into the
instrumented round's CUDA graph (``benchmark/spans.py``)."""

from benchmark import spans


def read(rec):
    return spans.device_ms(rec, "ks.inner_product")
