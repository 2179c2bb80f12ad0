"""ntt.mont_ms: device ms a round in the program's ``ntt.mont`` spans: the "fused_mont" route's limbs (the 40-bit q1, q2 at N = 2^16: kernel 1b, ``CudaMxuNtt.fused`` with ``mont``)
inside a transform whose limbs take more than one route (``CudaMxuNtt._route``;
no such transform at N = 2^14), from timing events captured into the
instrumented round's CUDA graph (``benchmark/spans.py``). None where the
program opens no such span."""

from benchmark import spans


def read(rec):
    return spans.device_ms(rec, "ntt.mont")
