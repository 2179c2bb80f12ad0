"""ntt.big_ms: device ms a round in the program's ``ntt.big`` spans: the "big" route's limbs (the 60-bit q0, p0, p1: kernels 4 + 5, ``ops/cuda_mxu_ntt.py`` ``CudaMxuNttBig``)
inside a transform whose limbs take more than one route (``CudaMxuNtt._route``;
no such transform at N = 2^14), from timing events captured into the
instrumented round's CUDA graph (``benchmark/spans.py``). None where the
program opens no such span."""

from benchmark import spans


def read(rec):
    return spans.device_ms(rec, "ntt.big")
