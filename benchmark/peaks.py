"""The published memory bandwidth of one NVIDIA H100 SXM (NVIDIA's data
sheet), the bytes roofline's denominator: copied from ``chip_smoke.py``
``HBM_BPS``, whose ``bound`` divides a kernel's bytes by it (its int8
operation bound has no kernel on the benchmark's path)."""

HBM_BPS = 3.35e12    # H100 SXM device memory, bytes/s
