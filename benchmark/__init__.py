"""The benchmark of ``ppqsflhe_tpu_torch`` on one NVIDIA H100: the server's
compiled encrypted-aggregation round, run by ``python3 -m benchmark.run``
(see ``run.py``). Nothing here imports ``jax`` or the JAX package."""
