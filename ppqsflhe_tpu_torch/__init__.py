"""ppqsflhe_tpu_torch — the PyTorch + CUDA port of ``ppqsflhe_tpu``.

The JAX package stays the reference; every module here mirrors one of its
modules under the same name, and each is held bit for bit against it by the
``tests/test_torch_*.py`` suite. This package imports ``torch`` and never
``jax``.

- ``core``  : int64 twins of the RNS modular arithmetic, prime/NTT tables,
              HPS base extension constants, samplers on ``torch.Generator``,
              and a replay of the JAX PRNG for the threshold CRS.
- ``ops``   : the four-step NTT tables and plain transforms, the wrappers
              of the hand-written CUDA kernels (``csrc/``: the fused NTT
              stages, the streamed pair, the butterfly transform, the HPS
              base extension, the key-switch-key inner product) with their
              plain torch versions, and the coefficient-sharded NTT.
- ``ckks``  : the whole RNS-CKKS scheme (params/context with
              FLEXIBLEAUTOEXT, keys, PRE rekeys, encrypt/decrypt, the
              arithmetic, rescale, hybrid key switching, rotations plain,
              hoisted and summed, conjugation, the inner product, noise
              budgets), multikey aggregation and threshold CKKS (N-of-N and
              t-of-N, with their mesh variants), and both wires: the native
              PQTC/PQWD serialization and the OpenFHE cereal one.
- ``fl``    : the seven FL tools and the seven threshold tools on files,
              their CLI, and the server's in-memory round in every schedule.
- ``train`` : the GRU, LSTM, MLP and transformer forecasters and their
              Adam trainer, data pipeline and evaluation.
- ``comm``, ``ingest``, ``orchestration``: the artifact server and client,
              the telemetry broker, and the orchestrated FL loop.
- ``parallel``: process meshes and collectives on ``torch.distributed``
              (NCCL on the card, ``gloo`` on the CPU), the client- and
              coefficient-sharded server round, multi-host execution and
              the multi-rank dry run.
- ``runtime``: the native C++ artifact server and Base64 codec (ctypes).
- ``bench``, ``probes``: the twins of the JAX package's root benches and
              of its overlap probe, run on the card.
- ``convert``: numpy ⇄ torch carriers for keys, ciphertexts, params and
              model parameters, so one set of inputs can feed both packages.

Residue convention: ``torch.int64`` tensors holding values < 2^62 (every
modulus is < 2^60). 64-bit constants that exceed 2^63 (Shoup companions,
-q^{-1} mod 2^64) are stored as their two's-complement int64 bit pattern;
numpy ``uint64`` arrays cross over with ``.view(np.int64)``.

A tensor on the CPU runs each kernel's plain torch version; a CUDA tensor
launches the kernel (built with nvcc into ``build/ppqsflhe_tpu_torch/`` at
first use) or raises.
"""

__version__ = "0.1.0"
