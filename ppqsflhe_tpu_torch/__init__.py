"""ppqsflhe_tpu_torch — the PyTorch + CUDA port of ``ppqsflhe_tpu``.

The JAX package stays the reference; every module here mirrors one of its
modules under the same name, and each is held bit for bit against it by the
``tests/test_torch_*.py`` suite. This package imports ``torch`` and never
``jax``.

- ``core``  : int64 twins of the RNS modular arithmetic, prime/NTT tables,
              HPS base extension constants, samplers on ``torch.Generator``.
- ``ops``   : the digit-matmul NTT tables and plain transforms (the TPU
              method, kept as the reference), the butterfly stages that
              run the same transforms on the card (fused, and the streamed
              two-stage pair) with their plain torch versions, the four-step
              evaluation order, and the wrappers of the hand-written CUDA
              kernels (``csrc/``): the NTT stages, the HPS base extension
              and the key-switch-key inner product.
- ``ckks``  : the RNS-CKKS subset the server's aggregation round and the
              rotation path need — params/context, keygen, PRE rekey,
              relinearization and Galois key generation, encrypt,
              decrypt, add, mult_scalar, ct×ct mult, rescale, hybrid key
              switching, rotations (plain, hoisted, rotation sums),
              conjugation and the packed inner product.
- ``fl``    : the in-memory halves of the server's two tools
              (changeCipherDomain, aggregateEncryptedWeights) and the
              composed server round.
- ``convert``: numpy ⇄ torch carriers for keys, ciphertexts and params, so
              one set of inputs can feed both packages.

Residue convention: ``torch.int64`` tensors holding values < 2^62 (every
modulus is < 2^60). 64-bit constants that exceed 2^63 (Shoup companions,
-q^{-1} mod 2^64) are stored as their two's-complement int64 bit pattern;
numpy ``uint64`` arrays cross over with ``.view(np.int64)``.

A tensor on the CPU runs each kernel's plain torch version; a CUDA tensor
launches the kernel (built with nvcc into ``build/ppqsflhe_tpu_torch/`` at
first use) or raises.
"""

__version__ = "0.1.0"
