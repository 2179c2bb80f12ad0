"""NTT tables and plain transforms, and the wrappers of the CUDA kernels."""
