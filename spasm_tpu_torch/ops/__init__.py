"""Tensor code of the port: GF(p) elementwise ops, the exact matmul, the
dense elimination, and the wrappers of the CUDA kernels."""
