"""Tensor code of the port: GF(p) elementwise ops, the exact matmul, the
dense elimination, the device sparse Schur update, the SpMV, and the
wrappers of the CUDA kernels."""
