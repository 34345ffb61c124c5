"""The port's host layer: NumPy/SciPy modules and the C kernels of ``csrc/``.

These are copies of the JAX package's jax-free host modules (``field``,
``csr``, ``sputil``, ``native``, ``pivots``, ``elimination``, ``io``,
``fixtures``, ``graphs``, ``utils.logging`` and ``utils.hostmem``) and of
the C sources ``native.py`` builds, kept in the port so that it loads
nothing of ``spasm_tpu``.  The code is the reference's, so the port's pivot choices,
``LU.p`` and ``qinv`` are the reference's.  Where the copies differ:

* ``native.py`` builds ``_host/csrc/*.c`` into
  ``build/spasm_tpu_torch/host/`` under the repository root;
* ``csr.SparseGFp.__truediv__`` reaches the port's ``echelonize.LU`` and
  ``solve.sparse_triangular_solve``.
"""
