"""The JAX package's host layer, loaded without JAX.

``spasm_tpu/__init__.py`` imports jax (it configures jax's compilation
cache), and Python runs a package's ``__init__`` before any of its
submodules, so ``import spasm_tpu.pivots`` would load jax.  The host
modules themselves (NumPy, SciPy and the C kernels of ``csrc/`` loaded by
``native.py``) never import jax at module level.

This package points its ``__path__`` at the ``spasm_tpu/`` directory, so
``spasm_tpu_torch._host.pivots`` loads ``spasm_tpu/pivots.py`` under this
package's name and its relative imports (``.csr``, ``.native``, ...)
resolve here too.  The port thereby shares one copy of the host rounds:
its pivot choices, ``LU.p`` and ``qinv`` are the reference's by
construction.

Only these modules may be imported from here: ``field``, ``csr``,
``sputil``, ``native``, ``pivots``, ``elimination``, ``io``, ``fixtures``,
``utils.logging`` and ``utils.hostmem``.  ``echelonize``, ``solve``,
``ops``, ``parallel``, ``certificate``, ``blocks`` and ``cli`` import jax;
the port has its own ``echelonize`` and ``solve``.
"""

import os as _os

__path__ = [_os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.dirname(
        _os.path.abspath(__file__)))), "spasm_tpu")]
