"""Test configuration: force JAX onto 8 virtual CPU devices.

The platform is set through jax.config before any device is touched, so
the tests run on the CPU even on a machine with a GPU.  All tests run on a
virtual 8-device CPU mesh (the stand-in for a multi-device host; SURVEY.md
§4.3) with float64 enabled for ground-truth comparisons.  Tests that need
the GPU carry the ``gpu`` marker and run the program in a child process
(tests/test_chip_smoke.py).
"""
import os
import sys

# Repo root on sys.path so `import cgx` works without installation.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Cap the CPU codegen ISA below FMA3.  XLA:CPU duplicates cheap multiplies
# into consumer fusions and LLVM then contracts mul+add/sub pairs into FMAs
# — an inconsistent re-rounding of the SAME product that silently destroys
# error-free transformations (two_sum/two_prod, cgx.ops.df64).  (The GPU
# backend keeps them exact: chip_smoke.py phase C checks it.)  Graph-level
# guards (optimization_barrier, bitcast roundtrips) are erased
# by the algebraic simplifier before fusion, and no fast-math flag disables
# the contraction — capping the ISA is the one reliable off switch.  All
# arithmetic stays IEEE; FMA-less is the strictly-safer configuration.
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_cpu_max_isa=AVX").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)
# The CLI points the persistent compilation cache at <checkout>/.cache/jax;
# tests compile small shapes and write no cache.
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def random_spd_csr(n, density=0.05, rng=None, dtype=np.float64):
    """Random sparse SPD matrix: A = B Bᵀ + n·I (host scipy)."""
    import scipy.sparse as sp
    rng = rng or np.random.default_rng(0)
    b = sp.random(n, n, density=density, random_state=np.random.RandomState(
        rng.integers(2**31)), dtype=dtype)
    a = (b @ b.T).tocsr()
    a = a + sp.identity(n, dtype=dtype, format="csr") * n
    a.sort_indices()
    return a


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Free JAX/Pallas compilation caches at module boundaries.

    A full single-process run of the suite accumulates jit caches across
    ~330 tests (several GB RSS)
    and degrades late modules far beyond their standalone times
    (measured: the 16-file session exceeded 55 min while the per-file
    sum is ~16 min; the 3 heaviest files together show no slowdown).
    Clearing per MODULE keeps intra-file sharing (the expensive shard_map
    solvers are reused within a file) while bounding the session state.
    """
    yield
    import jax as _jax

    _jax.clear_caches()
