"""Dense masked-matmul GD step — the plain XLA path.

The reference's hot loop (``matFact.c:41-53``) is a scalar gather /
rank-1-update / scatter over COO entries; every one of its parallel
backends (OMP atomics ``matFact-omp.c:85-107``, per-thread partials
``matFact-omp.c:60-122``, MPI delta-allreduce ``matFact-mpi.c:155-214``)
is machinery to parallelize that scalar loop safely.  On an accelerator
the same full-batch update is expressed directly as three matmuls::

    E  = M ⊙ (A − L Rᵀ)          # (users × items), masked error
    L' = L + 2α · E R
    R' = R + 2α · Eᵀ L

which XLA hands to the GEMM libraries with no atomics, no reduction
trees, and no data-dependent control flow.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from recsys_tpu.config import ProblemSpec


def make_dense_inputs(spec: ProblemSpec, dtype=jnp.float32):
    """Host-side dense A (ratings, 0 elsewhere) and mask M in ``dtype``."""
    from recsys_tpu.utils.hostmem import hugepage_zeros

    dtype = jnp.dtype(dtype)
    a = hugepage_zeros((spec.users, spec.items), dtype)
    a[spec.rows, spec.cols] = spec.vals
    m = hugepage_zeros((spec.users, spec.items), dtype)
    m[spec.rows, spec.cols] = 1.0
    return a, m


def matmul(a, b, precision: str = "highest"):
    """``a @ b`` at the engine's matmul precision: "highest" is a true
    f32/f64 product (XLA's default for f32 on a GPU is TF32, about
    three decimal digits), "bf16" rounds the operands to bf16 and
    accumulates in f32."""
    if precision == "bf16":
        return jnp.matmul(
            a.astype(jnp.bfloat16), b.astype(jnp.bfloat16),
            preferred_element_type=jnp.float32,
        )
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def dense_gd_step(L, R, A, M, alpha2, precision: str = "highest"):
    """One GD step; ``alpha2 = 2 * alpha`` folded on host.

    Note R' reads the *old* L (the reference snapshots both factors
    before the entry loop, ``matFact.c:38-39``).
    """
    E = M * (A - matmul(L, R.T, precision))
    L_new = L + alpha2 * matmul(E, R, precision)
    R_new = R + alpha2 * matmul(E.T, L, precision)
    return L_new, R_new
