"""COO gather + sorted-segment-sum GD step — the sparse/huge path.

For instances whose dense A would not fit in HBM (the reference ran
1000×1,000,000 and 1,000,000×100 on its cluster), the update works on
the COO entries directly, like the reference's hot loop — but instead
of scalar scatter-adds guarded by atomics (``matFact-omp.c:97-107``) or
per-thread partial matrices (``matFact-omp.c:60-122``), it uses sorted
``segment_sum``s, which XLA lowers to vectorized reductions.

Ownership-ordering insight carried over from the reference: its OMP
backend re-sorts entries column-major when reducing L so conflicting
updates are adjacent (``matFact-omp.c:44-48``). Here *both* sides get
sorted ownership for free: entries arrive row-sorted (format invariant)
for the L segment-sum, and a host-precomputed permutation re-sorts the
per-entry R gradients column-major for the R segment-sum, so both calls
run with ``indices_are_sorted=True``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from recsys_tpu.config import ProblemSpec


def require_row_major(spec: ProblemSpec) -> None:
    """Validate the format invariant every sparse builder relies on:
    entries strictly increasing in (row, col) — i.e. row-major sorted
    with no duplicate cells.  Unsorted-but-parseable input would
    otherwise build corrupt tables (negative slot indices wrapping via
    fancy indexing) and train silently wrong."""
    key = spec.rows.astype(np.int64) * spec.items + spec.cols
    if key.size > 1 and not bool(np.all(np.diff(key) > 0)):
        raise ValueError(
            "entries must be row-major sorted with unique (row, col) cells "
            "(the .in format invariant, reference util.c:29-34)"
        )


class CooData(NamedTuple):
    """Device-resident COO training data (all equal-length nnz arrays)."""

    rows: jnp.ndarray  # int32[nnz], non-decreasing
    cols: jnp.ndarray  # int32[nnz]
    vals: jnp.ndarray  # dtype[nnz]
    perm: jnp.ndarray  # int32[nnz], argsort by (col, row)
    cols_sorted: jnp.ndarray  # int32[nnz] == cols[perm], non-decreasing


def make_coo_inputs(spec: ProblemSpec, dtype=jnp.float32) -> CooData:
    require_row_major(spec)  # indices_are_sorted=True below depends on it
    perm = np.lexsort((spec.rows, spec.cols)).astype(np.int32)
    return CooData(
        rows=spec.rows.astype(np.int32),
        cols=spec.cols.astype(np.int32),
        vals=spec.vals.astype(dtype),
        perm=perm,
        cols_sorted=spec.cols[perm].astype(np.int32),
    )


class CooSegData(NamedTuple):
    """COO arrays in both sort orders + segment boundaries (cumsum path)."""

    rows: jnp.ndarray  # int32[nnz] row-major
    cols: jnp.ndarray
    vals: jnp.ndarray
    rows_cs: jnp.ndarray  # int32[nnz] col-major order
    cols_cs: jnp.ndarray
    vals_cs: jnp.ndarray
    row_start: jnp.ndarray  # int32[users+1] entry offsets per row
    col_start: jnp.ndarray  # int32[items+1] entry offsets per column


def make_coo_seg_inputs(spec: ProblemSpec, dtype=np.float32) -> CooSegData:
    require_row_major(spec)  # segment boundaries assume sorted entries
    perm = np.lexsort((spec.rows, spec.cols))
    rc = np.bincount(spec.rows, minlength=spec.users)
    cc = np.bincount(spec.cols, minlength=spec.items)
    row_start = np.zeros(spec.users + 1, dtype=np.int32)
    np.cumsum(rc, out=row_start[1:])
    col_start = np.zeros(spec.items + 1, dtype=np.int32)
    np.cumsum(cc, out=col_start[1:])
    return CooSegData(
        rows=spec.rows.astype(np.int32),
        cols=spec.cols.astype(np.int32),
        vals=spec.vals.astype(dtype),
        rows_cs=spec.rows[perm].astype(np.int32),
        cols_cs=spec.cols[perm].astype(np.int32),
        vals_cs=spec.vals[perm].astype(dtype),
        row_start=row_start,
        col_start=col_start,
    )


def prefix_segment_sums(g, start):
    """Sums of the segment-sorted rows of ``g`` (segment s is rows
    start[s]:start[s+1]) as differences of one prefix sum, accumulated in
    at least f32 — a bf16 running sum over thousands of rows would keep
    nothing of the small terms."""
    acc = jnp.promote_types(g.dtype, jnp.float32)
    S = jnp.concatenate([jnp.zeros((1, g.shape[1]), acc), jnp.cumsum(g, axis=0, dtype=acc)])
    return (S[start[1:]] - S[start[:-1]]).astype(g.dtype)


def coo_gd_step_cumsum(L, R, data: CooSegData, alpha2):
    """Scatter-free COO step: prefix-sum + boundary-difference reduction.

    ``segment_sum`` lowers to a scatter-add — the accelerator form of
    the reference's write-contention problem (``matFact-omp.c:85-107``),
    and on a GPU an atomic one.  Entries are segment-sorted on
    both sides (row-major and col-major copies), so each segment sum
    equals a difference of two prefix-sum rows::

        S = [0; cumsum(g)]            # (nnz+1, k), dense scan
        Δ[s] = S[start[s+1]] - S[start[s]]

    which trades the nnz-row scatter for an (n_segments)-row gather.
    Cost: O(eps·√nnz) cancellation noise in the differences — fine for
    the f32/bf16 speed modes, not used for exact-f64 conformance.
    """
    r = R[data.cols]
    l = L[data.rows]
    err = alpha2 * (data.vals - jnp.sum(l * r, axis=-1))
    g = err[:, None] * r
    dL = prefix_segment_sums(g, data.row_start)

    l2 = L[data.rows_cs]
    r2 = R[data.cols_cs]
    err2 = alpha2 * (data.vals_cs - jnp.sum(l2 * r2, axis=-1))
    g2 = err2[:, None] * l2
    dR = prefix_segment_sums(g2, data.col_start)
    return L + dL, R + dR


def coo_gd_step(L, R, data: CooData, alpha2, users: int, items: int):
    """One full-batch GD step from COO entries.

    err_n = 2α (a_n − ⟨L[i_n], R[j_n]⟩);  ΔL = Σ_n err_n · R[j_n] into row i_n;
    ΔR likewise. Gradients read the pre-step factors (stable snapshot
    semantics, ``matFact.c:38-39``).
    """
    l = L[data.rows]  # (nnz, k) gather
    r = R[data.cols]
    err = alpha2 * (data.vals - jnp.sum(l * r, axis=-1))
    dL = jax.ops.segment_sum(
        err[:, None] * r, data.rows, num_segments=users, indices_are_sorted=True
    )
    g_r = (err[:, None] * l)[data.perm]
    dR = jax.ops.segment_sum(
        g_r, data.cols_sorted, num_segments=items, indices_are_sorted=True
    )
    return L + dL, R + dR
