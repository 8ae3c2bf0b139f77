"""Checkerboard decomposition: padding + COO bucketing for the 2-D mesh.

The reference block-partitions A both ways over an r×c process grid,
replicates each L row-block across its grid row and each R col-block
across its grid column (``matFact-mpi.c:459-515,617-644``), and streams
each rank its COO chunk (``matFact-mpi.c:220-457``). Here the same
layout is three NamedShardings:

    A, M  : P('u', 'i')     (block both ways)
    L     : P('u', None)    (replicated along items axis)
    R     : P('i', None)    (replicated along users axis)

with one deviation forced by XLA's uniform-shard rule: the reference
tolerates unequal BLOCK_SIZE blocks (``mpiutil.h:8-13``); we pad users
and items up to mesh-axis multiples and mask the padding out of updates
and argmax (padded factor rows start at zero, receive zero gradient,
and padded item columns are pre-masked as 'rated').

For the COO path the entries are bucketed host-side by owning shard —
the analogue of the reference's row/column-frontier splitting during
ingest — and each bucket is padded to the global max bucket size with
weight-0 sentinel entries so every device runs the identical program.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from recsys_tpu.config import ProblemSpec


def pad_up(n: int, parts: int) -> int:
    return -(-n // parts) * parts


class CooShards(NamedTuple):
    """Per-shard COO buckets, shape (pu, pi, cap) each; local indices."""

    rows: np.ndarray  # int32, row index local to the u-block
    cols: np.ndarray  # int32, col index local to the i-block
    vals: np.ndarray  # dtype; 0.0 on padding
    weight: np.ndarray  # dtype; 1.0 real, 0.0 padding
    perm: np.ndarray  # int32, within-bucket col-major sort permutation
    cols_sorted: np.ndarray  # int32 == cols[perm] per bucket


def bucket_coo(spec: ProblemSpec, pu: int, pi: int, dtype=np.float32) -> tuple[CooShards, int, int]:
    """Bucket entries by owning (u-block, i-block) shard.

    Returns (shards, u_block, i_block) where the blocks are the padded
    per-shard extents.
    """
    u_blk = pad_up(spec.users, pu) // pu
    i_blk = pad_up(spec.items, pi) // pi
    ou = spec.rows // u_blk
    oi = spec.cols // i_blk
    flat_owner = ou * pi + oi
    order = np.argsort(flat_owner, kind="stable")  # keeps row-major order per bucket
    counts = np.bincount(flat_owner, minlength=pu * pi)
    cap = max(int(counts.max()), 1)

    def padded(arr, fill):
        out = np.full((pu * pi, cap), fill, dtype=arr.dtype)
        srt = arr[order]
        off = 0
        for b in range(pu * pi):
            c = counts[b]
            out[b, :c] = srt[off : off + c]
            off += c
        return out

    rows_l = (spec.rows - ou * u_blk).astype(np.int32)
    cols_l = (spec.cols - oi * i_blk).astype(np.int32)
    rows_b = padded(rows_l, 0)
    cols_b = padded(cols_l, 0)
    vals_b = padded(spec.vals.astype(dtype), 0)
    w_b = padded(np.ones(spec.nnz, dtype=dtype), 0)

    # Within-bucket col-major permutation for the sorted R-side segment_sum
    # (the reference's ownership re-sort, matFact-omp.c:44-48, done once on host).
    perm = np.empty((pu * pi, cap), dtype=np.int32)
    cols_sorted = np.empty((pu * pi, cap), dtype=np.int32)
    for b in range(pu * pi):
        p = np.argsort(cols_b[b], kind="stable").astype(np.int32)
        perm[b] = p
        cols_sorted[b] = cols_b[b][p]

    shape = (pu, pi, cap)
    return (
        CooShards(
            rows=rows_b.reshape(shape),
            cols=cols_b.reshape(shape),
            vals=vals_b.reshape(shape),
            weight=w_b.reshape(shape),
            perm=perm.reshape(shape),
            cols_sorted=cols_sorted.reshape(shape),
        ),
        u_blk,
        i_blk,
    )


class CooSegShards(NamedTuple):
    """Per-shard dual-sorted COO + segment boundaries for the scatter-free
    (prefix-sum) sharded step. All entry arrays (pu, pi, cap); boundary
    arrays (pu, pi, blk+1). Padding entries carry weight 0 and sit at the
    end of each bucket pointing at the last local row/col, preserving the
    non-decreasing segment order the cumsum form requires."""

    rows: np.ndarray  # int32, row-major bucket order, local indices
    cols: np.ndarray
    vals: np.ndarray
    w: np.ndarray
    rows_cs: np.ndarray  # col-major bucket order
    cols_cs: np.ndarray
    vals_cs: np.ndarray
    w_cs: np.ndarray
    row_start: np.ndarray  # int32 (pu, pi, u_blk+1)
    col_start: np.ndarray  # int32 (pu, pi, i_blk+1)


def bucket_coo_seg(spec: ProblemSpec, pu: int, pi: int, dtype=np.float32) -> tuple[CooSegShards, int, int]:
    """Bucket entries by owning shard in both sort orders + boundaries."""
    u_blk = pad_up(spec.users, pu) // pu
    i_blk = pad_up(spec.items, pi) // pi
    ou = spec.rows // u_blk
    oi = spec.cols // i_blk
    owner = ou * pi + oi
    nb = pu * pi
    counts = np.bincount(owner, minlength=nb)
    cap = max(int(counts.max()), 1)
    rows_l = (spec.rows - ou * u_blk).astype(np.int32)
    cols_l = (spec.cols - oi * i_blk).astype(np.int32)

    def bucketize(order_keys, pad_row, pad_col):
        """order_keys: lexsort keys within the global entry set (owner-major)."""
        order = np.lexsort(order_keys + (owner,))
        rows_b = np.full((nb, cap), pad_row, np.int32)
        cols_b = np.full((nb, cap), pad_col, np.int32)
        vals_b = np.zeros((nb, cap), dtype)
        w_b = np.zeros((nb, cap), dtype)
        off = 0
        for b in range(nb):
            c = counts[b]
            sl = order[off : off + c]
            rows_b[b, :c] = rows_l[sl]
            cols_b[b, :c] = cols_l[sl]
            vals_b[b, :c] = spec.vals[sl]
            w_b[b, :c] = 1.0
            off += c
        return rows_b, cols_b, vals_b, w_b

    # Row-major within bucket (global order is already row-major; stable
    # owner sort preserves it) and col-major within bucket.
    rows_r, cols_r, vals_r, w_r = bucketize((spec.cols, spec.rows), u_blk - 1, 0)
    rows_c, cols_c, vals_c, w_c = bucketize((spec.rows, spec.cols), 0, i_blk - 1)

    row_start = np.zeros((nb, u_blk + 1), np.int32)
    col_start = np.zeros((nb, i_blk + 1), np.int32)
    for b in range(nb):
        c = counts[b]
        rc = np.bincount(rows_r[b, :c], minlength=u_blk)
        np.cumsum(rc, out=row_start[b, 1:])
        cc = np.bincount(cols_c[b, :c], minlength=i_blk)
        np.cumsum(cc, out=col_start[b, 1:])

    sh3 = (pu, pi, cap)
    return (
        CooSegShards(
            rows=rows_r.reshape(sh3),
            cols=cols_r.reshape(sh3),
            vals=vals_r.reshape(sh3),
            w=w_r.reshape(sh3),
            rows_cs=rows_c.reshape(sh3),
            cols_cs=cols_c.reshape(sh3),
            vals_cs=vals_c.reshape(sh3),
            w_cs=w_c.reshape(sh3),
            row_start=row_start.reshape(pu, pi, u_blk + 1),
            col_start=col_start.reshape(pu, pi, i_blk + 1),
        ),
        u_blk,
        i_blk,
    )


def pad_factors(L: np.ndarray, R: np.ndarray, pu: int, pi: int):
    """Zero-pad factor tables to mesh-axis multiples (zero rows stay zero:
    no entry references them, so their psum'd gradient is identically 0)."""
    users, k = L.shape
    items, _ = R.shape
    up, ip = pad_up(users, pu), pad_up(items, pi)
    if up != users:
        L = np.concatenate([L, np.zeros((up - users, k), L.dtype)], axis=0)
    if ip != items:
        R = np.concatenate([R, np.zeros((ip - items, k), R.dtype)], axis=0)
    return L, R


def dense_blocks(spec: ProblemSpec, pu: int, pi: int, dtype=np.float32):
    """Dense A and M padded to (pad_up(users,pu), pad_up(items,pi))."""
    up, ip = pad_up(spec.users, pu), pad_up(spec.items, pi)
    a = np.zeros((up, ip), dtype=np.float64)
    a[spec.rows, spec.cols] = spec.vals
    m = np.zeros((up, ip), dtype=np.float64)
    m[spec.rows, spec.cols] = 1.0
    return a.astype(dtype), m.astype(dtype)


def rated_mask_padded(spec: ProblemSpec, pu: int, pi: int, users_pad: int | None = None, items_pad: int | None = None) -> np.ndarray:
    """Bool rated-mask padded like dense_blocks; padded items count as
    rated so they can never win the top-1 (sentinel semantics of
    ``matFact-mpi.c:79-96`` without the sentinel). Explicit pad dims
    override the default pad-to-mesh-multiple (the sharded BELL path
    pads each block by one zero row)."""
    up = users_pad if users_pad is not None else pad_up(spec.users, pu)
    ip = items_pad if items_pad is not None else pad_up(spec.items, pi)
    m = np.zeros((up, ip), dtype=bool)
    m[spec.rows, spec.cols] = True
    m[:, spec.items :] = True
    return m
