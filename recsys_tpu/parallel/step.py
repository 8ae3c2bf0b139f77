"""Sharded training and inference steps (shard_map over the 2-D mesh).

The reference's distributed hot loop (``matFact-mpi.c:155-214``) is:
local gradient accumulation over the rank's COO chunk, then two
overlapped MPI_Iallreduce(SUM) — L-deltas over the grid-row
communicator, R-deltas over the grid-column communicator. Here the
entire iteration loop runs inside one ``shard_map``-ped, jitted
program: per-shard delta computation followed by ``lax.psum`` over the
'i' axis (for ΔL) and the 'u' axis (for ΔR). XLA schedules both
all-reduces (NCCL over NVLink on a GPU host) and overlaps them with
compute; there is no
count-the-base-once dance (``matFact-mpi.c:187-188``) because only the
deltas are summed.

The top-1 pipeline mirrors ``matFact-mpi.c:51-153``: per-shard masked
argmax over the local item block (B is never materialized globally),
then an argmax-with-lowest-index reduction across the items axis —
the reference's custom MPI_Op ``max_cmp`` (``matFact-mpi.c:23-28``)
becomes an all_gather of per-shard (value, index) pairs in ascending
block order + a first-maximum argmax, which preserves the tie-break
because item blocks are contiguous and ascending.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from recsys_tpu.ops.coo import prefix_segment_sums
from recsys_tpu.ops.dense import matmul
from recsys_tpu.parallel.mesh import AXIS_ITEMS, AXIS_USERS


def make_dense_train(mesh, alpha2, iters: int, precision: str = "highest"):
    """Jitted sharded dense trainer: (L, R, A, M) -> (L', R').

    L: (users_pad, k) sharded P('u', None); R: (items_pad, k) P('i', None);
    A, M: (users_pad, items_pad) P('u', 'i').  ``precision`` is the
    engine's matmul precision (``trainer.matmul_precision``).
    """

    def loop(L, R, A, M):
        def body(_, c):
            L, R = c
            E = M * (A - matmul(L, R.T, precision))
            dL = jax.lax.psum(matmul(E, R, precision), AXIS_ITEMS)
            dR = jax.lax.psum(matmul(E.T, L, precision), AXIS_USERS)
            return L + alpha2 * dL, R + alpha2 * dR

        return jax.lax.fori_loop(0, iters, body, (L, R))

    sharded = shard_map(
        loop,
        mesh=mesh,
        in_specs=(P(AXIS_USERS, None), P(AXIS_ITEMS, None), P(AXIS_USERS, AXIS_ITEMS), P(AXIS_USERS, AXIS_ITEMS)),
        out_specs=(P(AXIS_USERS, None), P(AXIS_ITEMS, None)),
    )
    return jax.jit(sharded, donate_argnums=(0, 1))


def make_coo_train(mesh, alpha2, iters: int, u_blk: int, i_blk: int):
    """Jitted sharded COO trainer.

    Entry buckets have shape (pu, pi, cap) sharded P('u','i',None); each
    device sees its (1, 1, cap) bucket with block-local indices.
    """

    def loop(L, R, rows, cols, vals, weight, perm, cols_sorted):
        rows, cols, vals = rows[0, 0], cols[0, 0], vals[0, 0]
        weight, perm, cols_sorted = weight[0, 0], perm[0, 0], cols_sorted[0, 0]

        def body(_, c):
            L, R = c
            l = L[rows]
            r = R[cols]
            err = weight * alpha2 * (vals - jnp.sum(l * r, axis=-1))
            dL = jax.ops.segment_sum(
                err[:, None] * r, rows, num_segments=u_blk, indices_are_sorted=True
            )
            g_r = (err[:, None] * l)[perm]
            dR = jax.ops.segment_sum(
                g_r, cols_sorted, num_segments=i_blk, indices_are_sorted=True
            )
            dL = jax.lax.psum(dL, AXIS_ITEMS)
            dR = jax.lax.psum(dR, AXIS_USERS)
            return L + dL, R + dR

        return jax.lax.fori_loop(0, iters, body, (L, R))

    sharded = shard_map(
        loop,
        mesh=mesh,
        in_specs=(
            P(AXIS_USERS, None),
            P(AXIS_ITEMS, None),
            P(AXIS_USERS, AXIS_ITEMS, None),
            P(AXIS_USERS, AXIS_ITEMS, None),
            P(AXIS_USERS, AXIS_ITEMS, None),
            P(AXIS_USERS, AXIS_ITEMS, None),
            P(AXIS_USERS, AXIS_ITEMS, None),
            P(AXIS_USERS, AXIS_ITEMS, None),
        ),
        out_specs=(P(AXIS_USERS, None), P(AXIS_ITEMS, None)),
    )
    return jax.jit(sharded, donate_argnums=(0, 1))


def make_coo_seg_train(mesh, alpha2, iters: int, u_blk: int, i_blk: int):
    """Jitted sharded scatter-free COO trainer (prefix-sum reduction).

    The sharded analogue of ``coo_gd_step_cumsum``: per-shard segment
    sums computed as cumsum + boundary differences (no scatter-add),
    then the two axis psums. Entry buckets come from
    ``sharding.bucket_coo_seg``; padding entries carry weight 0.
    """

    def loop(L, R, rows, cols, vals, w, rows_cs, cols_cs, vals_cs, w_cs, row_start, col_start):
        rows, cols, vals, w = rows[0, 0], cols[0, 0], vals[0, 0], w[0, 0]
        rows_cs, cols_cs, vals_cs, w_cs = rows_cs[0, 0], cols_cs[0, 0], vals_cs[0, 0], w_cs[0, 0]
        row_start, col_start = row_start[0, 0], col_start[0, 0]

        def body(_, c):
            L, R = c
            l = L[rows]
            r = R[cols]
            err = w * alpha2 * (vals - jnp.sum(l * r, axis=-1))
            dL = prefix_segment_sums(err[:, None] * r, row_start)

            l2 = L[rows_cs]
            r2 = R[cols_cs]
            err2 = w_cs * alpha2 * (vals_cs - jnp.sum(l2 * r2, axis=-1))
            dR = prefix_segment_sums(err2[:, None] * l2, col_start)

            dL = jax.lax.psum(dL, AXIS_ITEMS)
            dR = jax.lax.psum(dR, AXIS_USERS)
            return L + dL, R + dR

        return jax.lax.fori_loop(0, iters, body, (L, R))

    spec3 = P(AXIS_USERS, AXIS_ITEMS, None)
    sharded = shard_map(
        loop,
        mesh=mesh,
        in_specs=(P(AXIS_USERS, None), P(AXIS_ITEMS, None)) + (spec3,) * 10,
        out_specs=(P(AXIS_USERS, None), P(AXIS_ITEMS, None)),
    )
    return jax.jit(sharded, donate_argnums=(0, 1))


def make_bell_train(mesh, alpha2, iters: int, meta):
    """Jitted sharded BELL trainer — the checkerboard form of the
    degree-sorted bucketed-ELL step (``ops/bell.py``), replacing the
    sharded COO forms' scatter/cumsum work with one fused gather-reduce
    per side per shard.

    L: (pu·(u_blk+1), k) P('u', None) — per-block zero row appended;
    R: (pi·(i_blk+1), k) P('i', None); index tables (pu, pi, S)
    P('u','i',None); per-bucket value tables (pu, pi, w, n)
    P('u','i',None,None).  Per shard: partial ΔL/ΔR over local entries
    (each side recomputing the entry error from its own tables), then
    ``psum(ΔL,'i')`` + ``psum(ΔR,'u')`` — the two Iallreduces of
    ``matFact-mpi.c:207-209``.
    """
    from recsys_tpu.ops.bell import _delta_side

    n_ub = len(meta.user.bounds)
    nU, nI = meta.user.n_nz, meta.item.n_nz

    def loop(L, R, ucols, irows, *valts):
        uvals = tuple(v[0, 0] for v in valts[:n_ub])
        ivals = tuple(v[0, 0] for v in valts[n_ub:])
        ucols_l = ucols[0, 0]
        irows_l = irows[0, 0]

        def body(_, c):
            L, R = c
            dL = _delta_side(L, R, ucols_l, uvals, meta.user.bounds, alpha2)
            dR = _delta_side(R, L, irows_l, ivals, meta.item.bounds, alpha2)
            if dL is not None:
                dL = jax.lax.psum(dL, AXIS_ITEMS)
                L = jax.lax.dynamic_update_slice(
                    L, jax.lax.slice_in_dim(L, 0, nU, axis=0) + dL, (0, 0)
                )
            if dR is not None:
                dR = jax.lax.psum(dR, AXIS_USERS)
                R = jax.lax.dynamic_update_slice(
                    R, jax.lax.slice_in_dim(R, 0, nI, axis=0) + dR, (0, 0)
                )
            return L, R

        return jax.lax.fori_loop(0, iters, body, (L, R))

    spec3 = P(AXIS_USERS, AXIS_ITEMS, None)
    spec4 = P(AXIS_USERS, AXIS_ITEMS, None, None)
    n_vt = n_ub + len(meta.item.bounds)
    sharded = shard_map(
        loop,
        mesh=mesh,
        in_specs=(P(AXIS_USERS, None), P(AXIS_ITEMS, None), spec3, spec3)
        + (spec4,) * n_vt,
        out_specs=(P(AXIS_USERS, None), P(AXIS_ITEMS, None)),
    )
    return jax.jit(sharded, donate_argnums=(0, 1))


def make_sharded_top1_rated(mesh, i_blk: int, items_true: int, block: int, precision: str = "highest"):
    """Jitted sharded top-1 with the rated mask as a compact table:
    (L, R, rated) -> int32[users_pad] global item indices.

    ``rated``: int32 (users_pad, P) table of each user's rated item ids
    in GLOBAL item space (-1 pad), sharded P('u', None) — replicated
    along 'i' like L.  Each shard scans its item block in sub-blocks of
    ``block`` comparing global column ids against the table
    (``ops.topk.top1_rated_scan``), so the O(users×items) dense mask of
    :func:`make_sharded_top1` is never built — the sharded analogue of
    the reference's merge-against-the-sorted-entry-list masking
    (``matFact-mpi.c:51-103``), which also never materializes the mask.
    The cross-shard (value, lowest-global-index) reduction is the same
    ordered all_gather.
    """
    from recsys_tpu.ops.topk import top1_rated_scan

    def local(L, R, rated):
        my_i = jax.lax.axis_index(AXIS_ITEMS)
        col0 = my_i * i_blk
        val, gidx = top1_rated_scan(L, R, rated, block, items_true, col0, precision)
        vals_g = jax.lax.all_gather(val, AXIS_ITEMS)  # (pi, u_blk), ascending blocks
        idxs_g = jax.lax.all_gather(gidx, AXIS_ITEMS)
        # First max across ascending contiguous blocks = lowest global index.
        win = jnp.argmax(vals_g, axis=0)
        return jnp.take_along_axis(idxs_g, win[None, :], axis=0)[0]

    sharded = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(AXIS_USERS, None), P(AXIS_ITEMS, None), P(AXIS_USERS, None)),
        out_specs=P(AXIS_USERS),
        # Replicated along 'i' by construction (identical all_gather +
        # argmax on every shard); opt out of the static vma check as in
        # make_sharded_top1.
        check_vma=False,
    )
    return jax.jit(sharded)


def make_sharded_top1(mesh, i_blk: int, precision: str = "highest"):
    """Jitted sharded top-1: (L, R, rated_mask) -> int32[users_pad].

    Per-shard masked argmax over the local item block, then the
    cross-shard (value, lowest-global-index) reduction via ordered
    all_gather along 'i'.
    """

    def local(L, R, mask):
        b = matmul(L, R.T, precision).astype(L.dtype)  # (u_blk, i_blk) on this shard
        b = jnp.where(mask, -jnp.inf, b)
        val = jnp.max(b, axis=1)
        # First maximum within the block = lowest local index.
        idx = jnp.argmax(b, axis=1).astype(jnp.int32)
        my_i = jax.lax.axis_index(AXIS_ITEMS)
        gidx = idx + my_i * i_blk
        vals_g = jax.lax.all_gather(val, AXIS_ITEMS)  # (pi, u_blk), ascending blocks
        idxs_g = jax.lax.all_gather(gidx, AXIS_ITEMS)
        # First max across ascending contiguous blocks = lowest global index.
        win = jnp.argmax(vals_g, axis=0)
        top = jnp.take_along_axis(idxs_g, win[None, :], axis=0)[0]
        return top

    sharded = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(AXIS_USERS, None), P(AXIS_ITEMS, None), P(AXIS_USERS, AXIS_ITEMS)),
        out_specs=P(AXIS_USERS),
        # The result is replicated along 'i' by construction (identical
        # all_gather + argmax on every shard); the static checker can't
        # prove that through axis_index, so opt out.
        check_vma=False,
    )
    return jax.jit(sharded)
