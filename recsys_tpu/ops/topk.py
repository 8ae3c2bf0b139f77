"""Top-1 recommendation: masked argmax without materializing B.

The reference's serial path materializes the full dense B = L·Rᵀ
(``matFact.c:55``) and scans it (``matFact.c:10-27``); its MPI path
computes dots on the fly precisely because B never fits at scale
(``matFact-mpi.c:51-103``). Here the streaming form is the only form:
a ``lax.scan`` over item blocks keeps a running (best value, best index)
per user, reconstructing one (users × block) tile of B per step. Tie-break matches the reference's strictly-greater scan: a new
block value must *exceed* the incumbent, and within a block
``jnp.argmax`` picks the first maximum — so the lowest item index wins.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from recsys_tpu.config import ProblemSpec
from recsys_tpu.ops.dense import matmul


def top1_blocked(L, R, mask_blocks, block_items: int, precision: str = "highest"):
    """Masked top-1 item per user.

    ``mask_blocks``: bool[(num_blocks, users, block_items)] — True where
    rated (those entries are excluded). Items padded beyond the true
    count must be masked True by the caller.

    Returns int32[users] winning item indices.
    """
    users = L.shape[0]
    neg = jnp.array(-jnp.inf, dtype=L.dtype)
    num_blocks = mask_blocks.shape[0]
    R_blocks = R.reshape(num_blocks, block_items, R.shape[1])

    def body(carry, inp):
        best_val, best_idx = carry
        blk_idx, r_blk, mask = inp
        b = matmul(L, r_blk.T, precision).astype(L.dtype)  # (users, block_items)
        b = jnp.where(mask, neg, b)
        val = jnp.max(b, axis=1)
        idx = jnp.argmax(b, axis=1).astype(jnp.int32) + blk_idx * block_items
        take = val > best_val  # strictly greater: incumbent (lower index) wins ties
        return (jnp.where(take, val, best_val), jnp.where(take, idx, best_idx)), None

    init = (jnp.full((users,), neg, dtype=L.dtype), jnp.zeros((users,), jnp.int32))
    (best_val, best_idx), _ = jax.lax.scan(
        body, init, (jnp.arange(num_blocks, dtype=jnp.int32), R_blocks, mask_blocks)
    )
    return best_idx


def top1_rated_scan(L, R, rated, block_items: int, items_true: int, col0=0, precision: str = "highest"):
    """(best value, best GLOBAL item index) of the masked top-1 with the
    mask held as a compact rated-items table.

    ``rated``: int32[users, P] — each user's rated item indices in
    GLOBAL item space, padded with -1.  The dense users×items mask is
    never built (for inst50000-5000 it is a 250 MB host array); instead each scanned block compares its item indices
    against the table on device, fused into the masked argmax.

    ``col0`` is the global item id of R's row 0 — the sharded top-1
    passes each shard's block offset (``matFact-mpi.c:51-103``'s
    column-communicator coordinates) so every shard masks against the
    one global table.  R may have any row count; rows are padded to a
    block multiple internally and both the artificial pad rows and the
    global tail (``col0 + row >= items_true``) are masked.

    Returns (L.dtype[users] best values, int32[users] global indices);
    a user with everything masked keeps (-inf, col0).
    """
    users = L.shape[0]
    neg = jnp.array(-jnp.inf, dtype=L.dtype)
    rows = R.shape[0]
    num_blocks = -(-rows // block_items)
    rows_pad = num_blocks * block_items
    if rows_pad != rows:
        R = jnp.pad(R, ((0, rows_pad - rows), (0, 0)))
    R_blocks = R.reshape(num_blocks, block_items, R.shape[1])
    col0 = jnp.asarray(col0, jnp.int32)

    def body(carry, inp):
        best_val, best_idx = carry
        blk_idx, r_blk = inp
        b = matmul(L, r_blk.T, precision).astype(L.dtype)  # (users, block_items)
        lcol = jax.lax.broadcasted_iota(jnp.int32, (users, block_items), 1)
        lcol = lcol + blk_idx * block_items
        gcol = lcol + col0

        # Accumulate the rated mask one table column at a time: a single
        # (users, P, block) broadcast-compare tempts XLA into
        # materializing a users*P*block temp (observed 6 GB at
        # inst50000-5000 scale in x64 mode); the loop keeps every
        # intermediate at (users, block).
        def fold(j, acc):
            cj = jax.lax.dynamic_slice_in_dim(rated, j, 1, axis=1)  # (users, 1)
            return acc | (cj == gcol)

        is_rated = jax.lax.fori_loop(
            0, rated.shape[1], fold, jnp.zeros((users, block_items), bool)
        )
        b = jnp.where(is_rated | (lcol >= rows) | (gcol >= items_true), neg, b)
        val = jnp.max(b, axis=1)
        idx = jnp.argmax(b, axis=1).astype(jnp.int32) + blk_idx * block_items + col0
        take = val > best_val  # strictly greater: incumbent (lower index) wins ties
        return (jnp.where(take, val, best_val), jnp.where(take, idx, best_idx)), None

    init = (
        jnp.full((users,), neg, dtype=L.dtype),
        jnp.full((users,), col0, jnp.int32),
    )
    (best_val, best_idx), _ = jax.lax.scan(
        body, init, (jnp.arange(num_blocks, dtype=jnp.int32), R_blocks)
    )
    return best_val, best_idx


def top1_rated_blocked(L, R, rated, block_items: int, items_true: int, precision: str = "highest"):
    """Single-chip rated-table masked top-1: int32[users] item indices
    (see :func:`top1_rated_scan`).  Falls back to :func:`top1_blocked`
    via the caller when P is a large fraction of the item count."""
    return top1_rated_scan(L, R, rated, block_items, items_true, precision=precision)[1]


def make_rated_table(spec: ProblemSpec) -> np.ndarray:
    """int32[users, P] table of each user's rated item indices, -1 pad
    (P = max rated count, min 1).  nnz·~P bytes instead of users×items."""
    counts = np.bincount(spec.rows, minlength=spec.users)
    P = max(int(counts.max()) if counts.size else 0, 1)
    start = np.zeros(spec.users + 1, np.int64)
    np.cumsum(counts, out=start[1:])
    # Group per user without assuming row-major entry order (the stable
    # sort is a no-op for sorted input): an unsorted spec would otherwise
    # produce negative slots that wrap via fancy indexing and silently
    # mask the wrong items.
    order = np.argsort(spec.rows, kind="stable")
    rows_s = spec.rows[order]
    slot = np.arange(spec.nnz, dtype=np.int64) - start[rows_s]
    table = np.full((spec.users, P), -1, np.int32)
    table[rows_s, slot] = spec.cols[order]
    return table


def make_mask_blocks(spec: ProblemSpec, block_items: int) -> np.ndarray:
    """Host-side rated-mask, padded along items to a block multiple and
    reshaped to (num_blocks, users, block_items). Padding is masked True."""
    items_pad = -(-spec.items // block_items) * block_items
    m = np.zeros((spec.users, items_pad), dtype=bool)
    m[spec.rows, spec.cols] = True
    m[:, spec.items :] = True
    return np.ascontiguousarray(
        m.reshape(spec.users, items_pad // block_items, block_items).transpose(1, 0, 2)
    )


