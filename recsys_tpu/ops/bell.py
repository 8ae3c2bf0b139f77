"""BELL — degree-sorted bucketed-ELL GD step, the fast sparse path.

The COO formulations (ops/coo.py) pay either a scatter-add behind
``segment_sum`` or — for the scatter-free prefix-sum variant — ~20
log-scan passes over (nnz, k) arrays (docs/DESIGN.md §3).  BELL removes
both:

* **Degree-sorted bucketing.** Users (and, independently, items) are
  permuted by descending entry count and grouped into contiguous
  buckets whose width is the power-of-2 ceiling of the widest member.
  Real data is near-uniform in degree, so total padded slots ≈ nnz
  (inst50000-5000: 175,744 slots vs 175,573 entries, +0.1%) — the
  ELLPACK max-width blowup (5.9x there) is gone.

* **Transposed (w, n) tables.** Per-slot arrays are stored width-major,
  so their minor dimension is the (large) user/item count.  The only
  k-minor arrays are the factor tables themselves and the gathered
  (w, n, k) row sets — and those gathers feed *directly* into
  reductions, so XLA can fuse each gather into its reduction instead of
  materializing the gathered rows (DESIGN.md §3).

* **Two independent ownership passes, no cross-talk.** Each side
  recomputes the entry error from its own tables::

      dL side:  Rg = R[cols]   err = 2α(vals − Σ_k L·Rg)   ΔL = Σ_w err·Rg
      dR side:  Lg = L[rows']  err'= 2α(vals'− Σ_k R·Lg)   ΔR = Σ_q err'·Lg

  which is bit-identical per entry (same ⟨L[u],R[i]⟩ reduction) and
  eliminates the flat-error cross-reference gather of the dual-ELL
  design.  This is the accelerator restatement of the reference's
  ownership-sorted reduction backend (``matFact-omp.c:42-124``): both
  sides reduce over entries they own, sorted so owners are contiguous.

* **Self-masking padding, no valid masks.** Padding slots carry val = 0
  and index a dedicated all-zero factor row (appended at position
  ``users``/``items``), so pred = 0, err = 0, contribution = +0.0.

* **Prefix-only updates.** In degree-sorted order every zero-degree
  row/column sits at the tail; gradients exist only for the leading
  ``n_nz`` rows and are applied with one ``dynamic_update_slice``.  For
  hyper-sparse huge-dimension instances (the reference's cluster runs:
  1000×1,000,000 with 2014 entries, ``report-mpi.pdf`` Table 1) an
  iteration therefore touches O(nnz·k) cells — not O(items·k) — and no
  giant scatter program is ever compiled.

Reference semantics preserved: gradients read the pre-step factors
(``matFact.c:38-39``); full-batch additive accumulation; per-row
accumulation order is entry order (columns ascending).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from recsys_tpu.config import ProblemSpec


class BellSide(NamedTuple):
    """Static metadata for one side's buckets (hashable, shape-defining)."""

    bounds: tuple[tuple[int, int, int], ...]  # (start, stop, width) per bucket
    n_nz: int  # rows with >= 1 entry (all updates land in [0, n_nz))
    size: int  # true dimension (users or items)


class BellMeta(NamedTuple):
    user: BellSide
    item: BellSide
    features: int
    nnz: int
    slots: int  # total padded slots, both sides (the per-k work unit)


class BellTables(NamedTuple):
    """Device-resident tables.  Gather indices are ONE flat array per
    side (concatenation of every bucket's row-major (w_b, n_b) table):
    the whole side is gathered in a single op — many small gathers each
    pay a fixed per-op cost.  Values stay per-bucket (w_b, n_b).  Indices are in
    *permuted* item/user space; padding slots point at the appended zero
    row (index = size)."""

    ucols: jnp.ndarray  # int32 (S_u,): item index per slot, all buckets
    uvals: tuple[jnp.ndarray, ...]  # dtype (w, n): rating (0 = pad)
    irows: jnp.ndarray  # int32 (S_i,): user index per slot, all buckets
    ivals: tuple[jnp.ndarray, ...]  # dtype (q, m)


class BellData(NamedTuple):
    meta: BellMeta
    tables: BellTables
    user_perm: np.ndarray  # original user id at permuted position p
    item_perm: np.ndarray
    inv_user_perm: np.ndarray  # permuted position of original user u
    inv_item_perm: np.ndarray


# Buckets narrower than this merge into the preceding (wider) one: each
# bucket adds a handful of ops to the program, and below ~this many rows
# the padding saved no longer pays for the op overhead.
MIN_BUCKET_ROWS = 64

# Small-side regime: each bucket's fused gather-reduce chain carries a
# fixed per-iteration overhead, which dominates sides whose gathered
# slots are few.  Sides with at most SMALL_SIDE_ENTRIES entries merge
# runs by ROWS until SMALL_MIN_BUCKET_ROWS (never splitting an
# equal-width run) — with a slot-blowup guard for degree-skewed data:
# if the merged structure pads beyond SMALL_SLOT_GUARD x the guarded
# structure's slots, keep the guarded one.  Larger sides keep the
# half-width-guarded bucket structure.  The three constants were tuned
# on a TPU (inst500-500 f64) and have not been re-measured on a GPU.
SMALL_SIDE_ENTRIES = 90_000
SMALL_MIN_BUCKET_ROWS = 128
SMALL_SLOT_GUARD = 1.5


def _guarded_buckets(counts_sorted: np.ndarray, min_rows: int) -> list[tuple[int, int, int]]:
    """Half-width-guarded buckets (the round-3 rule; large sides)."""
    out: list[tuple[int, int, int]] = []
    n = len(counts_sorted)
    start = 0
    while start < n and counts_sorted[start] > 0:
        w = int(counts_sorted[start])
        stop = int(np.searchsorted(-counts_sorted, -w, side="right"))
        # Merge narrow runs in, but never into rows less than half the
        # bucket width — a lone hub row must not pad a long tail.
        while (
            stop - start < min_rows
            and stop < n
            and counts_sorted[stop] * 2 >= w
        ):
            nxt = int(counts_sorted[stop])
            stop = int(np.searchsorted(-counts_sorted, -nxt, side="right"))
        out.append((start, stop, w))  # width = max in bucket (= first)
        start = stop
    return out


def _rows_merged_buckets(counts_sorted: np.ndarray, min_rows: int) -> list[tuple[int, int, int]]:
    """Merge-by-rows buckets (small op-floor-bound sides): absorb runs
    regardless of width until ``min_rows`` rows, continuing past that
    only while rows still match the bucket's own width (so a leading
    wide run is never split)."""
    out: list[tuple[int, int, int]] = []
    n = len(counts_sorted)
    start = 0
    while start < n and counts_sorted[start] > 0:
        w = int(counts_sorted[start])
        stop = start
        while stop < n and counts_sorted[stop] > 0 and (
            stop - start < min_rows or int(counts_sorted[stop]) == w
        ):
            stop += 1
        out.append((start, stop, w))
        start = stop
    return out


def _degree_buckets(counts_sorted: np.ndarray, min_rows: int = MIN_BUCKET_ROWS) -> list[tuple[int, int, int]]:
    """Contiguous (start, stop, width) buckets over a non-increasing
    degree sequence: exact-width buckets with narrow-run merging — the
    probed merge-by-rows rule on small sides (slot-guarded), the
    half-width rule everywhere else (see the regime notes above)."""
    if int(counts_sorted.sum()) <= SMALL_SIDE_ENTRIES:
        merged = _rows_merged_buckets(counts_sorted, SMALL_MIN_BUCKET_ROWS)
        guarded = _guarded_buckets(counts_sorted, min_rows)
        slots = lambda bs: sum(w * (b1 - b0) for (b0, b1, w) in bs)  # noqa: E731
        if slots(merged) <= SMALL_SLOT_GUARD * slots(guarded):
            return merged
        return guarded
    return _guarded_buckets(counts_sorted, min_rows)


def _degree_perm(coords: np.ndarray, dim: int):
    """(perm, inv): stable sort of 0..dim-1 by descending entry count."""
    counts = np.bincount(coords, minlength=dim)
    perm = np.argsort(-counts, kind="stable").astype(np.int32)
    inv = np.empty(dim, np.int32)
    inv[perm] = np.arange(dim, dtype=np.int32)
    return counts, perm, inv


def _side_tables(counts: np.ndarray, perm: np.ndarray, inv: np.ndarray,
                 other_dim: int, own: np.ndarray, other: np.ndarray,
                 vals: np.ndarray, inv_other: np.ndarray, dtype):
    """Build one side's (bounds, n_nz, cols-tables, vals-tables).

    ``own`` are this side's entry coordinates (grouping key), ``other``
    the opposite coordinates (mapped through ``inv_other`` into permuted
    space; padding slots get index ``other_dim``, the zero row).
    """
    dim = len(counts)
    sorted_counts = counts[perm]
    bounds = _degree_buckets(sorted_counts)
    n_nz = bounds[-1][1] if bounds else 0

    # Native single-pass builder (native/recsys_native.c::rs_bell_side):
    # bit-identical tables in O(nnz + slots) — the numpy fallback below
    # pays a stable O(nnz log nnz) sort plus one full-entry scan PER
    # bucket.  Falls back for bf16 tables or a missing toolchain.
    from recsys_tpu.io import _native

    nat = _native.bell_side_tables(
        own, other, vals, inv, inv_other, other_dim, bounds, dtype
    )
    if nat is not None:
        cols_flat, vals_flat = nat
        vals_t, off = [], 0
        for (b0, b1, w) in bounds:
            n = b1 - b0
            vals_t.append(vals_flat[off : off + w * n].reshape(w, n))
            off += w * n
        return tuple(bounds), n_nz, cols_flat, tuple(vals_t)

    # entries sorted by (permuted own, original other-order) — the
    # within-row order stays the file's ascending-column order because
    # the sort below is stable over an already row-major stream.
    own_p = inv[own]
    order = np.argsort(own_p, kind="stable")
    own_s = own_p[order]
    other_s = inv_other[other[order]]
    vals_s = vals[order]
    starts = np.zeros(dim + 1, np.int64)
    np.cumsum(counts[perm], out=starts[1:])
    slot = np.arange(len(own_s), dtype=np.int64) - starts[own_s]

    from recsys_tpu.utils.hostmem import hugepage_empty, hugepage_zeros

    cols_t: list[np.ndarray] = []
    vals_t: list[np.ndarray] = []
    for (b0, b1, w) in bounds:
        nb = b1 - b0
        ct = hugepage_empty((w, nb), np.int32)
        ct[...] = other_dim  # pad -> zero row
        vt = hugepage_zeros((w, nb), dtype)
        sel = (own_s >= b0) & (own_s < b1)
        ct[slot[sel], own_s[sel] - b0] = other_s[sel]
        vt[slot[sel], own_s[sel] - b0] = vals_s[sel].astype(dtype)
        cols_t.append(ct)
        vals_t.append(vt)
    cols_flat = (
        np.concatenate([c.reshape(-1) for c in cols_t])
        if cols_t
        else np.zeros(0, np.int32)
    )
    return tuple(bounds), n_nz, cols_flat, tuple(vals_t)


def make_bell_inputs(spec: ProblemSpec, dtype=np.float32) -> BellData:
    from recsys_tpu.ops.coo import require_row_major

    require_row_major(spec)
    ucounts, uperm, uinv = _degree_perm(spec.rows, spec.users)
    icounts, iperm, iinv = _degree_perm(spec.cols, spec.items)

    ubounds, u_nz, ucols, uvals = _side_tables(
        ucounts, uperm, uinv, spec.items, spec.rows, spec.cols, spec.vals, iinv, dtype
    )
    ibounds, i_nz, irows, ivals = _side_tables(
        icounts, iperm, iinv, spec.users, spec.cols, spec.rows, spec.vals, uinv, dtype
    )
    slots = sum(w * (b1 - b0) for (b0, b1, w) in ubounds)
    slots += sum(w * (b1 - b0) for (b0, b1, w) in ibounds)
    meta = BellMeta(
        user=BellSide(bounds=ubounds, n_nz=u_nz, size=spec.users),
        item=BellSide(bounds=ibounds, n_nz=i_nz, size=spec.items),
        features=spec.features,
        nnz=spec.nnz,
        slots=slots,
    )
    tables = BellTables(ucols=ucols, uvals=uvals, irows=irows, ivals=ivals)
    return BellData(
        meta=meta, tables=tables,
        user_perm=uperm, item_perm=iperm,
        inv_user_perm=uinv, inv_item_perm=iinv,
    )


# id(spec) -> (slots_u, slots_i), evicted by a weakref finalizer when
# the spec dies (ProblemSpec holds ndarrays, so it is weakref-able but
# not hashable).
_side_slots_cache: dict[int, tuple[int, int]] = {}


def bell_side_slots(spec: ProblemSpec) -> tuple[int, int]:
    """(user-side, item-side) padded slot counts of the BELL format —
    the per-iteration gathered-row counts of each side's fused
    gather-reduce (the u-side gathers rows of the R table, the i-side
    rows of the L table).  Cached per live spec: choose_path and the
    roofline model run several times per instance and this costs two
    full sorts of million-entry degree arrays."""
    import weakref

    key = id(spec)
    hit = _side_slots_cache.get(key)
    if hit is not None:
        return hit
    sides = []
    for coords, dim in ((spec.rows, spec.users), (spec.cols, spec.items)):
        counts = np.bincount(coords, minlength=dim)
        sc = np.sort(counts)[::-1]
        sides.append(sum(w * (b1 - b0) for (b0, b1, w) in _degree_buckets(sc)))
    out = (int(sides[0]), int(sides[1]))
    _side_slots_cache[key] = out
    weakref.finalize(spec, _side_slots_cache.pop, key, None)
    return out


def bell_slot_ratio(spec: ProblemSpec) -> float:
    """Padded-slot overhead of the BELL format (1.0 = no padding): the
    degree-bucketed analogue of ``ell_ratios``, used by path selection."""
    if spec.nnz == 0:
        return float("inf")
    su, si = bell_side_slots(spec)
    return (su + si) / (2.0 * spec.nnz)


# A side whose gathered row set exceeds the chunk GRAIN is processed in
# pieces (per bucket, and within a bucket split along n — independent
# output rows).  The grain serves two purposes:
#
# * memory guard: XLA materializes a gather consumed by both the
#   prediction and the gradient (f32[2M,700] staged TWICE at
#   gen-inst1e6 shape -> 11.6 GB of temps) — pieces bound the staged
#   temps.
# * fusion: smaller pieces let XLA fuse each piece's gather into its
#   reductions instead of staging one giant flat gather.
#
# The grain is 64 MB (tuned on a TPU, not re-measured on a GPU) until a
# side's set exceeds 16 pieces,
# then set/16 capped at 512 MB (so the huge-shape programs keep their
# round-2 piece counts and compile times).  Chunking preserves each
# output row's mathematical sum (split along n only: every row's
# reduction lives inside one piece) but XLA may reassociate a reduction
# differently per piece shape — measured <= 2 ulp f64 factor drift
# across budgets, argmax output unchanged (test_chunked_rows_independent);
# every byte-exact golden is re-validated at the shipped grain.
# RECSYS_BELL_CHUNK_BYTES forces a FIXED grain (for experiments).
import os as _os


def _parse_chunk_env(raw: str | None) -> int | None:
    """Validated RECSYS_BELL_CHUNK_BYTES: a positive integer >= 1 MiB
    (below that _delta_bucket degrades toward one piece per output row —
    a huge unrolled HLO), or None when unset.  A malformed value raises
    a clear error instead of crashing every import downstream."""
    if not raw:
        return None
    try:
        v = int(raw)
    except ValueError as e:
        raise ValueError(
            f"RECSYS_BELL_CHUNK_BYTES={raw!r} is not an integer (bytes)"
        ) from e
    if v < (1 << 20):
        raise ValueError(
            f"RECSYS_BELL_CHUNK_BYTES={v} is below the 1 MiB floor "
            "(tiny grains unroll one piece per output row)"
        )
    return v


_CHUNK_ENV = _parse_chunk_env(_os.environ.get("RECSYS_BELL_CHUNK_BYTES"))
CHUNK_BYTES = _CHUNK_ENV if _CHUNK_ENV else (1 << 29)  # max staged piece
CHUNK_GRAIN_BYTES = _CHUNK_ENV if _CHUNK_ENV else (64 << 20)
CHUNK_MAX_PIECES = 16


def _chunk_grain(set_bytes: int) -> int:
    """Piece size for a gathered set of ``set_bytes``: the fuse-friendly
    64 MB grain, growing once a set would exceed CHUNK_MAX_PIECES pieces,
    capped by the 512 MB staging guard."""
    return min(CHUNK_BYTES, max(CHUNK_GRAIN_BYTES, set_bytes // CHUNK_MAX_PIECES))

# The gathered row set is consumed twice (prediction, then gradient);
# a single gather may therefore materialize as a staged temp.
# Re-gathering for the second consumer behind an optimization_barrier
# (so CSE cannot merge the two) *can* let each gather fuse into its own
# reduction with no staged temp; the result computes the same sums from
# the same rows, though XLA may reassociate the w-dim reduction
# differently per variant (last-ulp f32 drift;
# test_regather_variant_equivalent asserts ulp-level factors and
# identical recommendations).  On a TPU the re-gather lost (XLA staged
# both gathers on some shapes), so the default is OFF; it has not been
# measured on a GPU and remains an experiment hook.
# Exact-f64 always keeps the single-gather form: its byte-exact golden
# rows were validated against the reference binary with that HLO, and
# the conformance mode must not trade summation-order risk for speed.
REGATHER_FOR_GRADIENT = False


def _use_regather(dtype) -> bool:
    return REGATHER_FOR_GRADIENT and jnp.dtype(dtype) != jnp.float64


def _regather(F_other, idx_flat):
    return F_other[jax.lax.optimization_barrier(idx_flat)]


# --- exact split-gather for f64 tables -------------------------------
#
# A gather moves f64 rows at a lower row rate than f32 rows on the
# accelerators this was tuned on (a TPU pads any k <= 128 f64 row to a
# 1 KB transaction).  Every finite normal-range f64 is the EXACT sum of
# three f32 values (Dekker-style: hi = f32(x), mid = f32(x - hi),
# lo = f32(x - hi - mid); x - hi has <= 29 significant bits, so
# mid + lo == x - hi exactly and hi + (mid + lo) == x in two exact f64
# adds).  Splitting the opposite-side factor table to an (n, 3k) f32
# table per iteration (O(dims*k) elementwise work, trivial next to
# O(nnz) gathers) therefore moves the SAME rows as f32 rows while the
# gathered VALUES, and hence the whole trajectory, stay bit-identical.
#
# Domain: the three-way split is exact for x = 0 and |x| >= 2**-75
# (~2.6e-23) — below that the lo term (~|x| * 2**-48) underflows f32's
# NORMAL range and flush-to-zero rounds the reconstruction by <= 2**-48
# relative.  GD factors live ~20 orders of magnitude above this; every
# byte-exact conformance golden validates through this path
# (test_bell.py), and SPLIT_GATHER_F64 turns it off for pathological
# data.
#
# Why not a TWO-way (hi, lo) split?  It is not bit-exact: the first
# residual x - f32(x) carries up to 29 significant bits, more than
# f32's 24, so lo loses low bits (counterexample pinned by
# test_split2_is_not_exact) — and bit-exactness is this mode's entire
# contract.
SPLIT_GATHER_F64 = True


def _use_split_gather(dtype, k: int, n_slots: int | None = None) -> bool:
    """Whether a side gathers the 3xf32 split form.  The bands were
    tuned on a TPU and have not been re-measured on a GPU:

    * 3k <= 64 (k <= 21): always — the f32 row-rate win dominates the
      join's per-gathered-element cost.
    * 64 < 3k <= 128 (k 22..42): only when the side's gathered set is
      CHUNKED (exceeds the fuse grain) — each piece's gather then fuses
      into its reductions and the join cost disappears into the fused
      pipeline; unchunked sides lost there.  The chunking test uses the
      UNSPLIT f64 set size: a side only qualifies if it would be
      chunked anyway.
    * 3k > 128: never.

    ``n_slots = None`` (unknown set size) applies only the always band."""
    if not (SPLIT_GATHER_F64 and jnp.dtype(dtype) == jnp.float64):
        return False
    if 3 * k <= 64:
        return True
    if 3 * k > 128 or n_slots is None:
        return False
    f64_set = n_slots * 8 * k  # the flat single-gather set, unsplit
    return f64_set > _chunk_grain(f64_set)


def _split3_f32(X):
    """(n, k) f64 -> (n, 3k) f32 [hi | mid | lo] with hi+mid+lo == X
    elementwise (exact; see SPLIT_GATHER_F64)."""
    hi = X.astype(jnp.float32)
    r1 = X - hi.astype(jnp.float64)
    mid = r1.astype(jnp.float32)
    lo = (r1 - mid.astype(jnp.float64)).astype(jnp.float32)
    return jnp.concatenate([hi, mid, lo], axis=1)


def _join3_f64(G, k: int):
    """(m, 3k) f32 gathered rows -> (m, k) f64, bit-exact: mid + lo is
    exact (non-overlapping <= 29-bit span), then + hi is exact."""
    hi = G[..., :k].astype(jnp.float64)
    mid = G[..., k : 2 * k].astype(jnp.float64)
    lo = G[..., 2 * k :].astype(jnp.float64)
    return hi + (mid + lo)


def _delta_bucket(F_g, fo, idx, vals, alpha2, k, split, grain):
    """(n, k) gradient for one bucket. idx: (w, n) opposite-side row ids,
    vals: (w, n) ratings (0 = padding slot -> zero row -> zero err).
    ``F_g`` is the gather table — the factor table itself, or its 3xf32
    split form when ``split`` (see SPLIT_GATHER_F64); ``grain`` the
    piece budget in staged-temp bytes (see _chunk_grain)."""
    w, n = idx.shape
    # Piece budget in staged-temp bytes: the gathered rows, plus the
    # reconstructed f64 rows when gathering the split form.
    row_bytes = F_g.shape[1] * F_g.dtype.itemsize + (k * 8 if split else 0)
    if w * n * row_bytes <= grain or n == 1:
        g = F_g[idx.reshape(-1)]
        if split:
            g = _join3_f64(g, k)
        g = g.reshape(w, n, k)
        pred = jnp.sum(fo[None, :, :] * g, axis=-1)  # (w, n)
        err = alpha2 * (vals - pred)  # pad: 0 - <f,0> = 0
        # No re-gather here: this helper runs in the CHUNKED regime,
        # where a second staged gather per piece is exactly the memory
        # the chunking exists to bound; the flag applies only in the
        # single-shot regime (_delta_side).
        return jnp.sum(err[:, :, None] * g, axis=0)  # (n, k)
    # Split along n: each column range is an independent set of output
    # rows (chunk count is static; shapes stay static per piece).
    step = max(grain // (w * row_bytes), 1)
    parts = []
    for c0 in range(0, n, step):
        c1 = min(c0 + step, n)
        parts.append(
            _delta_bucket(
                F_g,
                jax.lax.slice_in_dim(fo, c0, c1, axis=0),
                jax.lax.slice_in_dim(idx, c0, c1, axis=1),
                jax.lax.slice_in_dim(vals, c0, c1, axis=1),
                alpha2,
                k,
                split,
                grain,
            )
        )
    return jnp.concatenate(parts, axis=0)


def _delta_side(F_own, F_other, cols_flat, vals_t, bounds, alpha2):
    """One side's gradient: per-bucket fused gather-reduce over views of
    one flat index array — one gather per side BELOW the fuse grain
    (many tiny gathers pay a fixed ~0.13 ms cost), per-bucket/per-piece
    fused gather-reduces above it (see _chunk_grain: pieces both bound
    staged temps and fuse ~20% faster than one giant staged gather).
    Returns the (n_nz, k) gradient for the nonzero-degree prefix.
    """
    if not bounds:
        return None
    k = F_own.shape[1]
    S = cols_flat.shape[0]
    split = _use_split_gather(F_other.dtype, k, S)
    # The split runs once per side per iteration (O(dims*k) elementwise work);
    # every bucket and chunk then gathers from the f32 form.
    F_g = _split3_f32(F_other) if split else F_other
    row_bytes = F_g.shape[1] * F_g.dtype.itemsize + (k * 8 if split else 0)
    grain = _chunk_grain(S * row_bytes)
    parts = []
    off = 0
    g_flat = None
    if S * row_bytes <= grain:
        g_flat = F_g[cols_flat]
        if split:
            g_flat = _join3_f64(g_flat, k)
    g2_flat = (
        _regather(F_other, cols_flat)
        if g_flat is not None and _use_regather(F_other.dtype)
        else None
    )
    for (b0, b1, w), vals in zip(bounds, vals_t):
        n = b1 - b0
        fo = jax.lax.slice_in_dim(F_own, b0, b1, axis=0)  # (n, k)
        if g_flat is not None:
            # Splitting the major dim of (S, k) is layout-free.
            g = jax.lax.slice_in_dim(g_flat, off, off + w * n, axis=0).reshape(w, n, k)
            pred = jnp.sum(fo[None, :, :] * g, axis=-1)  # (w, n)
            err = alpha2 * (vals - pred)  # pad: 0 - <f,0> = 0
            if g2_flat is not None:
                g = jax.lax.slice_in_dim(g2_flat, off, off + w * n, axis=0).reshape(w, n, k)
            parts.append(jnp.sum(err[:, :, None] * g, axis=0))  # (n, k)
        else:
            idx = jax.lax.slice_in_dim(cols_flat, off, off + w * n).reshape(w, n)
            parts.append(_delta_bucket(F_g, fo, idx, vals, alpha2, k, split, grain))
        off += w * n
    return jnp.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]


def bell_gd_step(L, R, tables: BellTables, alpha2, meta: BellMeta):
    """One full-batch GD step in BELL form.

    L: (users+1, k), R: (items+1, k) in *degree-permuted* order with the
    appended all-zero padding row last; returns updated (L, R) with the
    zero rows untouched (no gradient ever addresses them).
    """
    dL = _delta_side(L, R, tables.ucols, tables.uvals, meta.user.bounds, alpha2)
    dR = _delta_side(R, L, tables.irows, tables.ivals, meta.item.bounds, alpha2)
    if dL is not None:
        L = jax.lax.dynamic_update_slice(
            L, jax.lax.slice_in_dim(L, 0, meta.user.n_nz, axis=0) + dL, (0, 0)
        )
    if dR is not None:
        R = jax.lax.dynamic_update_slice(
            R, jax.lax.slice_in_dim(R, 0, meta.item.n_nz, axis=0) + dR, (0, 0)
        )
    return L, R


# ---------------------------------------------------------------------
# Sharded BELL: the checkerboard (2-D mesh) form
# ---------------------------------------------------------------------


class ShardedBellMeta(NamedTuple):
    """Static metadata shared by EVERY shard (shard_map runs one program,
    so bucket shapes must be uniform; per-shard raggedness is absorbed as
    padding slots against the per-block zero row)."""

    user: BellSide  # bounds/n_nz in block-local row space; size = u_blk
    item: BellSide
    features: int
    u_blk: int  # true rows per user block (the block arrays carry +1 zero row)
    i_blk: int
    pu: int
    pi: int


class ShardedBellTables(NamedTuple):
    """Host tables stacked (pu, pi, ...): shard (ub, ib) reads its
    leading [ub, ib] slice under shard_map.  Index tables are flat per
    shard (one gather per side, as single-chip); value tables per
    bucket.  Indices are block-LOCAL with ``blk`` (the appended zero
    row) marking padding slots."""

    ucols: np.ndarray  # int32 (pu, pi, S_u)
    uvals: tuple[np.ndarray, ...]  # dtype (pu, pi, w, n)
    irows: np.ndarray  # int32 (pu, pi, S_i)
    ivals: tuple[np.ndarray, ...]


class ShardedBellData(NamedTuple):
    meta: ShardedBellMeta
    tables: ShardedBellTables
    user_perm: np.ndarray
    item_perm: np.ndarray
    inv_user_perm: np.ndarray
    inv_item_perm: np.ndarray


def _sharded_side_tables(shard, own_local, other_local, vals, own_blk_dim, other_blk_dim, n_shards, dtype):
    """One side's shard-uniform tables.

    ``shard``: owning shard id per entry; ``own_local``/``other_local``:
    block-local coordinates.  Bucket boundaries come from the
    non-increasing envelope of the per-row max-local-degree profile
    across ALL shards, so one static bucket structure fits every shard
    (the raggedness this pads away is the price of the reference's
    uniform-block constraint, mpiutil.h:8-13, in shard_map form).
    """
    key = shard.astype(np.int64) * own_blk_dim + own_local
    d = np.bincount(key, minlength=n_shards * own_blk_dim).reshape(n_shards, own_blk_dim)
    w_need = d.max(axis=0) if len(vals) else np.zeros(own_blk_dim, np.int64)
    env = np.maximum.accumulate(w_need[::-1])[::-1]
    # Always the guarded (round-3) rule here: ``env`` is a per-shard
    # MAX-degree envelope, not an entry-count array, so the small-side
    # merge-by-rows switch (keyed on summed ENTRIES) would misfire —
    # and its padding cost replicates across every shard besides.  The
    # merge-by-rows win was only probed single-chip.
    bounds = _guarded_buckets(env, MIN_BUCKET_ROWS)
    n_nz = bounds[-1][1] if bounds else 0

    order = np.argsort(key, kind="stable")  # keeps file order within a row
    key_s = key[order]
    starts = np.zeros(n_shards * own_blk_dim + 1, np.int64)
    np.cumsum(np.bincount(key_s, minlength=n_shards * own_blk_dim), out=starts[1:])
    slot = np.arange(len(key_s), dtype=np.int64) - starts[key_s]
    own_s = own_local[order]
    shard_s = shard[order]
    other_s = other_local[order]
    vals_s = vals[order]

    from recsys_tpu.utils.hostmem import hugepage_empty, hugepage_zeros

    cols_t: list[np.ndarray] = []
    vals_t: list[np.ndarray] = []
    for (b0, b1, w) in bounds:
        n = b1 - b0
        ct = hugepage_empty((n_shards, w, n), np.int32)
        ct[...] = other_blk_dim  # pad -> zero row
        vt = hugepage_zeros((n_shards, w, n), dtype)
        sel = (own_s >= b0) & (own_s < b1)
        ct[shard_s[sel], slot[sel], own_s[sel] - b0] = other_s[sel]
        vt[shard_s[sel], slot[sel], own_s[sel] - b0] = vals_s[sel].astype(dtype)
        cols_t.append(ct)
        vals_t.append(vt)
    if cols_t:
        flat = np.concatenate([c.reshape(n_shards, -1) for c in cols_t], axis=1)
    else:
        flat = np.zeros((n_shards, 0), np.int32)
    return tuple(bounds), n_nz, flat, tuple(vals_t)


def make_sharded_bell(spec: ProblemSpec, pu: int, pi: int, dtype=np.float32) -> ShardedBellData:
    """Checkerboard BELL: users and items are permuted by GLOBAL degree
    (one ordering every mesh row/column agrees on), the permuted spaces
    are block-partitioned (pu × pi), and each shard gets BELL tables
    over its local entries with shard-uniform static shapes."""
    from recsys_tpu.ops.coo import require_row_major

    require_row_major(spec)
    _, uperm, uinv = _degree_perm(spec.rows, spec.users)
    _, iperm, iinv = _degree_perm(spec.cols, spec.items)
    u_blk = -(-spec.users // pu)
    i_blk = -(-spec.items // pi)
    up = uinv[spec.rows]
    ip = iinv[spec.cols]
    ub = up // u_blk
    ib = ip // i_blk
    shard = (ub * pi + ib).astype(np.int64)
    ul = (up - ub * u_blk).astype(np.int64)
    il = (ip - ib * i_blk).astype(np.int64)
    n_shards = pu * pi

    ubounds, u_nz, ucols, uvals = _sharded_side_tables(
        shard, ul, il, spec.vals, u_blk, i_blk, n_shards, dtype
    )
    ibounds, i_nz, irows, ivals = _sharded_side_tables(
        shard, il, ul, spec.vals, i_blk, u_blk, n_shards, dtype
    )
    meta = ShardedBellMeta(
        user=BellSide(bounds=ubounds, n_nz=u_nz, size=u_blk),
        item=BellSide(bounds=ibounds, n_nz=i_nz, size=i_blk),
        features=spec.features,
        u_blk=u_blk,
        i_blk=i_blk,
        pu=pu,
        pi=pi,
    )
    tables = ShardedBellTables(
        ucols=ucols.reshape(pu, pi, -1),
        uvals=tuple(v.reshape(pu, pi, *v.shape[1:]) for v in uvals),
        irows=irows.reshape(pu, pi, -1),
        ivals=tuple(v.reshape(pu, pi, *v.shape[1:]) for v in ivals),
    )
    return ShardedBellData(
        meta=meta, tables=tables,
        user_perm=uperm, item_perm=iperm,
        inv_user_perm=uinv, inv_item_perm=iinv,
    )


def pad_factors_sharded_bell(state, data: ShardedBellData, dtype):
    """Degree-permute the factors and lay them out block-strided with one
    appended zero row per block (local index ``blk`` — the row every
    padding slot gathers; blocks other than the last have no natural
    zero rows, unlike the single-chip layout)."""
    m = data.meta
    k = state.L.shape[1]

    from recsys_tpu.utils.hostmem import hugepage_zeros

    def lay(F, perm, dim, blocks, blk):
        out = hugepage_zeros((blocks * (blk + 1), k), dtype)
        pos = np.arange(dim)
        out[(pos // blk) * (blk + 1) + pos % blk] = F[perm].astype(dtype)
        return out

    L = lay(state.L, data.user_perm, len(data.user_perm), m.pu, m.u_blk)
    R = lay(state.R, data.item_perm, len(data.item_perm), m.pi, m.i_blk)
    return L, R


def unpermute_factors_sharded(L, R, data: ShardedBellData):
    """Back to original row order, dropping per-block zero rows and the
    block padding.  Host-side (single-process use; multi-process callers
    need the device-side index map below — ``np.asarray`` on a
    non-fully-addressable global array raises)."""
    m = data.meta
    L = np.asarray(L)
    R = np.asarray(R)

    def unlay(F, inv, dim, blk):
        pos = np.arange(dim)
        return F[(pos // blk) * (blk + 1) + pos % blk][inv]

    return (
        unlay(L, data.inv_user_perm, len(data.user_perm), m.u_blk),
        unlay(R, data.inv_item_perm, len(data.item_perm), m.i_blk),
    )


def sharded_lay_index(perm: np.ndarray, blk: int, blocks: int) -> np.ndarray:
    """int32 (blocks*(blk+1),) device gather map building the
    block-strided degree-permuted factor layout (per-block zero row at
    local index ``blk``) from factors in ORIGINAL row order: the device
    form of ``pad_factors_sharded_bell.lay``.  Zero rows and block
    padding read index ``dim`` (out of range -> mode='fill' zeros)."""
    dim = len(perm)
    idx = np.full(blocks * (blk + 1), dim, np.int64)
    pos = np.arange(dim, dtype=np.int64)
    p = perm.astype(np.int64)
    # permuted position pos holds original row perm[pos]
    out_pos = (pos // blk) * (blk + 1) + pos % blk
    idx[out_pos] = p
    return idx.astype(np.int32)


def sharded_unpermute_index(inv_perm: np.ndarray, blk: int, dim_pad: int) -> np.ndarray:
    """int32 (dim_pad,) device gather map: row ``r`` of the standard
    padded ``P(axis, None)`` factor layout <- block-strided permuted
    position of original row ``r`` (padding rows read a per-block zero
    row, keeping the self-masking-padding invariant)."""
    dim = len(inv_perm)
    idx = np.full(dim_pad, blk, np.int64)  # default: block 0's zero row
    p = inv_perm.astype(np.int64)
    idx[:dim] = (p // blk) * (blk + 1) + p % blk
    return idx.astype(np.int32)


def pad_factors_for_bell(state, data: BellData, dtype):
    """Host-side: permute the serial-draw-order factors into degree
    order and append the zero padding row each side's gathers use.
    THP-backed staging + chunked permute-cast: at 1M-dimension shapes a
    plain fancy-index would stage GBs through cold 4 KB pages."""
    from recsys_tpu.utils.hostmem import hugepage_zeros, take_cast

    k = state.L.shape[1]
    L = hugepage_zeros((data.meta.user.size + 1, k), dtype)
    take_cast(state.L, data.user_perm, L[:-1])
    R = hugepage_zeros((data.meta.item.size + 1, k), dtype)
    take_cast(state.R, data.item_perm, R[:-1])
    return L, R


def unpermute_factors(L, R, data: BellData):
    """Back to original row order, dropping the padding rows."""
    return (
        np.asarray(L)[:-1][data.inv_user_perm],
        np.asarray(R)[:-1][data.inv_item_perm],
    )
