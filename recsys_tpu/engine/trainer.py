"""Single-device jitted training engine.

The whole factorization — all ``iters`` GD steps — is one XLA program,
replacing the reference's serial driver (``matFact.c:29-59``) and both
OpenMP drivers at once: intra-device parallelism is XLA's job.

Path selection generalizes the reference's reduce-side heuristic
(``matFact-omp.c:44``) into a per-instance work comparison
(docs/DESIGN.md §2-§4):

* ``dense``   — XLA masked-matmul form, any dtype.
* ``bell``    — degree-sorted bucketed-ELL (ops/bell.py): the sparse
  fast path for every dtype, including exact f64 and the hyper-sparse
  huge-dimension shapes (no scatter program is ever compiled).
* ``coo``     — COO segment reductions (prefix-sum for speed dtypes,
  scatter for f64); kept as an explicit option and as the form the
  sharded/multi-host engine distributes.
* ``host``    — the native serial engine for toy shapes.

Matmul precision has one mapping (``matmul_precision``): float32 means
true f32 products (``Precision.HIGHEST`` — XLA's default on a GPU is
TF32), bfloat16 means f32 factors and accumulation with bf16 operands.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from recsys_tpu.config import ProblemSpec, RunConfig
from recsys_tpu.models.mf import MFState, init_factors
from recsys_tpu.ops.coo import (
    CooData,
    CooSegData,
    coo_gd_step,
    coo_gd_step_cumsum,
    make_coo_inputs,
    make_coo_seg_inputs,
)
from recsys_tpu.ops.bell import (
    BellMeta,
    BellTables,
    bell_gd_step,
    bell_slot_ratio,
    make_bell_inputs,
    pad_factors_for_bell,
)
from recsys_tpu.ops.dense import dense_gd_step, make_dense_inputs
from recsys_tpu.ops.topk import (
    make_mask_blocks,
    make_rated_table,
    top1_blocked,
    top1_rated_blocked,
)
from recsys_tpu.utils.timing import phase

# Dense A + M byte budget before switching to the COO formulation.
DENSE_BUDGET_BYTES = 2 << 30


# Speed-dtype crossover between the dense paths and BELL, in
# dense-cells per padded BELL slot.  Tuned on a TPU on the fixture set
# (inst600-10000, ratio ~22, stayed dense; inst400-50000, ~73, and
# inst50000-5000, ~430, went to BELL); not re-measured on a GPU.
DENSE_BELL_CROSSOVER = 32
# Exact f64: the sparse form pays off almost immediately (tuned on a
# TPU; not re-measured on a GPU).
DENSE_BELL_CROSSOVER_F64 = 2


# Total trajectory work (iters*nnz*k) below which the native sequential
# engine (native/recsys_native.c::rs_serial_gd — the reference's serial
# regime, matFact.c:29-59) beats every device path: toy instances are
# dispatch bound on a device while the native loop runs the whole
# trajectory in microseconds-to-milliseconds.  Applies to every dtype:
# the engine computes f64 — strictly tighter than a requested speed
# dtype — and is bit-identical to the reference binary's trajectory.
HOST_SERIAL_WORK = 50_000_000
# ... provided the one-shot numpy top-1 (B = L R^T) stays trivial too.
HOST_SERIAL_TOP1_FLOPS = 200_000_000


def _host_serial_ok(spec: ProblemSpec) -> bool:
    from recsys_tpu.io import _native

    return (
        spec.iters * spec.nnz * spec.features <= HOST_SERIAL_WORK
        and spec.users * spec.items * spec.features <= HOST_SERIAL_TOP1_FLOPS
        and _native.available()
    )


def matmul_precision(cfg: RunConfig) -> str:
    """The ONE matmul-precision mapping (the dense step, the top-1 and
    the sharded steps all read it): "bf16" — bf16 operands,
    f32 accumulation — for bfloat16; "highest" — true f32/f64 products —
    for everything else."""
    return "bf16" if cfg.dtype == "bfloat16" else "highest"


def factor_dtype(cfg: RunConfig, path: str):
    """Storage dtype of the factors (and dense A/M) on ``path``: bf16 on
    the dense path keeps f32 storage and rounds only matmul operands;
    the sparse paths store their tables in the requested dtype."""
    if cfg.dtype == "bfloat16" and path == "dense":
        return jnp.dtype(jnp.float32)
    return _as_dtype(cfg.dtype)


def choose_path(spec: ProblemSpec, cfg: RunConfig, n_devices: int = 1, allow_host: bool = True) -> str:
    """Select the compute formulation for one device (``n_devices=1``)
    or for the sharded engine (the A/M blocks shard across the mesh, so
    the dense budget scales per device).  The ONE decision function:
    ``parallel/engine`` calls this too (with ``allow_host=False`` — the
    sharded engine has no host-serial branch)."""
    if cfg.path != "auto":
        return cfg.path
    if allow_host and n_devices == 1 and _host_serial_ok(spec):
        return "host"
    itemsize = max(jnp.dtype(cfg.dtype).itemsize, 4)  # bf16 stores A/M in f32
    dense_fits = 2 * spec.users * spec.items * itemsize <= DENSE_BUDGET_BYTES * n_devices
    if spec.nnz == 0:
        # Empty problem: gradients are identically zero; COO's empty
        # tables avoid materializing a users*items A that may not fit.
        return "dense" if dense_fits else "coo"
    # Work comparison: dense touches users*items cells per iteration;
    # BELL touches ~2*nnz padded slots per iteration at gather rate.
    cells = spec.users * spec.items
    slots = 2.0 * spec.nnz * bell_slot_ratio(spec)
    crossover = (
        DENSE_BELL_CROSSOVER_F64 if cfg.dtype == "float64" else DENSE_BELL_CROSSOVER
    )
    if cells > crossover * slots or not dense_fits:
        return "bell"
    return "dense"


@partial(jax.jit, static_argnames=("iters", "precision"), donate_argnums=(0, 1))
def _train_dense(L, R, A, M, alpha2, iters, precision="highest"):
    def body(_, c):
        return dense_gd_step(c[0], c[1], A, M, alpha2, precision)

    return jax.lax.fori_loop(0, iters, body, (L, R))


@partial(jax.jit, static_argnames=("iters", "meta"), donate_argnums=(0, 1))
def _train_bell(L, R, tables: BellTables, alpha2, iters, meta: BellMeta):
    def body(_, c):
        return bell_gd_step(c[0], c[1], tables, alpha2, meta)

    return jax.lax.fori_loop(0, iters, body, (L, R))


@partial(jax.jit, static_argnames=("iters",), donate_argnums=(0, 1))
def _train_coo_cumsum(L, R, data: CooSegData, alpha2, iters):
    def body(_, c):
        return coo_gd_step_cumsum(c[0], c[1], data, alpha2)

    return jax.lax.fori_loop(0, iters, body, (L, R))


@partial(jax.jit, static_argnames=("iters", "users", "items"), donate_argnums=(0, 1))
def _train_coo(L, R, data: CooData, alpha2, iters, users, items):
    def body(_, c):
        return coo_gd_step(c[0], c[1], data, alpha2, users, items)

    return jax.lax.fori_loop(0, iters, body, (L, R))


@partial(jax.jit, static_argnames=("block_items", "precision"))
def _top1(L, R_padded, mask_blocks, block_items, precision="highest"):
    return top1_blocked(L, R_padded, mask_blocks, block_items, precision)


@partial(jax.jit, static_argnames=("block_items", "items_true", "precision"))
def _top1_rated(L, R_padded, rated, block_items, items_true, precision="highest"):
    return top1_rated_blocked(L, R_padded, rated, block_items, items_true, precision)


def coo_use_cumsum(spec: ProblemSpec, cfg: RunConfig) -> bool:
    """Speed dtypes trade the scatter-add segment reduction for the
    prefix-sum form (exact f64 keeps the cancellation-free scatter).
    The prefix form gathers (users + items) boundary rows per step, so
    it only wins when nnz dominates the dimensions; hyper-sparse
    huge-dimension instances (1000x1M with 2k entries) stay on scatter,
    where 2k scattered rows are trivial.  The one rule for both engines
    (factorize, train_memory_analysis and the sharded engine)."""
    return cfg.dtype in ("float32", "bfloat16") and spec.nnz >= spec.users + spec.items


def _as_dtype(name: str):
    dt = jnp.dtype(name)
    if dt == jnp.float64 and not getattr(jax.config, "jax_enable_x64", False):
        raise ValueError(
            "dtype float64 requires x64 mode; set JAX_ENABLE_X64=1 (x64 is "
            "process-wide, so the exact-f64 mode runs in its own process)"
        )
    return dt


def factorize(spec: ProblemSpec, cfg: RunConfig = RunConfig(), state: MFState | None = None) -> MFState:
    """Run the full GD loop on the default device; returns the factors
    at their true shapes (host or device arrays)."""
    path = choose_path(spec, cfg)
    if path == "host":
        return _factorize_host_serial(spec, state)
    if path == "bell":
        return _factorize_bell_device(spec, cfg, state)
    dt = factor_dtype(cfg, path)
    alpha2 = jnp.asarray(2.0 * spec.alpha, dtype=dt)
    with phase("prep"):
        if state is None:
            state = init_factors(spec.users, spec.items, spec.features)
        if path == "dense":
            data = make_dense_inputs(spec, dtype=dt)
        elif path == "coo":
            data = (
                make_coo_seg_inputs(spec, dtype=dt)
                if coo_use_cumsum(spec, cfg)
                else make_coo_inputs(spec, dtype=dt)
            )
        else:
            raise ValueError(f"unknown path {path!r}")
    with phase("upload") as psync:
        L0 = jnp.asarray(state.L, dtype=dt)
        R0 = jnp.asarray(state.R, dtype=dt)
        data = jax.tree.map(jnp.asarray, data)
        psync((L0, R0, data))
    with phase("train") as psync:
        if path == "dense":
            L, R = _train_dense(L0, R0, *data, alpha2, spec.iters, matmul_precision(cfg))
        elif coo_use_cumsum(spec, cfg):
            L, R = _train_coo_cumsum(L0, R0, data, alpha2, spec.iters)
        else:
            L, R = _train_coo(L0, R0, data, alpha2, spec.iters, spec.users, spec.items)
        psync(L)
    return MFState(L=L, R=R)


def _factorize_host_serial(spec: ProblemSpec, state: MFState | None = None) -> MFState:
    """The native sequential trajectory (``rs_serial_gd``): factors come
    back as host float64 arrays, bit-identical to the reference binary's
    (``matFact.c:29-59`` — same operation order, contraction disabled)."""
    from recsys_tpu.io import _native

    if state is None:
        state = init_factors(spec.users, spec.items, spec.features)
    # Explicit copies: rs_serial_gd updates in place and must not mutate
    # a caller-owned state (checkpoint/resume threads states through).
    out = _native.serial_gd(
        spec,
        np.array(state.L, np.float64, order="C"),
        np.array(state.R, np.float64, order="C"),
    )
    if out is None:  # no native toolchain: the numpy oracle is the same math
        from recsys_tpu.engine.oracle import factorize_numpy

        return factorize_numpy(spec, state=state)[0]
    return MFState(L=out[0], R=out[1])


# Above this many glibc draws, the BELL device path generates the
# initial factors ON DEVICE (ops/device_rng.py) instead of a serial
# host init plus a multi-GB upload; the device stream is bit-exact on
# the integer outputs and within ~2 f32 ulp on the scaled values.  Every
# byte-exact-golden instance sits orders of magnitude below this.
DEVICE_INIT_MIN_DRAWS = 200_000_000


def _factorize_bell_device(spec: ProblemSpec, cfg: RunConfig, state: MFState | None = None) -> MFState:
    """BELL training with the result left ON DEVICE in original row
    order (the degree un-permute is a device gather — exact).  Callers
    that need host factors download; ``run()`` feeds the device arrays
    straight into the top-1 so multi-GB factor tables (inst1000-1e6's
    4 GB R) never travel to the host."""
    dt = _as_dtype(cfg.dtype)
    with phase("prep"):
        data = make_bell_inputs(spec, dtype=dt)
    draws = (spec.users + spec.items) * spec.features
    with phase("upload") as psync:
        if (
            state is None
            and draws >= DEVICE_INIT_MIN_DRAWS
            and dt in (jnp.float32, jnp.bfloat16)
        ):
            from recsys_tpu.ops.device_rng import device_init_factors

            L0, R0 = device_init_factors(spec.users, spec.items, spec.features)
            # Degree-permute + append the zero pad row in ONE gather each:
            # index ``size`` is out of range, mode='fill' writes the zero row.
            upad = np.append(data.user_perm, spec.users).astype(np.int32)
            ipad = np.append(data.item_perm, spec.items).astype(np.int32)
            Lp0 = jnp.take(L0.astype(dt), jnp.asarray(upad), axis=0, mode="fill", fill_value=0)
            Rp0 = jnp.take(R0.astype(dt), jnp.asarray(ipad), axis=0, mode="fill", fill_value=0)
            del L0, R0
        else:
            if state is None:
                state = init_factors(spec.users, spec.items, spec.features)
            Lp0, Rp0 = pad_factors_for_bell(state, data, dt)
            Lp0, Rp0 = jnp.asarray(Lp0), jnp.asarray(Rp0)
        tables = jax.tree.map(jnp.asarray, data.tables)
        psync((Lp0, Rp0, tables))
    alpha2 = jnp.asarray(2.0 * spec.alpha, dtype=dt)
    with phase("train") as psync:
        Lp, Rp = _train_bell(Lp0, Rp0, tables, alpha2, spec.iters, data.meta)
        psync(Lp)
    L = jnp.take(Lp, jnp.asarray(data.inv_user_perm), axis=0)
    R = jnp.take(Rp, jnp.asarray(data.inv_item_perm), axis=0)
    return MFState(L=L, R=R)


def train_memory_analysis(spec: ProblemSpec, cfg: RunConfig = RunConfig()):
    """XLA's memory analysis of the auto-selected training program:
    {argument,temp,output,total}_bytes as the compiler reserves them
    (the reference reports peak RSS per instance, report-omp.pdf
    Table 1; SURVEY §6.2).  Returns None for the host-serial path."""
    path = choose_path(spec, cfg)
    if path == "host":
        return None  # native host engine: no device program to analyze
    dt = factor_dtype(cfg, path)

    # Lower from avals only: real arrays (and the glibc factor init —
    # ~1e9 draws at extreme shapes) are never built or uploaded for a
    # statistic; .lower() produces the identical memory analysis.
    def sds(a):
        return jax.ShapeDtypeStruct(a.shape, a.dtype)

    k = spec.features
    L0 = jax.ShapeDtypeStruct((spec.users, k), dt)
    R0 = jax.ShapeDtypeStruct((spec.items, k), dt)
    alpha2 = jax.ShapeDtypeStruct((), dt)
    if path == "bell":
        data = make_bell_inputs(spec, dtype=dt)
        tables = jax.tree.map(sds, data.tables)
        lowered = _train_bell.lower(
            jax.ShapeDtypeStruct((data.meta.user.size + 1, k), dt),
            jax.ShapeDtypeStruct((data.meta.item.size + 1, k), dt),
            tables, alpha2, spec.iters, data.meta,
        )
    elif path == "dense":
        am = jax.ShapeDtypeStruct((spec.users, spec.items), dt)
        lowered = _train_dense.lower(L0, R0, am, am, alpha2, spec.iters, matmul_precision(cfg))
    elif coo_use_cumsum(spec, cfg):
        data = jax.tree.map(sds, make_coo_seg_inputs(spec, dtype=dt))
        lowered = _train_coo_cumsum.lower(L0, R0, data, alpha2, spec.iters)
    else:
        data = jax.tree.map(sds, make_coo_inputs(spec, dtype=dt))
        lowered = _train_coo.lower(
            L0, R0, data, alpha2, spec.iters, spec.users, spec.items
        )
    ma = lowered.compile().memory_analysis()
    if ma is None:
        return None
    out = {
        "argument_bytes": int(ma.argument_size_in_bytes),
        "temp_bytes": int(ma.temp_size_in_bytes),
        "output_bytes": int(ma.output_size_in_bytes),
    }
    out["total_bytes"] = sum(out.values())
    return out


def recommend(state: MFState, spec: ProblemSpec, cfg: RunConfig = RunConfig()) -> np.ndarray:
    """Top-1 unrated item per user (int32[users]), computed blockwise.

    Masking uses the compact rated-items table on device (upload is
    O(nnz), not users×items) unless some user rated most of the item
    space, where the broadcast-compare would cost more than the dense
    mask it avoids."""
    # Cap users*block cells per scanned tile: the masked-argmax body
    # materializes O(users*block) temps, and when XLA unrolls the
    # rated-table fold it fuses them into (P, users, block) buffers —
    # 2 x 6.1 GB at inst50000-5000 shape with block 4096 in x64 mode.
    # Bounding the tile keeps worst-case temps ~100x smaller at the cost
    # of more scan steps (same total FLOPs).
    cap = (16_000_000 // max(spec.users, 1)) // 128 * 128
    block = min(cfg.block_items, -(-spec.items // 128) * 128, max(cap, 128))
    block = max(block, 128)
    # State may arrive as device arrays (the device paths keep
    # factors on device, so the whole pipeline stays device-side and
    # only the int32 indices come back).  Padding happens on device
    # either way — jnp.asarray is a no-op for resident arrays and a
    # single upload for host ones.
    prec = matmul_precision(cfg)
    items_pad = -(-spec.items // block) * block
    R_pad = jnp.pad(jnp.asarray(state.R), ((0, items_pad - spec.items), (0, 0)))
    max_rated = int(np.bincount(spec.rows, minlength=spec.users).max()) if spec.nnz else 0
    if max_rated <= max(spec.items // 8, 128):
        rated = make_rated_table(spec)
        top1 = _top1_rated(
            jnp.asarray(state.L), R_pad, jnp.asarray(rated), block, spec.items, prec
        )
    else:
        mask_blocks = make_mask_blocks(spec, block)
        top1 = _top1(jnp.asarray(state.L), R_pad, jnp.asarray(mask_blocks), block, prec)
    return np.asarray(top1)


def run(spec: ProblemSpec, cfg: RunConfig = RunConfig()) -> tuple[str, "np.ndarray"]:
    """Factorize + recommend; returns (stdout payload, top1 indices)."""
    from recsys_tpu.io.writers import format_recommendations

    if choose_path(spec, cfg) == "host":
        # Whole pipeline native on host, no device dispatch at all: the
        # reference's serial regime (matFact.c:29-59 + print_output,
        # matFact.c:10-27).  Factors are exact f64; the one-shot numpy
        # top-1 keeps the strictly-greater lowest-index tie-break.
        from recsys_tpu.engine.oracle import top1_numpy

        with phase("train"):
            state = _factorize_host_serial(spec)
        with phase("top1"):
            top1 = top1_numpy(np.asarray(state.L), np.asarray(state.R), spec)
        return format_recommendations(top1, spec.rated_counts(), spec.items), top1
    # Device paths keep the factors on device: train -> top-1, and only
    # the int32 indices are downloaded.
    state = factorize(spec, cfg)
    with phase("top1"):
        top1 = recommend(state, spec, cfg)
    return format_recommendations(top1, spec.rated_counts(), spec.items), top1
