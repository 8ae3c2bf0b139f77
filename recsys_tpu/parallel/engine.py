"""Multi-device end-to-end engine: ingest → shard → train → top-1.

The distributed analogue of the reference MPI driver main
(``matFact-mpi.c:517-679``), minus everything the sharding model makes
unnecessary: no derived wire datatypes, no streamed sends, no
count-base-once allreduce bookkeeping, no Gatherv — factors are
generated once on host in the serial RNG order (determinism contract,
§0 of SURVEY), device_put with NamedShardings, and the result is
fetched with ordinary array indexing.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from recsys_tpu.config import ProblemSpec, RunConfig
from recsys_tpu.models.mf import MFState, init_factors
from recsys_tpu.parallel import sharding as shp
from recsys_tpu.parallel.mesh import AXIS_ITEMS, AXIS_USERS, make_mesh
from recsys_tpu.parallel.step import (
    make_coo_seg_train,
    make_coo_train,
    make_dense_train,
    make_sharded_top1,
)

def _choose_path(spec: ProblemSpec, cfg: RunConfig, n_devices: int) -> str:
    """The single-device ``trainer.choose_path`` cost model with the
    dense budget scaled per-device (the A/M blocks shard across the
    mesh).  One decision function for both engines."""
    from recsys_tpu.engine.trainer import choose_path

    return choose_path(spec, cfg, n_devices=n_devices, allow_host=False)


def factorize_sharded(
    spec: ProblemSpec,
    cfg: RunConfig = RunConfig(),
    state: MFState | None = None,
    mesh=None,
    putter=None,
) -> tuple[MFState, "jax.sharding.Mesh"]:
    """Train over the 2-D mesh; returns (padded sharded factors, mesh).

    ``putter(global_np, sharding)`` places a host array onto the mesh;
    the default ``jax.device_put`` covers the single-process case, and
    the multi-host layer passes a per-process block uploader so every
    path here — dense, BELL and both COO forms — works unchanged across
    processes (the reference needed ~330 lines of streamed sends for the
    same routing, ``matFact-mpi.c:220-457``).
    """
    from recsys_tpu.engine.trainer import coo_use_cumsum, factor_dtype, matmul_precision

    if putter is None:
        putter = jax.device_put
    if mesh is None:
        mesh = make_mesh(spec.users, spec.items, shape=cfg.mesh_shape)
    pu, pi = mesh.devices.shape

    path = _choose_path(spec, cfg, pu * pi)
    if path == "bell" and spec.nnz:
        return _factorize_sharded_bell(spec, cfg, mesh, state, putter), mesh

    dt = factor_dtype(cfg, path)
    if state is None:
        state = init_factors(spec.users, spec.items, spec.features)
    L0, R0 = shp.pad_factors(
        np.asarray(state.L, dtype=dt), np.asarray(state.R, dtype=dt), pu, pi
    )
    sL = NamedSharding(mesh, P(AXIS_USERS, None))
    sR = NamedSharding(mesh, P(AXIS_ITEMS, None))
    L0 = putter(L0, sL)
    R0 = putter(R0, sR)
    alpha2 = dt.type(2.0 * spec.alpha)

    if path == "dense":
        A, M = shp.dense_blocks(spec, pu, pi, dtype=dt)
        sAM = NamedSharding(mesh, P(AXIS_USERS, AXIS_ITEMS))
        train = make_dense_train(mesh, alpha2, spec.iters, matmul_precision(cfg))
        L, R = train(L0, R0, putter(A, sAM), putter(M, sAM))
    elif coo_use_cumsum(spec, cfg):
        # Speed dtypes: scatter-free prefix-sum form (see ops/coo.py);
        # the same rule as the single-device engine.
        shards, u_blk, i_blk = shp.bucket_coo_seg(spec, pu, pi, dtype=dt)
        sE = NamedSharding(mesh, P(AXIS_USERS, AXIS_ITEMS, None))
        dev = [putter(np.asarray(x), sE) for x in shards]
        train = make_coo_seg_train(mesh, alpha2, spec.iters, u_blk, i_blk)
        L, R = train(L0, R0, *dev)
    else:
        shards, u_blk, i_blk = shp.bucket_coo(spec, pu, pi, dtype=dt)
        sE = NamedSharding(mesh, P(AXIS_USERS, AXIS_ITEMS, None))
        dev = [putter(np.asarray(x), sE) for x in shards]
        train = make_coo_train(mesh, alpha2, spec.iters, u_blk, i_blk)
        L, R = train(L0, R0, *dev)
    return MFState(L=L, R=R), mesh


def _factorize_sharded_bell(spec: ProblemSpec, cfg: RunConfig, mesh, state: MFState | None, putter=jax.device_put) -> MFState:
    """Checkerboard BELL training (ops/bell.py): global-degree-permuted
    factors with per-block zero rows, shard-uniform bucket tables, one
    fused gather-reduce per side per shard + the two axis psums.  The
    result is un-permuted on host and re-uploaded in the standard
    ``P('u'/'i', None)`` layout so the top-1 pipeline is unchanged."""
    from recsys_tpu.models.mf import MFState as _MF
    from recsys_tpu.ops.bell import (
        make_sharded_bell,
        pad_factors_sharded_bell,
        sharded_unpermute_index,
    )
    from recsys_tpu.parallel.step import make_bell_train

    pu, pi = mesh.devices.shape
    dt = jnp.dtype(cfg.dtype)
    data = make_sharded_bell(spec, pu, pi, dtype=dt)
    m0 = data.meta
    sL = NamedSharding(mesh, P(AXIS_USERS, None))
    sR = NamedSharding(mesh, P(AXIS_ITEMS, None))
    from recsys_tpu.engine.trainer import DEVICE_INIT_MIN_DRAWS

    draws = (spec.users + spec.items) * spec.features
    if (
        state is None
        and draws >= DEVICE_INIT_MIN_DRAWS
        and dt in (jnp.float32, jnp.bfloat16)
        and jax.process_count() == 1
        and putter is jax.device_put
    ):
        # Device-side glibc init (ops/device_rng.py) + block-layout via
        # one sharded gather each: skips the host init's throttled page
        # faults and the full-table upload, same as the single-chip BELL
        # path.  Single-process only: per-process device arrays cannot
        # feed a global jit directly.
        from recsys_tpu.ops.bell import sharded_lay_index
        from recsys_tpu.ops.device_rng import device_init_factors

        L0d, R0d = device_init_factors(spec.users, spec.items, spec.features)
        uidx = jnp.asarray(sharded_lay_index(data.user_perm, m0.u_blk, pu))
        iidx = jnp.asarray(sharded_lay_index(data.item_perm, m0.i_blk, pi))
        take = jax.jit(
            lambda F, i: jnp.take(F.astype(dt), i, axis=0, mode="fill", fill_value=0),
            out_shardings=sL,
        )
        L0 = take(L0d, uidx)
        take_r = jax.jit(
            lambda F, i: jnp.take(F.astype(dt), i, axis=0, mode="fill", fill_value=0),
            out_shardings=sR,
        )
        R0 = take_r(R0d, iidx)
        del L0d, R0d
    else:
        if state is None:
            state = init_factors(spec.users, spec.items, spec.features)
        L0, R0 = pad_factors_sharded_bell(state, data, dt)
    s3 = NamedSharding(mesh, P(AXIS_USERS, AXIS_ITEMS, None))
    s4 = NamedSharding(mesh, P(AXIS_USERS, AXIS_ITEMS, None, None))
    t = data.tables
    dev = [putter(t.ucols, s3), putter(t.irows, s3)]
    dev += [putter(v, s4) for v in t.uvals + t.ivals]
    train = make_bell_train(mesh, dt.type(2.0 * spec.alpha), spec.iters, data.meta)
    Lp, Rp = train(putter(L0, sL), putter(R0, sR), *dev)
    # Un-permute ON DEVICE into the standard padded P('u'/'i', None)
    # layout the top-1 pipeline expects: a host round-trip
    # (np.asarray) would raise on a non-fully-addressable global array
    # in multi-process runs, and wastes a download besides.  Padding
    # rows read a per-block zero row, preserving self-masking padding.
    m = data.meta
    srep = NamedSharding(mesh, P())
    uidx = putter(sharded_unpermute_index(data.inv_user_perm, m.u_blk, pu * m.u_blk), srep)
    iidx = putter(sharded_unpermute_index(data.inv_item_perm, m.i_blk, pi * m.i_blk), srep)
    L1 = jax.jit(jnp.take, static_argnames=("axis",), out_shardings=sL)(Lp, uidx, axis=0)
    R1 = jax.jit(jnp.take, static_argnames=("axis",), out_shardings=sR)(Rp, iidx, axis=0)
    return _MF(L=L1, R=R1)


def sharded_top1_device(state: MFState, spec: ProblemSpec, mesh, putter=None, precision: str = "highest"):
    """Distributed masked top-1; returns the device array (u-sharded,
    int32[users_pad]) so multi-process callers can gather it themselves.

    Masking uses the compact rated-items table (O(nnz) host/device
    memory, ``ops.topk.make_rated_table``) unless some user rated most
    of the item space — the dense users×items mask is built only in
    that fallback, so the sparse extreme shapes (1000×1M: a ~1 GB bool
    mask, ~100 GB beyond) run train→top-1 in O(nnz + dims) memory, like
    the reference's merge-scan top-1 (``matFact-mpi.c:51-103``)."""
    from recsys_tpu.ops.topk import make_rated_table
    from recsys_tpu.parallel.step import make_sharded_top1_rated

    if putter is None:
        putter = jax.device_put
    pu, pi = mesh.devices.shape
    # Dims derive from the factor shapes (BELL's un-permuted tables and
    # the dense/COO padding share the P('u'/'i', None) layout).
    users_pad = state.L.shape[0]
    items_pad = state.R.shape[0]
    i_blk = items_pad // pi
    max_rated = int(np.bincount(spec.rows, minlength=spec.users).max()) if spec.nnz else 0
    if max_rated <= max(spec.items // 8, 128):
        table = make_rated_table(spec)
        tpad = np.full((users_pad, table.shape[1]), -1, np.int32)
        tpad[: spec.users] = table
        # Bound per-step temps at (u_blk, block) cells per shard, as the
        # single-chip recommend() does for (users, block).
        u_blk = users_pad // pu
        cap = (16_000_000 // max(u_blk, 1)) // 128 * 128
        block = min(max(cap, 128), -(-i_blk // 128) * 128)
        top1_fn = make_sharded_top1_rated(mesh, i_blk, spec.items, block, precision)
        sT = NamedSharding(mesh, P(AXIS_USERS, None))
        return top1_fn(state.L, state.R, putter(tpad, sT))
    mask = shp.rated_mask_padded(spec, pu, pi, users_pad=users_pad, items_pad=items_pad)
    sM = NamedSharding(mesh, P(AXIS_USERS, AXIS_ITEMS))
    top1_fn = make_sharded_top1(mesh, i_blk, precision)
    return top1_fn(state.L, state.R, putter(mask, sM))


def recommend_sharded(state: MFState, spec: ProblemSpec, mesh, cfg: RunConfig = RunConfig()) -> np.ndarray:
    """Distributed masked top-1; returns int32[users] on host."""
    from recsys_tpu.engine.trainer import matmul_precision

    top1 = sharded_top1_device(state, spec, mesh, precision=matmul_precision(cfg))
    return np.asarray(top1)[: spec.users]


def run(spec: ProblemSpec, cfg: RunConfig = RunConfig()) -> tuple[str, np.ndarray]:
    from recsys_tpu.io.writers import format_recommendations

    state, mesh = factorize_sharded(spec, cfg)
    top1 = recommend_sharded(state, spec, mesh, cfg)
    return format_recommendations(top1, spec.rated_counts(), spec.items), top1


# dryrun tolerances keyed by the engine's matmul precision
# (``trainer.matmul_precision``): (rtol, atol, top-1 agreement floor).
# "highest" products are true f32, so a sharded run differs from the
# single-device run only in reduction order and argmaxes are stable;
# "bf16" operands carry 8 mantissa bits (~4e-3 relative per product),
# so factors drift ~1e-2 and near-tie argmaxes can legitimately flip.
# A systematic sharding bug (lost psum, off-by-one block, double-counted
# base) is orders of magnitude above either bound.
DRYRUN_TOLERANCES = {
    "highest": (3e-4, 1e-5, 1.0),
    "bf16": (2e-2, 1e-3, 0.95),
}


def dryrun(n_devices: int, *, dtype: str = "float32") -> None:
    """Driver hook: validate the multi-device path NUMERICALLY, not just
    for crashes — a systematic sharded-numerics bug that keeps shapes
    intact must fail here (the reference's analogous guarantee is its
    cluster runs matching golden output, ``matFact-mpi.c:155-214``).

    1. Tiny smoke: one step of all three sharded formulations + top-1.
    2. 200x300, 5 iters: every sharded formulation's factors compared
       against the SINGLE-DEVICE engine on the same path and dtype, and
       the distributed top-1 compared against the numpy oracle applied
       to those same factors (rated-table masking branch).
    3. A hub-user instance whose max rated count exceeds the compact
       rated-table cap, driving the dense-mask top-1 branch, again
       checked against the numpy oracle.
    """
    from recsys_tpu.engine import trainer
    from recsys_tpu.engine.oracle import top1_numpy
    from recsys_tpu.io.generator import generate_instance

    devs = jax.devices()[:n_devices]
    pu = 1
    for cand in range(int(n_devices**0.5), 0, -1):
        if n_devices % cand == 0:
            pu = cand
            break
    mesh = make_mesh(0, 0, shape=(pu, n_devices // pu), devices=devs)

    spec = generate_instance(12, 20, 4, 1, 5, iters=1, alpha=0.01, seed=7)
    for path in ("dense", "coo", "bell"):
        cfg = RunConfig(dtype=dtype, path=path)
        state, _ = factorize_sharded(spec, cfg, mesh=mesh)
        top1 = recommend_sharded(state, spec, mesh, cfg)
        assert top1.shape == (spec.users,)

    rtol, atol, min_top1_agree = DRYRUN_TOLERANCES[trainer.matmul_precision(RunConfig(dtype=dtype))]

    spec2 = generate_instance(200, 300, 8, 1, 6, iters=5, alpha=0.02, seed=11)
    for path in ("dense", "coo", "bell"):
        cfg = RunConfig(dtype=dtype, path=path)
        ref = trainer.factorize(spec2, cfg)
        refL = np.asarray(ref.L, np.float64)[: spec2.users, : spec2.features]
        refR = np.asarray(ref.R, np.float64)[: spec2.items, : spec2.features]
        state, _ = factorize_sharded(spec2, cfg, mesh=mesh)
        L = np.asarray(state.L, np.float64)[: spec2.users, : spec2.features]
        R = np.asarray(state.R, np.float64)[: spec2.items, : spec2.features]
        np.testing.assert_allclose(
            L, refL, rtol=rtol, atol=atol,
            err_msg=f"sharded {path}: L drifted from the single-device engine",
        )
        np.testing.assert_allclose(
            R, refR, rtol=rtol, atol=atol,
            err_msg=f"sharded {path}: R drifted from the single-device engine",
        )
        top1 = recommend_sharded(state, spec2, mesh, cfg)
        exp = top1_numpy(L, R, spec2)
        agree = float((top1 == exp).mean())
        if agree < min_top1_agree:
            raise AssertionError(
                f"sharded top-1 ({path}, rated-table branch): agreement "
                f"{agree:.3f} with the numpy oracle on the same factors "
                f"(floor {min_top1_agree})"
            )

    # Hub instance: user 0 rates 2/3 of the item space, pushing
    # max_rated past the rated-table cap (max(items//8, 128)) so the
    # dense-mask branch of sharded_top1_device runs.
    hub_items = np.arange(0, 200, dtype=np.int64)
    rng = np.random.default_rng(13)
    tail_rows, tail_cols = [], []
    for u in range(1, 40):
        cs = np.unique(rng.integers(0, 300, size=4))
        tail_rows += [u] * len(cs)
        tail_cols += list(cs)
    rows = np.concatenate([np.zeros(200, np.int64), np.array(tail_rows)])
    cols = np.concatenate([hub_items, np.array(tail_cols)])
    vals = rng.integers(1, 6, size=len(rows)).astype(np.float64)
    spec3 = ProblemSpec(
        iters=3, alpha=0.02, features=4, users=40, items=300,
        rows=rows.astype(np.int32), cols=cols.astype(np.int32), vals=vals,
    )
    assert int(np.bincount(spec3.rows).max()) > max(spec3.items // 8, 128)
    cfg = RunConfig(dtype=dtype, path="coo")
    state, _ = factorize_sharded(spec3, cfg, mesh=mesh)
    L = np.asarray(state.L, np.float64)[: spec3.users, : spec3.features]
    R = np.asarray(state.R, np.float64)[: spec3.items, : spec3.features]
    top1 = recommend_sharded(state, spec3, mesh, cfg)
    exp = top1_numpy(L, R, spec3)
    agree = float((top1 == exp).mean())
    if agree < min_top1_agree:
        raise AssertionError(
            f"sharded top-1 (dense-mask branch): agreement {agree:.3f} "
            f"with the numpy oracle (floor {min_top1_agree})"
        )
