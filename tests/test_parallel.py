"""Sharded engine on the virtual 8-device CPU mesh vs single-chip results.

The key property: results are independent of mesh shape — the factors
are generated in the serial RNG order and the sharded math is the same
full-batch GD, so any mesh must reproduce the single-device engine
(and hence the oracle and goldens) up to reduction rounding.
"""

import dataclasses

import jax
import numpy as np
import pytest

from recsys_tpu.config import RunConfig
from recsys_tpu.engine import trainer
from recsys_tpu.io.parser import load_problem
from recsys_tpu.io.writers import format_recommendations
from recsys_tpu.parallel import engine as par
from recsys_tpu.parallel.mesh import balanced_grid, make_mesh

from helpers import FIXTURES, read_golden

@pytest.fixture(autouse=True)
def _eight_devices():
    # Decided per test, not at import: every xdist worker must collect
    # the same tests.
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")


def _spec(inst, iters=None):
    spec = load_problem(FIXTURES / f"{inst}.in")
    return spec if iters is None else dataclasses.replace(spec, iters=iters)


def test_balanced_grid():
    # square matrix -> square-ish grid
    assert balanced_grid(8, 1000, 1000) in [(2, 4), (4, 2)]
    # extreme aspect ratio degrades to 1-D (the reference's reshaping goal)
    assert balanced_grid(8, 1000, 1_000_000) == (1, 8)
    assert balanced_grid(8, 1_000_000, 100) == (8, 1)


@pytest.mark.parametrize("shape", [(2, 4), (4, 2), (8, 1), (1, 8)])
@pytest.mark.parametrize("path", ["dense", "coo", "bell"])
def test_sharded_matches_single_chip(shape, path):
    """30x40 instance, 50 iters, f64: every mesh shape reproduces the
    single-device engine (padding: 30 and 40 are not multiples of 8)."""
    spec = _spec("inst30-40-10-2-10", 50)
    want = trainer.factorize(spec, RunConfig(dtype="float64", path=path))
    mesh = make_mesh(spec.users, spec.items, shape=shape)
    got, _ = par.factorize_sharded(
        spec, RunConfig(dtype="float64", path=path), mesh=mesh
    )
    np.testing.assert_allclose(
        np.asarray(got.L)[: spec.users], np.asarray(want.L), rtol=1e-11, atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(got.R)[: spec.items], np.asarray(want.R), rtol=1e-11, atol=1e-12
    )


@pytest.mark.parametrize("inst", ["inst0", "inst30-40-10-2-10"])
def test_sharded_golden_end_to_end(inst):
    """Full end-to-end sharded run matches the golden .out (f64, 2x4 mesh)."""
    spec = _spec(inst)
    out, _ = par.run(spec, RunConfig(dtype="float64", mesh_shape=(2, 4)))
    assert out == read_golden(inst)


def test_sharded_top1_tie_break_across_shards():
    """All-equal predictions: every user must get item 0 (lowest index),
    exercising the cross-shard argmax reduction."""
    spec = _spec("inst30-40-10-2-10")
    mesh = make_mesh(spec.users, spec.items, shape=(1, 8))
    from recsys_tpu.models.mf import MFState
    from recsys_tpu.parallel.sharding import pad_factors

    L = np.ones((spec.users, spec.features), np.float32)
    R = np.ones((spec.items, spec.features), np.float32)
    Lp, Rp = pad_factors(L, R, 1, 8)
    spec_unrated = dataclasses.replace(
        spec,
        rows=np.zeros(0, np.int32),
        cols=np.zeros(0, np.int32),
        vals=np.zeros(0, np.float64),
    )
    top1 = par.recommend_sharded(MFState(L=Lp, R=Rp), spec_unrated, mesh)
    np.testing.assert_array_equal(top1, np.zeros(spec.users, np.int32))


def test_dryrun_multichip_hook():
    import __graft_entry__ as g

    g.dryrun_multichip(8)


def test_dryrun_bf16_tolerance_branch_passes():
    """The loose bf16-operand tolerances (2e-2, 0.95) must be executable,
    not dead code: run the dryrun in bfloat16 on the CPU mesh — an
    inverted comparison or malformed bound in that branch fails here."""
    par.dryrun(8, dtype="bfloat16")


@pytest.mark.parametrize("dtype,key", [("float32", "highest"), ("bfloat16", "bf16"), ("float64", "highest")])
def test_dryrun_tolerances_keyed_by_precision(dtype, key):
    """The dryrun's bounds follow the engine's one precision mapping,
    never the backend's name."""
    assert trainer.matmul_precision(RunConfig(dtype=dtype)) == key
    assert key in par.DRYRUN_TOLERANCES


def test_dryrun_catches_dropped_psum(monkeypatch):
    """Dropping the factor-delta all-reduce (the MPI analogue: skipping the
    Allreduce at ``matFact-mpi.c:207-209``) must not pass the dryrun.  It is
    in fact caught *statically*: shard_map's varying-axes typing rejects the
    carry whose deltas are still axis-varying."""
    real_psum = jax.lax.psum
    monkeypatch.setattr(jax.lax, "psum", lambda x, axis_name, **kw: x)
    with pytest.raises(Exception):
        par.dryrun(8, dtype="bfloat16")
    monkeypatch.setattr(jax.lax, "psum", real_psum)


def test_dryrun_bf16_tolerances_catch_double_counted_reduction(monkeypatch):
    """Even the loose bf16 bounds must catch a systematic *numeric* sharding
    bug the type system cannot see: a double-counted reduction (the bug
    class the reference's count-the-base-once dance at
    ``matFact-mpi.c:187-188`` guards against)."""
    real_psum = jax.lax.psum
    monkeypatch.setattr(
        jax.lax, "psum", lambda x, axis_name, **kw: real_psum(x, axis_name, **kw) * 2
    )
    with pytest.raises(AssertionError):
        par.dryrun(8, dtype="bfloat16")
    monkeypatch.setattr(jax.lax, "psum", real_psum)


@pytest.mark.parametrize("shape", [(2, 4), (8, 1), (1, 8)])
def test_sharded_coo_cumsum_matches_single_chip(shape):
    """f32 sharded COO (scatter-free prefix-sum form) vs single-device
    engine: same full-batch sums up to reduction rounding."""
    spec = _spec("inst30-40-10-2-10", 50)
    want = trainer.factorize(spec, RunConfig(dtype="float32", path="dense"))
    mesh = make_mesh(spec.users, spec.items, shape=shape)
    got, _ = par.factorize_sharded(spec, RunConfig(dtype="float32", path="coo"), mesh=mesh)
    np.testing.assert_allclose(
        np.asarray(got.L)[: spec.users], np.asarray(want.L), rtol=3e-4, atol=3e-5
    )
    np.testing.assert_allclose(
        np.asarray(got.R)[: spec.items], np.asarray(want.R), rtol=3e-4, atol=3e-5
    )


@pytest.mark.parametrize("shape", [(2, 4), (1, 8), (8, 1)])
@pytest.mark.parametrize("path", ["dense", "bell"])
def test_sharded_f32_matches_single_chip(shape, path):
    """f32 sharded dense (true-f32 products) and sharded BELL on the
    8-device mesh must match the single-device engine on the same path."""
    spec = _spec("inst30-40-10-2-10", 50)
    cfg = RunConfig(dtype="float32", path=path)
    want = trainer.factorize(spec, cfg)
    mesh = make_mesh(spec.users, spec.items, shape=shape)
    got, _ = par.factorize_sharded(spec, cfg, mesh=mesh)
    np.testing.assert_allclose(
        np.asarray(got.L)[: spec.users, : spec.features],
        np.asarray(want.L), rtol=3e-5, atol=3e-6,
    )
    np.testing.assert_allclose(
        np.asarray(got.R)[: spec.items, : spec.features],
        np.asarray(want.R), rtol=3e-5, atol=3e-6,
    )


def test_sharded_f32_end_to_end_golden():
    spec = _spec("inst30-40-10-2-10")
    out, _ = par.run(spec, RunConfig(dtype="float32", mesh_shape=(2, 4)))
    assert out == read_golden("inst30-40-10-2-10")


def test_sharded_coo_with_empty_shards():
    """A shard owning ZERO entries must contribute exactly nothing (the
    reference needed an explicit empty-rank protocol, matFact-mpi.c:377-405;
    here padding entries with weight 0 make it fall out)."""
    import numpy as np

    from recsys_tpu.config import ProblemSpec

    # All entries in the top-left corner: on a (2,4) mesh most shards are
    # empty. nnz=3 exercises the scatter branch; nnz=60 (>= users+items)
    # exercises the prefix-sum branch.
    cases = [
        (np.array([0, 1, 2], dtype=np.int32), np.array([0, 1, 2], dtype=np.int32)),
        (np.repeat(np.arange(3, dtype=np.int32), 20), np.tile(np.arange(20, dtype=np.int32), 3)),
    ]
    rng = np.random.default_rng(0)
    for rows, cols in cases:
        vals = rng.integers(1, 6, rows.size).astype(np.float64)
        spec = ProblemSpec(iters=10, alpha=0.01, features=4, users=16, items=32,
                           rows=rows, cols=cols, vals=vals)
        want = trainer.factorize(spec, RunConfig(dtype="float32", path="dense"))
        mesh = make_mesh(spec.users, spec.items, shape=(2, 4))
        for path in ("coo", "bell"):
            got, _ = par.factorize_sharded(
                spec, RunConfig(dtype="float32", path=path), mesh=mesh
            )
            np.testing.assert_allclose(
                np.asarray(got.L)[: spec.users, : spec.features],
                np.asarray(want.L), rtol=3e-5, atol=3e-6,
            )
            np.testing.assert_allclose(
                np.asarray(got.R)[: spec.items, : spec.features],
                np.asarray(want.R), rtol=3e-5, atol=3e-6,
            )


@pytest.mark.parametrize("shape", [(1, 8), (2, 4)])
def test_sharded_bell_extreme_aspect(shape):
    """Sharded BELL on a hyper-sparse wide instance (the inst1000-1e6
    regime scaled down): must agree with single-chip BELL and touch no
    items-sized work beyond the factor block."""
    from recsys_tpu.io.generator import generate_instance

    spec = generate_instance(40, 5000, 16, 1, 3, iters=4, alpha=0.001, seed=5)
    want = trainer.factorize(spec, RunConfig(dtype="float32", path="bell"))
    mesh = make_mesh(spec.users, spec.items, shape=shape)
    got, _ = par.factorize_sharded(spec, RunConfig(dtype="float32", path="bell"), mesh=mesh)
    np.testing.assert_allclose(
        np.asarray(got.L)[: spec.users, : spec.features],
        np.asarray(want.L), rtol=3e-5, atol=3e-6,
    )
    np.testing.assert_allclose(
        np.asarray(got.R)[: spec.items, : spec.features],
        np.asarray(want.R), rtol=3e-5, atol=3e-6,
    )


def test_sharded_bell_device_init(monkeypatch):
    """With the draw threshold forced to 0, the sharded BELL path
    generates initial factors on device (ops/device_rng.py) and lays
    them out via sharded gathers; results must agree with the host-init
    run (the device stream is bit-exact in integers, within ~2 f32 ulp
    after scaling)."""
    import recsys_tpu.engine.trainer as trainer_mod
    from recsys_tpu.io.generator import generate_instance
    from recsys_tpu.parallel.engine import factorize_sharded
    from recsys_tpu.parallel.mesh import make_mesh

    spec = generate_instance(24, 36, 4, 1, 4, iters=3, alpha=0.01, seed=5)
    mesh = make_mesh(spec.users, spec.items, shape=(2, 4))
    cfg = RunConfig(dtype="float32", path="bell")
    host_state, _ = factorize_sharded(spec, cfg, mesh=mesh)
    monkeypatch.setattr(trainer_mod, "DEVICE_INIT_MIN_DRAWS", 0)
    dev_state, _ = factorize_sharded(spec, cfg, mesh=mesh)
    np.testing.assert_allclose(
        np.asarray(dev_state.L), np.asarray(host_state.L), rtol=2e-4, atol=2e-6
    )
    np.testing.assert_allclose(
        np.asarray(dev_state.R), np.asarray(host_state.R), rtol=2e-4, atol=2e-6
    )


def test_sharded_bf16_dense_keeps_f32_factors():
    """bfloat16 on the sharded dense path rounds only the matmul
    operands: the factors stay f32 and the top-1 still matches the
    golden on most users."""
    spec = _spec("inst30-40-10-2-10")
    cfg = RunConfig(dtype="bfloat16", path="dense", mesh_shape=(2, 4))
    state, mesh = par.factorize_sharded(spec, cfg)
    assert state.L.dtype == np.float32 and state.R.dtype == np.float32
    out, _ = par.run(spec, cfg)
    gold = read_golden("inst30-40-10-2-10").splitlines()
    agree = np.mean([a == b for a, b in zip(out.splitlines(), gold)])
    assert agree >= 0.9, agree
