"""The reference's extreme-shape cluster instances, executed here.

The reference ran inst1000-1e6-1000-1-3 (1000 users x 1M items, k=1000)
and inst1e6-100-700-1-3 (1M users x 100 items, k=700) only on its MPI
cluster (report-mpi.pdf Table 1: 211.80 s / 87.42 s at 16 ranks).  These
tests execute the same shapes on the CPU mesh at reduced iterations:
the real 1M-item fixture end-to-end through BELL, cross-checked against
the scatter-COO formulation, plus a generated 1M-user analogue.

Factors are injected (``state=``) instead of drawn from the glibc RNG:
the 1e9-draw init sequence is exercised (bit-exactly) elsewhere and
would dominate test runtime here.
"""

import dataclasses

import numpy as np
import pytest

from recsys_tpu.config import RunConfig
from recsys_tpu.engine import trainer
from recsys_tpu.io.generator import generate_instance
from recsys_tpu.io.parser import load_problem
from recsys_tpu.models.mf import MFState

from helpers import FIXTURES


def _cheap_state(spec, seed=0):
    rng = np.random.default_rng(seed)
    return MFState(
        L=rng.random((spec.users, spec.features)) / spec.features,
        R=rng.random((spec.items, spec.features)) / spec.features,
    )


@pytest.mark.slow
def test_inst1000_1e6_fixture_executes():
    # The REAL 1000x1,000,000 k=1000 fixture (nnz 2014), 2 iterations.
    spec = load_problem(str(FIXTURES / "inst1000-1e6-1000-1-3.in"))
    spec = dataclasses.replace(spec, iters=2)
    assert (spec.users, spec.items, spec.features) == (1000, 1_000_000, 1000)
    state = _cheap_state(spec)
    assert trainer.choose_path(spec, RunConfig(dtype="float32")) == "bell"
    st_b = trainer.factorize(spec, RunConfig(dtype="float32", path="bell"), state=state)
    # Rated items moved; the untouched 99.8% of R stayed identical.
    rated = np.zeros(spec.items, bool)
    rated[spec.cols] = True
    R32 = state.R.astype(np.float32)
    assert not np.allclose(np.asarray(st_b.R)[rated], R32[rated])
    np.testing.assert_array_equal(np.asarray(st_b.R)[~rated], R32[~rated])
    # Cross-check against the scatter-COO formulation (the 1M-segment
    # segment_sum program; on the CPU mesh it compiles and must agree).
    # k reduced for the cross-check to keep the 4 GB factor tables out
    # of the default suite; the 1M-segment dimension is what matters.
    small = dataclasses.replace(spec, features=64)
    sstate = _cheap_state(small)
    st_b2 = trainer.factorize(small, RunConfig(dtype="float32", path="bell"), state=sstate)
    st_c = trainer.factorize(small, RunConfig(dtype="float32", path="coo"), state=sstate)
    np.testing.assert_allclose(np.asarray(st_b2.L), np.asarray(st_c.L), rtol=2e-5, atol=2e-7)
    np.testing.assert_allclose(np.asarray(st_b2.R), np.asarray(st_c.R), rtol=2e-5, atol=2e-7)


@pytest.mark.slow
def test_inst1e6_100_shape_executes():
    # Scale-equivalent gen analogue of inst1e6-100-700-1-3 (its .in blob
    # is missing upstream): 1M users, 100 items, 1-3 entries per row.
    # k reduced 700 -> 32 to keep CPU test runtime sane; the 1M-user
    # bucketing/update path is what's being exercised.
    spec = generate_instance(1_000_000, 100, 32, 1, 3, iters=2, alpha=1e-5, seed=11)
    state = _cheap_state(spec)
    st_b = trainer.factorize(spec, RunConfig(dtype="float32", path="bell"), state=state)
    st_c = trainer.factorize(spec, RunConfig(dtype="float32", path="coo"), state=state)
    np.testing.assert_allclose(np.asarray(st_b.L), np.asarray(st_c.L), rtol=2e-5, atol=2e-7)
    np.testing.assert_allclose(np.asarray(st_b.R), np.asarray(st_c.R), rtol=2e-5, atol=2e-7)


def test_inst1000_1e6_golden_integrity():
    """The golden minted in round 5 from the reference's own serial
    binary (the upstream `.out` is 0 bytes — provenance and the two
    independent reference builds in fixtures/README.md): structural
    checks that need no 2e12-FLOP B product — one line per user (no
    user rates all 1M items), indices in range, and no user recommended
    an item they rated.  The full byte-exact validation of the numpy
    f64 oracle against it ran offline and is recorded with its date in
    fixtures/README.md."""
    golden = open(FIXTURES / "inst1000-1e6-1000-1-3.out").read().splitlines()
    spec = load_problem(str(FIXTURES / "inst1000-1e6-1000-1-3.in"))
    assert len(golden) == spec.users == 1000
    top = np.array([int(x) for x in golden])
    assert ((0 <= top) & (top < spec.items)).all()
    rated = set(zip(spec.rows.tolist(), spec.cols.tolist()))
    assert not any((u, t) in rated for u, t in enumerate(top.tolist()))


def test_extreme_shape_bell_tables_are_small():
    # BELL's working set for 1000x1M is O(nnz + dims), not O(cells):
    # the degree-sorted layout never materializes anything items-sized
    # beyond the factor table itself.
    spec = load_problem(str(FIXTURES / "inst1000-1e6-1000-1-3.in"))
    from recsys_tpu.ops.bell import make_bell_inputs

    data = make_bell_inputs(spec, np.float32)
    slot_bytes = data.tables.ucols.nbytes + data.tables.irows.nbytes
    slot_bytes += sum(v.nbytes for v in data.tables.uvals + data.tables.ivals)
    assert slot_bytes < 64 * spec.nnz  # a few bytes per entry, both sides
    assert data.meta.item.n_nz <= 2 * spec.nnz


@pytest.mark.slow
def test_inst1000_1e6_sharded_bell_executes():
    """The cluster shape on the 8-device mesh: sharded BELL must
    handle a 1M-item dimension (125k-item blocks, ragged degree
    buckets, empty shards) and agree with the single-chip engine."""
    from recsys_tpu.parallel.engine import factorize_sharded
    from recsys_tpu.parallel.mesh import make_mesh

    spec = load_problem(str(FIXTURES / "inst1000-1e6-1000-1-3.in"))
    spec = dataclasses.replace(spec, iters=2, features=64)
    state = _cheap_state(spec)
    single = trainer.factorize(
        spec, RunConfig(dtype="float32", path="bell"), state=state
    )
    mesh = make_mesh(spec.users, spec.items, shape=(2, 4))
    sharded, _ = factorize_sharded(
        spec, RunConfig(dtype="float32", path="bell"), mesh=mesh, state=state
    )
    np.testing.assert_allclose(
        np.asarray(sharded.L)[: spec.users], np.asarray(single.L),
        rtol=2e-5, atol=2e-7,
    )
    np.testing.assert_allclose(
        np.asarray(sharded.R)[: spec.items], np.asarray(single.R),
        rtol=2e-5, atol=2e-7,
    )
    # End-to-end: the sharded top-1 runs at this scale in O(nnz + dims)
    # memory (compact rated-table masking — the dense users*items bool
    # mask would be ~1 GB here and was the round-2 scaling gap).
    from recsys_tpu.parallel.engine import recommend_sharded

    top1 = recommend_sharded(sharded, spec, mesh)
    assert top1.shape == (spec.users,)
    L = np.asarray(sharded.L)[: spec.users]
    R = np.asarray(sharded.R)[: spec.items]
    for u in (0, 1, 7, 499, 999):
        preds = (L[u] @ R.T).astype(np.float32)
        preds[spec.cols[spec.rows == u]] = -np.inf
        assert top1[u] == int(np.argmax(preds))  # first max = lowest index
