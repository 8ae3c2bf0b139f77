"""Edge cases of the output contract and path gating.

The reference skips users whose every item is rated (``matFact.c:24``:
``max == -1`` never printed) and its entry values are non-zero by type
(``non_zero_entry``); these tests pin the corresponding behavior.
"""

import dataclasses

import numpy as np
import pytest

from recsys_tpu.config import ProblemSpec, RunConfig
from recsys_tpu.engine import trainer
from recsys_tpu.engine.oracle import run_oracle
from recsys_tpu.io.writers import format_recommendations


def _spec_all_rated_user():
    # User 0 rated everything (5 items); users 1-2 partially.
    rows = np.array([0, 0, 0, 0, 0, 1, 2], dtype=np.int32)
    cols = np.array([0, 1, 2, 3, 4, 1, 3], dtype=np.int32)
    vals = np.array([5, 4, 3, 2, 1, 4, 2], dtype=np.float64)
    return ProblemSpec(iters=3, alpha=0.01, features=2, users=3, items=5,
                       rows=rows, cols=cols, vals=vals)


def test_all_rated_user_omitted_from_output():
    spec = _spec_all_rated_user()
    out = run_oracle(spec)
    assert len(out.splitlines()) == 2  # users 1 and 2 only


def test_all_rated_user_omitted_jax_paths():
    spec = _spec_all_rated_user()
    for path in ("dense", "bell", "coo"):
        out, top1 = trainer.run(spec, RunConfig(dtype="float64", path=path))
        assert len(out.splitlines()) == 2, path
        assert len(top1) == 3  # raw indices still computed for all users


def test_format_recommendations_skip_rule():
    top1 = np.array([4, 2, 0], dtype=np.int32)
    rated = np.array([5, 2, 5], dtype=np.int32)  # users 0 and 2 rated all 5
    assert format_recommendations(top1, rated, items=5) == "2\n"


@pytest.mark.parametrize("path", ["dense", "bell"])
def test_zero_rating_is_a_rating(path):
    """A legitimate zero rating is an observed cell (mask != (A != 0)):
    both the dense mask and BELL's real-row slots must train on it
    exactly like the oracle does."""
    spec = _spec_all_rated_user()
    spec = dataclasses.replace(spec, vals=spec.vals.copy())
    spec.vals[3] = 0.0
    out, _ = trainer.run(spec, RunConfig(dtype="float64", path=path))
    assert out == run_oracle(spec)


def test_unsorted_entries_rejected_by_sparse_builders():
    # Sparse table builders assume row-major sorted entries; unsorted
    # input must raise, not silently build corrupt tables.
    spec = _spec_all_rated_user()
    order = np.array([1, 0, 2, 3, 4, 5, 6])
    spec = dataclasses.replace(
        spec, rows=spec.rows[order], cols=spec.cols[order], vals=spec.vals[order]
    )
    from recsys_tpu.ops.bell import make_bell_inputs
    from recsys_tpu.ops.coo import make_coo_inputs, make_coo_seg_inputs

    for builder in (make_coo_inputs, make_coo_seg_inputs, make_bell_inputs):
        with pytest.raises(ValueError, match="row-major"):
            builder(spec)
    # duplicate cells are invalid too
    dup = dataclasses.replace(
        spec,
        rows=np.array([0, 0], np.int32),
        cols=np.array([1, 1], np.int32),
        vals=np.array([1.0, 2.0]),
    )
    with pytest.raises(ValueError, match="row-major"):
        make_coo_seg_inputs(dup)


def test_empty_instance_runs():
    spec = ProblemSpec(
        iters=2, alpha=0.01, features=2, users=3, items=4,
        rows=np.zeros(0, np.int32), cols=np.zeros(0, np.int32),
        vals=np.zeros(0, np.float64),
    )
    out, top1 = trainer.run(spec, RunConfig(dtype="float64", path="dense"))
    # No ratings: zero gradient, factors never move; the argmax of the
    # random-init predictions must match the oracle's.
    assert out == run_oracle(spec)
    from recsys_tpu.models.mf import init_factors

    st = init_factors(spec.users, spec.items, spec.features)
    want = np.argmax(st.L @ st.R.T, axis=1)
    np.testing.assert_array_equal(top1, want)


def test_empty_huge_spec_avoids_dense_path():
    """nnz == 0 with dimensions whose dense A does not fit the budget
    must not pick the dense path (it would materialize users*items)."""
    spec = ProblemSpec(
        iters=1, alpha=0.01, features=2, users=1_000_000, items=100_000,
        rows=np.zeros(0, np.int32), cols=np.zeros(0, np.int32),
        vals=np.zeros(0, np.float64),
    )
    assert trainer.choose_path(spec, RunConfig(dtype="float32")) == "coo"
    from recsys_tpu.parallel.engine import _choose_path

    assert _choose_path(spec, RunConfig(dtype="float32"), 8) == "coo"
