"""BELL (degree-sorted bucketed-ELL) sparse path vs oracle/dense/goldens."""

import dataclasses

import numpy as np
import pytest

from recsys_tpu.config import ProblemSpec, RunConfig
from recsys_tpu.engine import trainer
from recsys_tpu.engine.oracle import factorize_numpy
from recsys_tpu.io.generator import generate_instance
from recsys_tpu.io.parser import load_problem
from recsys_tpu.ops.bell import (
    bell_slot_ratio,
    make_bell_inputs,
    pad_factors_for_bell,
    unpermute_factors,
)

from helpers import FIXTURES


@pytest.fixture(scope="module")
def sparse_spec():
    # 2-5 entries per row over 200 items: the inst50000-5000 shape in miniature.
    return generate_instance(60, 200, 8, 2, 5, iters=10, alpha=0.01, seed=9)


def test_bell_tables_cover_every_entry(sparse_spec):
    d = make_bell_inputs(sparse_spec, np.float64)
    # Buckets tile [0, n_nz) on both sides with non-increasing widths.
    for side in (d.meta.user, d.meta.item):
        stops = [0] + [b1 for (_, b1, _) in side.bounds]
        starts = [b0 for (b0, _, _) in side.bounds] + [side.n_nz]
        assert stops == starts
        widths = [w for (_, _, w) in side.bounds]
        assert widths == sorted(widths, reverse=True)
    # Every entry value appears exactly once per side; padding is zero.
    total_u = sum(float(v.sum()) for v in d.tables.uvals)
    total_i = sum(float(v.sum()) for v in d.tables.ivals)
    assert total_u == pytest.approx(float(sparse_spec.vals.sum()))
    assert total_i == pytest.approx(float(sparse_spec.vals.sum()))
    nz_u = sum(int((v != 0).sum()) for v in d.tables.uvals)
    assert nz_u == sparse_spec.nnz
    # Flat gather index length == total slots; padding slots index the
    # appended zero row.
    assert d.tables.ucols.shape[0] == sum(
        w * (b1 - b0) for (b0, b1, w) in d.meta.user.bounds
    )
    assert d.tables.ucols.max() <= sparse_spec.items
    assert d.tables.irows.max() <= sparse_spec.users


def test_bell_matches_oracle(sparse_spec):
    ref, _ = factorize_numpy(sparse_spec)
    st = trainer.factorize(sparse_spec, RunConfig(dtype="float64", path="bell"))
    np.testing.assert_allclose(np.asarray(st.L), ref.L, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(np.asarray(st.R), ref.R, rtol=1e-12, atol=1e-14)


def test_bell_equals_dense_path_f32(sparse_spec):
    st_b = trainer.factorize(sparse_spec, RunConfig(dtype="float32", path="bell"))
    st_d = trainer.factorize(sparse_spec, RunConfig(dtype="float32", path="dense"))
    np.testing.assert_allclose(np.asarray(st_b.L), np.asarray(st_d.L), rtol=3e-5, atol=3e-6)
    np.testing.assert_allclose(np.asarray(st_b.R), np.asarray(st_d.R), rtol=3e-5, atol=3e-6)


@pytest.mark.parametrize("inst", ["inst30-40-10-2-10", "inst500-500-20-2-100"])
def test_bell_golden(inst):
    spec = load_problem(str(FIXTURES / f"{inst}.in"))
    out, _ = trainer.run(spec, RunConfig(dtype="float64", path="bell"))
    golden = open(FIXTURES / f"{inst}.out").read()
    assert out == golden


def test_bell_permutation_roundtrip(sparse_spec):
    from recsys_tpu.models.mf import init_factors

    d = make_bell_inputs(sparse_spec, np.float64)
    state = init_factors(sparse_spec.users, sparse_spec.items, sparse_spec.features)
    L, R = pad_factors_for_bell(state, d, np.float64)
    assert np.all(L[-1] == 0) and np.all(R[-1] == 0)
    Lo, Ro = unpermute_factors(L, R, d)
    np.testing.assert_array_equal(Lo, state.L)
    np.testing.assert_array_equal(Ro, state.R)


def test_bell_huge_dimension_hyper_sparse():
    # The inst1000-1e6 shape in miniature: items >> nnz, so most item
    # rows have degree zero and must never move.
    spec = generate_instance(50, 5000, 3, 1, 2, iters=4, alpha=0.001, seed=4)
    ref, _ = factorize_numpy(spec)
    st = trainer.factorize(spec, RunConfig(dtype="float64", path="bell"))
    np.testing.assert_allclose(np.asarray(st.L), ref.L, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(np.asarray(st.R), ref.R, rtol=1e-12, atol=1e-14)
    # Untouched items keep their exact init values.
    from recsys_tpu.models.mf import init_factors

    rated = np.zeros(spec.items, bool)
    rated[spec.cols] = True
    init = init_factors(spec.users, spec.items, spec.features)
    np.testing.assert_array_equal(np.asarray(st.R)[~rated], init.R[~rated])


def test_bell_power_law_degrees():
    # Skewed degrees exercise multi-width bucketing on both sides.
    rng = np.random.default_rng(0)
    users, items = 64, 48
    cells = [(u, i) for u in range(users) for i in range(items)
             if rng.random() < (0.8 / (1 + u)) + (0.4 / (1 + i))]
    rows = np.array([c[0] for c in cells], np.int32)
    cols = np.array([c[1] for c in cells], np.int32)
    vals = rng.uniform(1, 5, len(cells))
    spec = ProblemSpec(iters=6, alpha=0.005, features=5, users=users,
                       items=items, rows=rows, cols=cols, vals=vals)
    assert bell_slot_ratio(spec) < 2.0
    ref, _ = factorize_numpy(spec)
    st = trainer.factorize(spec, RunConfig(dtype="float64", path="bell"))
    np.testing.assert_allclose(np.asarray(st.L), ref.L, rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(np.asarray(st.R), ref.R, rtol=1e-12, atol=1e-13)


def test_choose_path_dtype_aware():
    # Sparse instance: f64 switches to BELL well before the speed dtypes.
    # (allow_host=False probes the device crossover; at iters=1 the auto
    # path would legitimately pick the native host-serial engine.)
    spec = generate_instance(2000, 2000, 4, 2, 4, iters=1, alpha=0.01, seed=2)
    assert trainer.choose_path(spec, RunConfig(dtype="float32"), allow_host=False) == "bell"
    assert trainer.choose_path(spec, RunConfig(dtype="float64"), allow_host=False) == "bell"
    # Dense-ish instance: speed dtypes stay on the dense path, exact
    # f64 still prefers the sparse form once cells >> slots.
    ml = load_problem(str(FIXTURES / "instML100k.in"))
    assert trainer.choose_path(ml, RunConfig(dtype="float64")) == "bell"
    assert trainer.choose_path(ml, RunConfig(dtype="float32")) == "dense"


def test_regather_variant_equivalent(sparse_spec):
    """REGATHER_FOR_GRADIENT re-gathers the same rows behind an
    optimization_barrier — same rows, same math, but XLA may fuse the
    second gather into its reduction and reassociate the w-dim sum
    (observed when round 4's merge-by-rows bucketing produced a single
    wide user bucket), so the contract is ulp-level agreement and an
    identical recommendation output, not bitwise factors."""
    from recsys_tpu.ops import bell as bell_mod

    saved = bell_mod.REGATHER_FOR_GRADIENT
    try:
        bell_mod.REGATHER_FOR_GRADIENT = False
        a = trainer.factorize(sparse_spec, RunConfig(dtype="float32", path="bell"))
        bell_mod.REGATHER_FOR_GRADIENT = True
        # same (iters, meta) would hit the jit cache traced with the old
        # flag; clear it so the variant actually retraces.
        trainer._train_bell.clear_cache()
        b = trainer.factorize(sparse_spec, RunConfig(dtype="float32", path="bell"))
    finally:
        bell_mod.REGATHER_FOR_GRADIENT = saved
        trainer._train_bell.clear_cache()
    np.testing.assert_allclose(np.asarray(a.L), np.asarray(b.L), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(a.R), np.asarray(b.R), rtol=1e-6, atol=1e-7)
    out_a = trainer.recommend(a, sparse_spec, RunConfig(dtype="float32"))
    out_b = trainer.recommend(b, sparse_spec, RunConfig(dtype="float32"))
    np.testing.assert_array_equal(out_a, out_b)


def test_chunked_rows_independent(sparse_spec):
    """The CHUNK_BYTES split is along n (independent output rows):
    every row's reduction lives inside one piece, so chunking preserves
    each row's mathematical sum.  XLA may reassociate a reduction
    differently per piece shape, so the guarantee is a-few-ulps factor
    agreement plus an UNCHANGED argmax output — the conformance
    contract for the chunked regime (the byte budget is dtype-aware).
    A tiny budget exercises both the _delta_side
    flat-gather gate and _delta_bucket's recursive split."""
    from recsys_tpu.ops import bell as bell_mod

    saved = bell_mod.CHUNK_BYTES
    try:
        trainer._train_bell.clear_cache()
        a = trainer.factorize(sparse_spec, RunConfig(dtype="float64", path="bell"))
        out_a, _ = trainer.run(sparse_spec, RunConfig(dtype="float64", path="bell"))
        # ~97 f64 cells per piece: every bucket chunks, many pieces.
        bell_mod.CHUNK_BYTES = 777
        trainer._train_bell.clear_cache()
        b = trainer.factorize(sparse_spec, RunConfig(dtype="float64", path="bell"))
        out_b, _ = trainer.run(sparse_spec, RunConfig(dtype="float64", path="bell"))
    finally:
        bell_mod.CHUNK_BYTES = saved
        trainer._train_bell.clear_cache()
    np.testing.assert_allclose(np.asarray(a.L), np.asarray(b.L), rtol=1e-14, atol=0)
    np.testing.assert_allclose(np.asarray(a.R), np.asarray(b.R), rtol=1e-14, atol=0)
    assert out_a == out_b


def test_split_gather_gate_bands():
    """Gate bands (tuned on a TPU): k <= 21 always
    splits; 22 <= k <= 42 splits only when the side's set is chunked
    (where piece-wise fusion absorbs the join tax); k > 42 never."""
    from recsys_tpu.ops import bell as bell_mod

    assert bell_mod._use_split_gather(np.float64, 20, None)
    assert bell_mod._use_split_gather(np.float64, 21, 10)
    assert not bell_mod._use_split_gather(np.float64, 30, None)
    assert not bell_mod._use_split_gather(np.float64, 30, 10_000)  # ~0.6 MB set
    assert bell_mod._use_split_gather(np.float64, 30, 2_000_000)  # ~1.2 GB set
    assert not bell_mod._use_split_gather(np.float64, 50, 2_000_000)
    assert not bell_mod._use_split_gather(np.float32, 20, 2_000_000)


def test_chunk_grain_bounds():
    """The fuse grain is 64 MB for small sets, grows past
    CHUNK_MAX_PIECES pieces, and never exceeds the 512 MB staging guard
    (it is a BYTE budget, so f64 rows get half the cells of f32)."""
    from recsys_tpu.ops import bell as bell_mod

    g = bell_mod._chunk_grain
    assert g(1 << 20) == bell_mod.CHUNK_GRAIN_BYTES
    big = 64 << 30
    assert g(big) == bell_mod.CHUNK_BYTES
    mid = 32 * bell_mod.CHUNK_GRAIN_BYTES
    assert g(mid) == mid // bell_mod.CHUNK_MAX_PIECES


def test_regather_disabled_for_f64():
    """Exact-f64 conformance keeps the single-gather HLO regardless of
    the flag: its byte-exact goldens were validated with that program."""
    from recsys_tpu.ops import bell as bell_mod

    assert bell_mod._use_regather(np.float32) == bell_mod.REGATHER_FOR_GRADIENT
    assert bell_mod._use_regather(np.float64) is False


def test_split3_roundtrip_bit_exact():
    """hi+(mid+lo) reconstructs every f64 with 0 or |x| >= 2**-75
    bit-exactly (the SPLIT_GATHER_F64 contract: below that, f32
    flush-to-zero rounds the lo term)."""
    import jax.numpy as jnp

    from recsys_tpu.ops import bell as bell_mod

    rng = np.random.default_rng(7)
    xs = np.concatenate([
        rng.standard_normal(4096),
        rng.standard_normal(4096) * 1e-6,
        rng.standard_normal(256) * 1e8,
        10.0 ** rng.uniform(-22, 2, 4096) * np.sign(rng.standard_normal(4096)),
        np.array([0.0, -0.0, 1.0, -1.0, 2.0**-74, -(2.0**-75), np.pi]),
    ]).reshape(-1, 1)
    got = np.asarray(bell_mod._join3_f64(bell_mod._split3_f32(jnp.asarray(xs)), 1))
    np.testing.assert_array_equal(got, xs)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_native_side_tables_bit_identical(dtype):
    """The native single-pass table builder (rs_bell_side) must produce
    byte-identical tables to the numpy sort-and-scan fallback on every
    side of a lumpy instance."""
    from recsys_tpu.io import _native
    from recsys_tpu.ops import bell as bell_mod

    if not _native.available():
        pytest.skip("no native toolchain")
    spec = generate_instance(150, 700, 12, 1, 60, iters=1, alpha=0.01, seed=17)
    a = bell_mod.make_bell_inputs(spec, dtype=dtype)
    # Force the numpy fallback by masking the native builder.
    orig = _native.bell_side_tables
    _native.bell_side_tables = lambda *a_, **k_: None
    try:
        b = bell_mod.make_bell_inputs(spec, dtype=dtype)
    finally:
        _native.bell_side_tables = orig
    assert a.meta == b.meta
    np.testing.assert_array_equal(a.tables.ucols, b.tables.ucols)
    np.testing.assert_array_equal(a.tables.irows, b.tables.irows)
    for x, y in zip(a.tables.uvals, b.tables.uvals):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(a.tables.ivals, b.tables.ivals):
        np.testing.assert_array_equal(x, y)


def test_split2_is_not_exact():
    """Why there is no 2xf32 split tier: the
    residual x - f32(x) of a full-precision f64 carries up to 29
    significant bits — more than f32's 24 — so hi + f32(x - hi) loses
    low bits and the reconstruction is NOT bit-exact.  (The 3-way split
    is exact because the SECOND residual fits f32.)"""
    import jax.numpy as jnp

    from recsys_tpu.ops import bell as bell_mod

    # 1 + 2**-25 + 2**-52: hi = f32 rounds to 1.0 (2**-25 is a half-ulp
    # tie, round-to-even); the residual 2**-25 + 2**-52 spans 28 bits,
    # so its f32 rounding drops the 2**-52 term.
    x = np.array([[1.0 + 2.0**-25 + 2.0**-52]])
    hi = x.astype(np.float32).astype(np.float64)
    lo = (x - hi).astype(np.float32).astype(np.float64)
    assert (hi + lo) != x  # 2-way split: inexact
    got3 = np.asarray(bell_mod._join3_f64(bell_mod._split3_f32(jnp.asarray(x)), 1))
    np.testing.assert_array_equal(got3, x)  # 3-way split: exact


def _two_sum_f32(a, b):
    """Knuth 2Sum in genuine f32 arithmetic: s + err == a + b exactly."""
    a = np.float32(a)
    b = np.float32(b)
    s = np.float32(a + b)
    bb = np.float32(s - a)
    err = np.float32(np.float32(a - np.float32(s - bb)) + np.float32(b - bb))
    return s, err


def _split3_scalar(x):
    hi = np.float32(x)
    r1 = np.float64(x) - np.float64(hi)
    mid = np.float32(r1)
    lo = np.float32(r1 - np.float64(mid))
    return hi, mid, lo


def test_triple_accum_beats_f64_in_gd_domain():
    """The split-f32 ACCUMULATION, part 1: f32-triple accumulation of f64 terms (Shewchuk
    grow-expansion over 2Sum, components capped at 3 f32s) is at least
    f64-grade — the capped ladder self-spaces at ~24-bit steps, so a
    dropped component sits ~72 bits below the running magnitude, vs the
    53 bits sequential f64 keeps.  On GD-domain data it returns the
    CORRECTLY-ROUNDED sum where sequential f64 accumulation already
    drifts.  The obstruction to the candidate formulation is therefore
    NOT the accumulation (see the companion product test below)."""
    import math

    def accumulate(terms):
        comps: list[np.float32] = []
        for t in terms:
            for p in _split3_scalar(t):  # exact: t enters as 3 f32s
                q = p
                new = []
                for c in comps:
                    q, err = _two_sum_f32(q, c)
                    if err != 0:
                        new.append(err)
                new.append(q)
                comps = new
            if len(comps) > 3:  # cap at a triple, dropping the smallest
                comps.sort(key=abs)
                comps = comps[-3:]
        return math.fsum(float(c) for c in comps)

    rng = np.random.default_rng(29)
    terms = rng.uniform(-10, 10, size=2000)
    terms[::7] *= 1e-4  # GD dynamic range: gradients ~1e-4 x residuals
    exact = math.fsum(terms.tolist())  # correctly rounded
    assert accumulate(terms.tolist()) == exact
    seq = np.float64(0.0)
    for t in terms:
        seq = seq + t
    assert float(seq) != exact  # plain f64 accumulation drops bits here


def test_split_product_f32_cross_terms_not_f64_exact():
    """Part 2, the obstruction: the candidate needs f64-grade PRODUCTS
    (err*g, fo*g) from the f32 triples without touching software f64.
    The 9 cross-products of two split triples span up to 106 bits; in
    plain f32 each cross-product ROUNDS (h1*h2 alone spans 48 bits), so
    even granting an error-free accumulation of all 9 f32 terms, the
    result misses the true f64 product on essentially every
    full-mantissa input.  The exact repair (Dekker 2Prod; jax.lax
    exposes no fma primitive) costs ~17 f32 ops per partial product —
    at or above the ~54-native-flops-per-op cost of XLA's own f64
    emulation (the calibrated 72 G op/s production rate), so the
    formulation cannot beat the emulation it replaces.  DESIGN.md §3.11
    is the full adjudication."""
    import math
    from fractions import Fraction

    rng = np.random.default_rng(31)
    mism = 0
    for _ in range(200):
        x = float(rng.uniform(0.1, 10.0))
        y = float(rng.uniform(0.1, 10.0))
        xs, ys = _split3_scalar(x), _split3_scalar(y)
        # Most charitable FMA-free scheme: every cross-product in f32,
        # then EXACT accumulation of the 9 rounded terms.
        acc = Fraction(0)
        for a in xs:
            for b in ys:
                acc += Fraction(float(np.float32(a) * np.float32(b)))
        mism += float(acc) != x * y
    assert mism >= 195  # ~100%: the scheme is not f64-grade


def test_bell_f64_split_gather_bit_identical():
    """The f64 split-gather path (default for 3k <= 64; chunked sides up
    to 3k <= 128) produces factors BIT-identical to the plain f64
    gather across a full run."""
    from recsys_tpu.ops import bell as bell_mod

    spec = generate_instance(60, 300, 20, 2, 30, iters=40, alpha=0.002, seed=5)
    assert bell_mod._use_split_gather(np.float64, spec.features)
    cfg = RunConfig(dtype="float64", path="bell")
    on = trainer.factorize(spec, cfg)
    saved = bell_mod.SPLIT_GATHER_F64
    try:
        bell_mod.SPLIT_GATHER_F64 = False
        off = trainer.factorize(spec, cfg)
    finally:
        bell_mod.SPLIT_GATHER_F64 = saved
    np.testing.assert_array_equal(np.asarray(on.L), np.asarray(off.L))
    np.testing.assert_array_equal(np.asarray(on.R), np.asarray(off.R))
