"""Single-chip JAX engine vs the numpy oracle and the golden fixtures."""

import numpy as np
import pytest

from recsys_tpu.config import RunConfig
from recsys_tpu.engine import trainer
from recsys_tpu.engine.oracle import factorize_numpy, top1_numpy
from recsys_tpu.io.parser import load_problem
from recsys_tpu.io.writers import format_recommendations
from recsys_tpu.models.mf import init_factors

from helpers import FIXTURES, read_golden


def _short_spec(inst, iters):
    import dataclasses

    spec = load_problem(FIXTURES / f"{inst}.in")
    return dataclasses.replace(spec, iters=iters)


@pytest.mark.parametrize("path", ["dense", "coo"])
def test_step_matches_oracle_f64(path):
    """20 GD iterations in f64: JAX paths track the numpy oracle ~exactly."""
    spec = _short_spec("inst30-40-10-2-10", 20)
    oracle_state, _ = factorize_numpy(spec)
    got = trainer.factorize(spec, RunConfig(dtype="float64", path=path))
    np.testing.assert_allclose(np.asarray(got.L), oracle_state.L, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(got.R), oracle_state.R, rtol=1e-12, atol=1e-12)


def test_dense_coo_equivalence_f64():
    spec = _short_spec("inst500-500-20-2-100", 10)
    a = trainer.factorize(spec, RunConfig(dtype="float64", path="dense"))
    b = trainer.factorize(spec, RunConfig(dtype="float64", path="coo"))
    np.testing.assert_allclose(np.asarray(a.L), np.asarray(b.L), rtol=1e-11, atol=1e-12)
    np.testing.assert_allclose(np.asarray(a.R), np.asarray(b.R), rtol=1e-11, atol=1e-12)


@pytest.mark.parametrize("inst", ["inst0", "inst1", "inst2", "inst30-40-10-2-10"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_golden_small(inst, dtype):
    """End-to-end run matches golden .out — including in float32, the
    accelerator speed dtype (argmax outputs are robust to f32 drift on
    these)."""
    spec = load_problem(FIXTURES / f"{inst}.in")
    out, _ = trainer.run(spec, RunConfig(dtype=dtype))
    assert out == read_golden(inst)


def test_top1_blocked_matches_numpy_and_padding():
    """Blockwise masked argmax == dense numpy argmax, items not a block multiple."""
    spec = load_problem(FIXTURES / "inst30-40-10-2-10.in")  # 40 items, block 128 pads
    state = init_factors(spec.users, spec.items, spec.features)
    want = top1_numpy(state.L.copy(), state.R.copy(), spec)
    got = trainer.recommend(state, spec, RunConfig(dtype="float64", block_items=128))
    np.testing.assert_array_equal(got, want)


def test_top1_multi_block_tie_break():
    """Ties across blocks must resolve to the lowest item index."""
    import jax.numpy as jnp

    from recsys_tpu.ops.topk import top1_blocked

    users, items, k, block = 4, 256, 8, 128
    L = np.ones((users, k))
    R = np.ones((items, k))  # every prediction identical -> index 0 wins
    mask = np.zeros((2, users, block), dtype=bool)
    got = top1_blocked(jnp.asarray(L), jnp.asarray(R), jnp.asarray(mask), block)
    np.testing.assert_array_equal(np.asarray(got), [0, 0, 0, 0])
    # Mask item 0 for user 1: winner becomes 1, not something in block 2.
    mask[0, 1, 0] = True
    got = top1_blocked(jnp.asarray(L), jnp.asarray(R), jnp.asarray(mask), block)
    np.testing.assert_array_equal(np.asarray(got), [0, 1, 0, 0])


@pytest.mark.slow
def test_golden_mid_f64():
    """f64 is the exact-conformance mode."""
    spec = load_problem(FIXTURES / "inst500-500-20-2-100.in")
    out, _ = trainer.run(spec, RunConfig(dtype="float64"))
    assert out == read_golden("inst500-500-20-2-100")


@pytest.mark.slow
@pytest.mark.parametrize(
    "inst,min_agreement",
    [("instML100k", 0.98), ("inst500-500-20-2-100", 0.70)],
)
def test_fp32_argmax_agreement(inst, min_agreement):
    """f32 (the speed mode) drifts from the f64 trajectory over
    thousands of iterations; argmax agreement stays high on ML100k
    (measured 932/943) and degrades on the α=1e-3, 10k-iteration
    instance (measured 368/500) — pinned here so regressions surface."""
    spec = load_problem(FIXTURES / f"{inst}.in")
    out, _ = trainer.run(spec, RunConfig(dtype="float32"))
    a = out.splitlines()
    b = read_golden(inst).splitlines()
    assert len(a) == len(b)
    agreement = sum(x == y for x, y in zip(a, b)) / len(b)
    assert agreement >= min_agreement


def test_coo_cumsum_step_matches_scatter_step():
    """The prefix-sum segment reduction equals the scatter form (f64 CPU)."""
    import jax.numpy as jnp
    import numpy as np

    from recsys_tpu.io.generator import generate_instance
    from recsys_tpu.models.mf import init_factors
    from recsys_tpu.ops.coo import (
        coo_gd_step,
        coo_gd_step_cumsum,
        make_coo_inputs,
        make_coo_seg_inputs,
    )

    spec = generate_instance(40, 70, 6, 1, 8, iters=1, alpha=0.01, seed=21)
    st = init_factors(spec.users, spec.items, spec.features)
    L = jnp.asarray(st.L)
    R = jnp.asarray(st.R)
    import jax

    d1 = jax.tree.map(jnp.asarray, make_coo_inputs(spec, dtype=np.float64))
    d2 = jax.tree.map(jnp.asarray, make_coo_seg_inputs(spec, dtype=np.float64))
    a2 = jnp.float64(2 * spec.alpha)
    L1, R1 = coo_gd_step(L, R, d1, a2, spec.users, spec.items)
    L2, R2 = coo_gd_step_cumsum(L, R, d2, a2)
    np.testing.assert_allclose(np.asarray(L1), np.asarray(L2), rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(np.asarray(R1), np.asarray(R2), rtol=1e-12, atol=1e-13)


def test_bfloat16_dense_path_cpu_smoke():
    """bfloat16 on the XLA dense path (f32 factors, bf16 matmul
    operands) produces a plausible recommendation list."""
    from recsys_tpu.config import RunConfig
    from recsys_tpu.engine import trainer
    from recsys_tpu.io.generator import generate_instance

    spec = generate_instance(24, 30, 4, 2, 6, iters=20, alpha=0.01, seed=17)
    assert trainer.choose_path(spec, RunConfig(dtype="bfloat16"), allow_host=False) in ("dense", "coo")
    out, top1 = trainer.run(spec, RunConfig(dtype="bfloat16", path="dense"))
    assert len(top1) == spec.users
    # bf16 should agree with f64 on most argmaxes even at this tiny scale.
    out64, top64 = trainer.run(spec, RunConfig(dtype="float64", path="dense"))
    agree = (top1 == top64).mean()
    assert agree >= 0.8, agree
