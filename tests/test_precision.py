"""One matmul-precision mapping, checked in the traced programs.

On a GPU, XLA runs an f32 matmul at TF32 unless told otherwise, so
"float32" must carry ``Precision.HIGHEST`` into every product of the
dense step, the top-1 scans and the sharded steps; "bfloat16" means
f32 factors and accumulation with bf16 operands.  These tests read the
jaxprs, so they hold on any backend.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from recsys_tpu.config import RunConfig
from recsys_tpu.engine import trainer
from recsys_tpu.ops.dense import dense_gd_step, matmul
from recsys_tpu.ops.topk import top1_blocked, top1_rated_scan
from recsys_tpu.parallel import step
from recsys_tpu.parallel.mesh import AXIS_ITEMS, AXIS_USERS

U, I, K, BLOCK = 16, 32, 8, 16


def _dots(jaxpr):
    """Every dot_general in a (closed) jaxpr, through nested jaxprs."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for v in eqn.params.values():
            for x in v if isinstance(v, (tuple, list)) else (v,):
                if hasattr(x, "eqns"):
                    yield from _dots(x)


def _mesh():
    devs = np.asarray(jax.devices()[:8]).reshape(2, 4)
    return Mesh(devs, (AXIS_USERS, AXIS_ITEMS))


def _sds(shape, dtype=jnp.float32):
    return jax.ShapeDtypeStruct(shape, dtype)


def _programs(precision):
    """(name, fn, example args) of every program with a matmul."""
    f32 = jnp.float32
    L, R, A = _sds((U, K)), _sds((I, K)), _sds((U, I))
    rated = _sds((U, 3), jnp.int32)
    mask = _sds((I // BLOCK, U, BLOCK), jnp.bool_)
    mesh = _mesh()
    return [
        ("dense_gd_step", lambda l, r, a: dense_gd_step(l, r, a, a, f32(0.1), precision), (L, R, A)),
        ("train_dense", lambda l, r, a: trainer._train_dense(l, r, a, a, f32(0.1), 2, precision), (L, R, A)),
        ("top1_blocked", lambda l, r, m: top1_blocked(l, r, m, BLOCK, precision), (L, R, mask)),
        ("top1_rated_scan", lambda l, r, t: top1_rated_scan(l, r, t, BLOCK, I, 0, precision), (L, R, rated)),
        ("sharded_dense_train", step.make_dense_train(mesh, f32(0.1), 2, precision), (L, R, A, A)),
        ("sharded_top1", step.make_sharded_top1(mesh, I // 4, precision), (L, R, _sds((U, I), jnp.bool_))),
        ("sharded_top1_rated", step.make_sharded_top1_rated(mesh, I // 4, I, 8, precision), (L, R, rated)),
    ]


PROGRAMS = [name for name, _, _ in _programs("highest")]


@pytest.mark.parametrize("name", PROGRAMS)
def test_f32_products_are_highest(name):
    fn, args = {n: (f, a) for n, f, a in _programs("highest")}[name]
    dots = list(_dots(jax.make_jaxpr(fn)(*args)))
    assert dots, name
    for eqn in dots:
        assert eqn.invars[0].aval.dtype == jnp.float32
        assert eqn.params["precision"] == (jax.lax.Precision.HIGHEST,) * 2, name


@pytest.mark.parametrize("name", PROGRAMS)
def test_bf16_products_round_operands_accumulate_f32(name):
    fn, args = {n: (f, a) for n, f, a in _programs("bf16")}[name]
    dots = list(_dots(jax.make_jaxpr(fn)(*args)))
    assert dots, name
    for eqn in dots:
        assert {v.aval.dtype for v in eqn.invars} == {jnp.dtype(jnp.bfloat16)}
        assert eqn.params["preferred_element_type"] == jnp.float32, name


@pytest.mark.parametrize(
    "dtype,want", [("float32", "highest"), ("float64", "highest"), ("bfloat16", "bf16")]
)
def test_matmul_precision_mapping(dtype, want):
    assert trainer.matmul_precision(RunConfig(dtype=dtype)) == want


@pytest.mark.parametrize(
    "dtype,path,want",
    [
        ("bfloat16", "dense", jnp.float32),  # bf16 operands, f32 storage
        ("bfloat16", "bell", jnp.bfloat16),  # sparse tables keep the dtype
        ("float32", "dense", jnp.float32),
        ("float64", "coo", jnp.float64),
    ],
)
def test_factor_dtype(dtype, path, want):
    assert trainer.factor_dtype(RunConfig(dtype=dtype), path) == want


@pytest.mark.parametrize(
    "dtype,nnz_ge_dims,want",
    [("float32", True, True), ("bfloat16", True, True), ("float32", False, False), ("float64", True, False)],
)
def test_coo_use_cumsum_rule(dtype, nnz_ge_dims, want):
    """One rule, no backend name: speed dtypes take the prefix-sum form
    when nnz dominates the dimensions; exact f64 keeps the scatter."""
    from recsys_tpu.io.generator import generate_instance

    spec = generate_instance(20, 30, 4, 3, 6, iters=1, alpha=0.01, seed=1)
    if not nnz_ge_dims:
        spec = generate_instance(200, 3000, 4, 1, 2, iters=1, alpha=0.01, seed=1)
    assert (spec.nnz >= spec.users + spec.items) == nnz_ge_dims
    assert trainer.coo_use_cumsum(spec, RunConfig(dtype=dtype)) == want


def test_bf16_dense_run_keeps_f32_factors():
    from recsys_tpu.io.generator import generate_instance

    spec = generate_instance(24, 30, 4, 2, 6, iters=5, alpha=0.01, seed=17)
    st = trainer.factorize(spec, RunConfig(dtype="bfloat16", path="dense"))
    assert st.L.dtype == jnp.float32 and st.R.dtype == jnp.float32
    f32 = trainer.factorize(spec, RunConfig(dtype="float32", path="dense"))
    # bf16 operands round each product (~4e-3 relative), not the storage.
    np.testing.assert_allclose(np.asarray(st.L), np.asarray(f32.L), rtol=2e-2, atol=1e-3)
    assert not np.array_equal(np.asarray(st.L), np.asarray(f32.L))


def test_matmul_bf16_is_the_product_of_rounded_operands():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((8, 16)).astype(np.float32)
    b = rng.standard_normal((16, 4)).astype(np.float32)
    got = np.asarray(matmul(jnp.asarray(a), jnp.asarray(b), "bf16"))
    ar = np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32), np.float64)
    br = np.asarray(jnp.asarray(b).astype(jnp.bfloat16).astype(jnp.float32), np.float64)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ar @ br, rtol=1e-5, atol=1e-5)
