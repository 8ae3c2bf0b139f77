"""Is float32 really f32 on the device?  The dense step against f64.

XLA's default for an f32 matmul on a GPU is TF32 (10 mantissa bits).
The engine asks for ``Precision.HIGHEST`` everywhere
(``trainer.matmul_precision``); this check runs the dense training
step (``ops/dense.dense_gd_step``) at an instance's full widths on the
default device for 1 and 50 steps and compares the factors with the
numpy float64 oracle (``engine/oracle.factorize_numpy``).  For contrast
it also runs the same step at the device's default precision and
prints that error too: on a GPU it should fail the tolerance.  It also
prints XLA's memory analysis of the train step.

    python -m recsys_tpu.bench.precision [--instance gen-instML1M]

Exits non-zero when the HIGHEST-precision step misses the tolerance.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from functools import partial

import jax

# f32 against the f64 oracle: the factors are ~0.1-1 and each step's
# masked error and products round at f32's 2^-24 (~6e-8) relative, so
# 50 steps stay near 1e-6; rtol 1e-5 leaves a 10x margin.  A TF32
# product (2^-11, ~5e-4 relative) misses it by orders of magnitude.
# atol covers factor entries that pass near zero.
RTOL, ATOL = 1e-5, 1e-6


def _fixture(name: str) -> str:
    from recsys_tpu.io.generator import ensure_fixture

    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return ensure_fixture(name, os.path.join(here, "tests", "fixtures"))


@partial(jax.jit, static_argnames=("iters",))
def _train_device_default(L, R, A, M, alpha2, iters):
    """The dense step at the device's DEFAULT matmul precision."""

    def body(_, c):
        L, R = c
        E = M * (A - L @ R.T)
        return L + alpha2 * (E @ R), R + alpha2 * (E.T @ L)

    return jax.lax.fori_loop(0, iters, body, (L, R))


def max_rel_err(got, want) -> float:
    import numpy as np

    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))


def check(name: str, steps=(1, 50)) -> bool:
    """Dense f32 step vs the f64 oracle at ``name``'s widths."""
    import jax.numpy as jnp
    import numpy as np

    from recsys_tpu.engine.oracle import factorize_numpy
    from recsys_tpu.engine.trainer import _train_dense
    from recsys_tpu.io.parser import load_problem
    from recsys_tpu.models.mf import init_factors
    from recsys_tpu.ops.dense import make_dense_inputs

    spec = load_problem(_fixture(name))
    state = init_factors(spec.users, spec.items, spec.features)
    A, M = (jnp.asarray(x) for x in make_dense_inputs(spec, dtype=jnp.float32))
    alpha2 = jnp.float32(2.0 * spec.alpha)

    def fresh():
        return jnp.asarray(state.L, jnp.float32), jnp.asarray(state.R, jnp.float32)

    ma = _train_dense.lower(*fresh(), A, M, alpha2, spec.iters, "highest").compile().memory_analysis()
    print(
        f"precision {name}: {spec.users}x{spec.items} k={spec.features}; train step "
        f"memory_analysis argument={ma.argument_size_in_bytes} temp={ma.temp_size_in_bytes} "
        f"output={ma.output_size_in_bytes} bytes",
        flush=True,
    )
    ok = True
    for n in steps:
        ref, _ = factorize_numpy(dataclasses.replace(spec, iters=n), state=state)
        for label, train in (
            ("highest", lambda: _train_dense(*fresh(), A, M, alpha2, n, "highest")),
            ("device default", lambda: _train_device_default(*fresh(), A, M, alpha2, n)),
        ):
            L, R = train()
            err = max(max_rel_err(np.asarray(L), ref.L), max_rel_err(np.asarray(R), ref.R))
            within = bool(
                np.allclose(np.asarray(L), ref.L, rtol=RTOL, atol=ATOL)
                and np.allclose(np.asarray(R), ref.R, rtol=RTOL, atol=ATOL)
            )
            if label == "highest":
                ok &= within
            print(
                f"precision {name}: {n:>2} steps f32 {label:<14} vs f64 oracle: max rel err "
                f"{err:.3e} (tolerance rtol {RTOL:g} atol {ATOL:g}) {'ok' if within else 'FAIL'}",
                flush=True,
            )
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser(prog="recsys-tpu-precision")
    ap.add_argument("--instance", default="gen-instML1M")
    args = ap.parse_args(argv)

    from recsys_tpu.bench.device import require_gpu, stamp
    from recsys_tpu.utils.cache import enable_persistent_cache

    require_gpu()
    enable_persistent_cache()
    print(f"device: {stamp()}", flush=True)
    return 0 if check(args.instance) else 1


if __name__ == "__main__":
    sys.exit(main())
