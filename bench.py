#!/usr/bin/env python3
"""Headline benchmark: instML100k end to end on the GPU, one JSON line.

Runs the flagship instance (instML100k: 943x1682, k=30, 100k ratings,
3000 full-batch GD iterations — the largest published fixture whose
.in survives) through ``trainer.run`` on the default JAX device and
prints ONE JSON line.  Three modes are measured in this one process:

  * float64 — exact-conformance mode (golden output byte-match);
  * float32 — speed mode (argmax agreement with the golden reported);
  * bfloat16 — f32 factors with bf16 matmul operands (agreement reported).

Headline metric: the exact-conformance (f64) end-to-end wall, against
the reference's all-f64 serial 104.930 s (report-omp.pdf Table 2;
BASELINE.md).  Every row names the device it ran on; without a GPU the
script exits non-zero and prints no row.

    python bench.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BASELINE_SERIAL_S = 104.930  # report-omp.pdf Table 2, instML100k serial
BASELINE_BEST_S = 13.922  # report-omp.pdf Table 2, instML100k OMP-8
FIXTURE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures", "instML100k.in"
)


def timed_run(spec, cfg, repeats=2):
    from recsys_tpu.engine import trainer

    out, _ = trainer.run(spec, cfg)  # warm-up: compiles everything
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out, _ = trainer.run(spec, cfg)
        times.append(time.perf_counter() - t0)
    return min(times), out


def main():
    import jax

    from recsys_tpu.bench.device import require_gpu, stamp

    require_gpu()
    jax.config.update("jax_enable_x64", True)

    from recsys_tpu.config import RunConfig
    from recsys_tpu.io.parser import load_problem
    from recsys_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    spec = load_problem(FIXTURE)
    golden = open(FIXTURE[: -len(".in")] + ".out").read()
    glines = golden.splitlines()

    def agreement(out):
        return sum(x == y for x, y in zip(out.splitlines(), glines)) / len(glines)

    wall64, out64 = timed_run(spec, RunConfig(dtype="float64"))
    wall32, out32 = timed_run(spec, RunConfig(dtype="float32"))
    wall16, out16 = timed_run(spec, RunConfig(dtype="bfloat16"))
    row = {
        "metric": "instML100k_end_to_end_wall_f64_exact",
        "value": wall64,
        "unit": "s",
        "vs_baseline": BASELINE_SERIAL_S / wall64,
        "golden_match_f64": out64 == golden,
        "wall_f32_s": wall32,
        "argmax_agreement_f32": agreement(out32),
        "wall_bf16_s": wall16,
        "argmax_agreement_bf16": agreement(out16),
        "vs_best_published_f64": BASELINE_BEST_S / wall64,
        "updates_per_s_f64": spec.iters * spec.nnz / wall64,
        "updates_per_s_f32": spec.iters * spec.nnz / wall32,
        **stamp(),
    }
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
