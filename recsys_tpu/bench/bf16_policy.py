"""Runtime acceptance policy for the bfloat16 speed mode.

The reference's only speed/accuracy knob is a compile-time flag that is
documented next to its definition (``matFact-omp.c:11-14``); this module is
the analogue for our one lossy mode.  bfloat16 (f32 factors, bf16 matmul
operands) is a speed tier whose claim is argmax agreement with the
exact-f64 golden; the bench enforces a 98% floor when *rendering* rows
(``bench/sweep.py::BF16_MIN_AGREEMENT``), and ``run``/``bench`` in the
CLI must not silently emit sub-floor recommendations either.

``MEASURED`` pins per-instance agreements measured on a GPU, keyed by
problem *shape signature* so the generated and original fixture variants
of one instance share a verdict.  A shape with no measurement gets the
generic warning: bf16 agreement is instance-dependent and must be
validated before its output is trusted.
"""

from __future__ import annotations

import sys

from recsys_tpu.bench.sweep import BF16_MIN_AGREEMENT as FLOOR  # one floor, everywhere

# (users, items, features, iters) -> measured argmax agreement vs exact
# f64, with the card and the run it was measured in.
MEASURED: dict[tuple[int, int, int, int], float] = {
    # instML100k, NVIDIA H100 80GB HBM3 at 400 W, chip_smoke.py.
    (943, 1682, 30, 3000): 0.988335,
}


def lookup(spec) -> float | None:
    """Measured bf16 agreement for this problem shape, or None if unbenched."""
    return MEASURED.get((spec.users, spec.items, spec.features, spec.iters))


def check(spec, strict: bool = False, file=None) -> bool:
    """Warn (stderr) about bf16 accuracy for ``spec``; False if refused.

    Returns True when the run may proceed.  With ``strict``, refuses any
    shape whose measured agreement is below ``FLOOR`` or that has no
    measured agreement at all.
    """
    file = sys.stderr if file is None else file
    agree = lookup(spec)
    hint = "use --dtype float32 for true-f32 products"
    if agree is None:
        print(
            "warning: bfloat16 is a lossy speed mode with no measured argmax "
            f"agreement for this problem shape (floor: {FLOOR:.0%}); "
            "validate against --dtype float64 before trusting the output, or "
            + hint,
            file=file,
        )
        return not strict
    if agree < FLOOR:
        print(
            f"warning: bfloat16 measured only {agree:.2%} argmax agreement with "
            f"the exact-f64 output on this problem shape (acceptance floor: "
            f"{FLOOR:.0%}); " + hint,
            file=file,
        )
        return not strict
    print(
        f"note: bfloat16 speed mode — measured {agree:.2%} argmax agreement "
        f"with exact f64 on this problem shape (floor: {FLOOR:.0%})",
        file=file,
    )
    return True
