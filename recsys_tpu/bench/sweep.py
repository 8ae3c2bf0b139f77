"""Benchmark sweep over the golden instances.

Successor of the reference's ``run-samples.sh`` (builds serial + both
OMP flavors, runs every ``samples/*.in`` at 1..16 threads and greps the
``time :`` line). Here one GPU replaces the thread sweep; each instance
runs in the fastest conformant mode (auto-picked path) and optionally in
exact-f64 mode, and the result is compared against the reference's
published numbers (report-omp.pdf Table 2 / report-mpi.pdf Tables 1-3 —
transcribed in SURVEY.md §6).

Every row names the device it ran on (platform, device_kind, device
count, the card's name and power limit); without a GPU the sweep exits
non-zero.  One process sweeps ONE dtype (x64 mode is a process-global
switch that changes every compiled program, so f64 runs live in their
own process); rows accumulate in a JSONL file and --render merges them
into the markdown table.

Usage:
    python -m recsys_tpu.bench.sweep --dtype float32 --jsonl results.jsonl
        [--instances instML100k,...] [--repeats N]
    python -m recsys_tpu.bench.sweep --render results.jsonl --out sweep.md
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# Published reference timings, seconds (SURVEY.md §6; report-omp.pdf
# Table 2 serial / best over all published parallel configs incl. MPI
# and hybrid). None = not published.
REFERENCE_S = {
    "inst0": (0.001, 0.001),
    "inst1": (0.063, 0.063),
    "inst2": (0.060, 0.060),
    "inst30-40-10-2-10": (0.421, 0.224),
    "inst1000-1000-100-2-30": (18.123, 2.922),
    "inst200-10000-50-100-300": (24.711, 3.043),
    "inst400-50000-30-200-500": (35.813, 3.38),
    "inst50000-5000-100-2-5": (156.984, 25.208),
    "inst500-500-20-2-100": (57.798, 6.46),
    "inst600-10000-10-40-400": (83.490, 11.717),
    "instML100k": (104.930, 13.922),
    "instML1M": (125.201, 8.60),
    # Cluster-only instances: the reference never published serial
    # numbers for these (they only ran at MPI 16-64 ranks,
    # report-mpi.pdf Table 1); best-published is the best across
    # Tables 1-3 (cluster MPI, local MPI, hybrid).
    "inst1000-1e6-1000-1-3": (None, 143.60),  # MPI-64 (211.80@16, 174.89@32)
    "inst1e6-100-700-1-3": (None, 70.34),  # MPI-64 (87.42@16, 86.32@32)
    "inst1000-80000-20-10-1000": (None, 19.04),
    "inst20000-10000-40-2-50": (None, 56.07),
    "inst60000-2000-200-10-20": (None, 11.05),
}

DEFAULT_INSTANCES = [
    "inst0",
    "inst1",
    "inst2",
    "inst30-40-10-2-10",
    "inst500-500-20-2-100",
    "inst1000-1000-100-2-30",
    "inst200-10000-50-100-300",
    "inst600-10000-10-40-400",
    "inst400-50000-30-200-500",
    "instML100k",
    "gen-instML1M",
    "inst50000-5000-100-2-5",
    # The reference's cluster-only extreme shapes (report-mpi.pdf
    # Table 1, MPI-16): the real 1000x1M k=1000 fixture and the 1M-user
    # gen-* analogue of the missing inst1e6-100-700-1-3 blob.
    "inst1000-1e6-1000-1-3",
    "gen-inst1e6-100-700-1-3",
    # The three orphan-golden shapes (outputs survive upstream, inputs
    # missing): gen-* analogues with iteration counts derived from the
    # published MPI-1 walls (GEN_SPECS, io/generator.py).
    "gen-inst1000-80000-20-10-1000",
    "gen-inst20000-10000-40-2-50",
    "gen-inst60000-2000-200-10-20",
]

# f64 exact mode: sparse instances run BELL at any size; instances whose
# f64 path is the dense masked-matmul are skipped above this cell count.
F64_CELL_LIMIT = 4_000_000  # users*items

# bfloat16 acceptance floor: bf16 is a speed mode whose correctness
# claim is argmax agreement with the exact-f64 golden.  Rows measuring
# below this agreement are flagged in the table and must not be quoted
# as wins; rows with no golden cannot be validated and bf16 should not
# be used for them.
BF16_MIN_AGREEMENT = 0.98


def _fixture_dir() -> str:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(here, "tests", "fixtures")


def run_instance(name: str, dtype: str, repeats: int, device: dict):
    from recsys_tpu.bench.roofline import pct_of_roofline
    from recsys_tpu.config import RunConfig
    from recsys_tpu.engine import trainer
    from recsys_tpu.io.parser import load_problem
    from recsys_tpu.utils.timing import collect_phases

    spec = load_problem(os.path.join(_fixture_dir(), f"{name}.in"))
    cfg = RunConfig(dtype=dtype)
    out, _ = trainer.run(spec, cfg)  # warm-up compiles
    walls = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out, _ = trainer.run(spec, cfg)
        walls.append(time.perf_counter() - t0)
    golden_path = os.path.join(_fixture_dir(), f"{name}.out")
    agree = exact = None
    if os.path.exists(golden_path) and os.path.getsize(golden_path):
        golden = open(golden_path).read()
        glines = golden.splitlines()
        agree = sum(x == y for x, y in zip(out.splitlines(), glines)) / max(len(glines), 1)
        exact = out == golden
    wall = min(walls)
    # One more instrumented pass (warm, outside the timed repeats): the
    # per-stage walls separate the steady-state train time from one-shot
    # upload/top-1/prep costs.
    ph: dict = {}
    with collect_phases(ph):
        trainer.run(spec, cfg)
    train_s = ph.get("train")
    chosen = trainer.choose_path(spec, cfg)
    bound, pct = pct_of_roofline(spec, cfg, chosen, train_s, device["device_kind"])
    ma = trainer.train_memory_analysis(spec, cfg)
    row = {
        **device,
        "instance": name,
        "dtype": dtype,
        "path": chosen,
        "wall_s": wall,
        "train_s": train_s,
        "per_iter_ms": None if train_s is None else 1e3 * train_s / max(spec.iters, 1),
        "prep_s": ph.get("prep"),
        "upload_s": ph.get("upload"),
        "top1_s": ph.get("top1"),
        "updates_per_s": spec.iters * spec.nnz / wall,
        "iters": spec.iters,
        "nnz": spec.nnz,
        "users": spec.users,
        "items": spec.items,
        "k": spec.features,
        "golden_exact": exact,
        "agreement": agree,
        "roofline_bound": bound,
        "pct_roofline": pct,
        # XLA's per-program memory analysis, not the runtime peak: the
        # runtime figure is a process-lifetime high-water mark that would
        # attribute an earlier larger instance's peak to later rows.
        "program_mb": None if ma is None else ma["total_bytes"] / 1e6,
    }
    if dtype == "bfloat16":
        row["bf16_below_floor"] = agree is None or agree < BF16_MIN_AGREEMENT
    return row


_DTYPE_ORDER = {"float32": 0, "bfloat16": 1, "float64": 2}


def _row_order(r: dict):
    inst = r["instance"]
    try:
        i = DEFAULT_INSTANCES.index(inst)
    except ValueError:
        i = len(DEFAULT_INSTANCES)
    return (_DTYPE_ORDER.get(r["dtype"], 9), i, inst)


def format_markdown(rows: list[dict]) -> str:
    rows = sorted(rows, key=_row_order)
    lines = [
        "# recsys-tpu benchmark sweep",
        "",
        "Reference numbers: report-omp.pdf Table 2 (serial, 1 Ryzen 1700X core) and the",
        "best published parallel config across all reference tables (SURVEY.md §6) —",
        "including 16-64-rank cluster MPI runs. Each row names the card it ran on and",
        "the card's power limit.",
        "",
        "| instance | dtype | path | device | wall (s) | train (s) | per-iter (ms) | updates/s | vs serial | vs best published | golden | %roofline |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        # gen-* instances are scale-equivalent regenerations of blobs
        # missing upstream; compare against the original's numbers.
        ref = REFERENCE_S.get(r["instance"]) or REFERENCE_S.get(
            r["instance"].removeprefix("gen-")
        )
        vs_serial = f"{ref[0] / r['wall_s']:.1f}x" if ref and ref[0] else "-"
        vs_best = f"{ref[1] / r['wall_s']:.1f}x" if ref and ref[1] else "-"
        if r["golden_exact"]:
            gold = "exact"
        elif r["agreement"] is not None:
            gold = f"{100 * r['agreement']:.2f}%"
        else:
            gold = "-"
        if r.get("bf16_below_floor"):
            gold += " BELOW-FLOOR"
        pct = r.get("pct_roofline")
        rlcol = "-" if pct is None else f"{pct:.3g}% {r.get('roofline_bound', '')}"
        train = r.get("train_s")
        pit = r.get("per_iter_ms")
        lines.append(
            f"| {r['instance']} | {r['dtype']} | {r['path']} | {r.get('gpu', '-')} | "
            f"{r['wall_s']:.4g} | {'-' if train is None else f'{train:.4g}'} | "
            f"{'-' if pit is None else f'{pit:.4g}'} | {r['updates_per_s']:.3g} | "
            f"{vs_serial} | {vs_best} | {gold} | {rlcol} |"
        )
    lines += [
        "",
        "Notes:",
        "- 'train (s)' / 'per-iter (ms)' are the training phase of one",
        "  instrumented pass (utils/timing.py collect_phases); upload, compile",
        "  and top-1 are one-shot costs that dominate short walls.",
        "- '%roofline' is the formulation's least train time on the card",
        "  (bench/roofline.py: FLOPs over the matmul peak or bytes over the",
        "  memory bandwidth, whichever is larger, from the data sheet) over",
        "  the measured train phase.",
        f"- bfloat16 policy: rows must reach {100 * BF16_MIN_AGREEMENT:.0f}% argmax agreement with the",
        "  exact-f64 golden; rows marked BELOW-FLOOR (or without a golden) fail",
        "  the floor and are excluded from headline claims — use float32 there.",
        "- `gen-*` rows are scale-equivalent regenerations of instances whose `.in`",
        "  blobs are missing upstream (see tests/fixtures/README.md).",
        "",
    ]
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="recsys-tpu-sweep")
    ap.add_argument("--dtype", default="float32", choices=["float32", "float64", "bfloat16"])
    ap.add_argument("--out", default=None, help="write a markdown table here")
    ap.add_argument("--jsonl", default=None, help="append JSONL rows here")
    ap.add_argument("--instances", default=None, help="comma-separated subset")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--f64-cell-limit", type=int, default=F64_CELL_LIMIT,
                    help="skip f64 rows above users*items cells")
    ap.add_argument("--render", default=None, help="render this JSONL to --out and exit")
    args = ap.parse_args(argv)

    if args.render:
        rows = [json.loads(l) for l in open(args.render) if l.strip()]
        # Keep the latest row per (instance, dtype): refreshed runs append.
        latest = {(r["instance"], r["dtype"]): r for r in rows}
        md = format_markdown(list(latest.values()))
        if args.out:
            open(args.out, "w").write(md)
        else:
            print(md)
        return 0

    import jax

    from recsys_tpu.bench.device import require_gpu, stamp
    from recsys_tpu.utils.cache import enable_persistent_cache

    require_gpu()
    enable_persistent_cache()
    if args.dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    device = stamp()

    names = args.instances.split(",") if args.instances else DEFAULT_INSTANCES
    # Materialize regenerable gen-* fixtures FIRST: the f64 feasibility
    # filter below reads the .in files.
    from recsys_tpu.io.generator import ensure_fixture

    for name in names:
        ensure_fixture(name, _fixture_dir())
    if args.dtype == "float64":
        names = [n for n in names if _f64_feasible(n, args.f64_cell_limit)]
    rows = []
    for name in names:
        if not os.path.exists(os.path.join(_fixture_dir(), f"{name}.in")):
            print(f"skip {name}: no .in fixture", file=sys.stderr)
            continue
        r = run_instance(name, args.dtype, args.repeats, device)
        rows.append(r)
        print(json.dumps(r), flush=True)
        if args.jsonl:
            with open(args.jsonl, "a") as f:
                f.write(json.dumps(r) + "\n")
        # Drop compiled programs and dead device buffers between
        # instances: shapes never repeat across instances, and the
        # persistent compile cache covers re-runs.
        import gc

        gc.collect()
        jax.clear_caches()
    if args.out:
        with open(args.out, "w") as f:
            f.write(format_markdown(rows))
    return 0


def _f64_feasible(name: str, cell_limit: int) -> bool:
    """f64 rows run wherever the auto path avoids the dense form (BELL
    handles sparse instances at any size); dense-path instances are
    capped by the cell limit, and every f64 run by device memory."""
    import jax

    from recsys_tpu.config import RunConfig
    from recsys_tpu.engine import trainer
    from recsys_tpu.io.parser import load_problem

    path = os.path.join(_fixture_dir(), f"{name}.in")
    if not os.path.exists(path):
        print(f"skip {name}: no .in fixture (f64 filter)", file=sys.stderr)
        return False
    spec = load_problem(path)
    # Both f64 factor tables plus the device un-permute's gather copy
    # must fit: cap at half of the device's memory.
    limit = jax.devices()[0].memory_stats().get("bytes_limit", 0) // 2
    factor_bytes = 2 * 2 * (spec.users + spec.items) * spec.features * 8
    if limit and factor_bytes > limit:
        print(f"skip {name}: f64 factor tables exceed half the device memory",
              file=sys.stderr)
        return False
    if trainer.choose_path(spec, RunConfig(dtype="float64")) != "dense":
        return True
    ok = spec.users * spec.items <= cell_limit
    if not ok:
        print(f"skip {name}: dense-path f64 above the {cell_limit:,}-cell limit",
              file=sys.stderr)
    return ok


if __name__ == "__main__":
    sys.exit(main())
