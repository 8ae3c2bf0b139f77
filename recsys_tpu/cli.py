"""Command-line interface.

Replaces the reference's four binaries + Makefile + run-samples.sh
(``Makefile:13-23``, ``run-samples.sh``) with one entry point:

    python -m recsys_tpu.cli run <file.in> [--dtype ...] [--path ...]
    python -m recsys_tpu.cli oracle <file.in>
    python -m recsys_tpu.cli bench <file.in> [--repeats N]
    python -m recsys_tpu.cli generate inst<u>-<i>-<k>-<min>-<max> ...

``run`` reproduces the reference binaries' stdout contract: one top-1
item index per user, then a ``time : <seconds>`` line
(``matFact.c:127,134``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _add_common(p):
    p.add_argument("input", help="path to .in instance file")
    p.add_argument(
        "-v", "--verbose", action="store_true",
        help="print dataset/config info to stderr (print_dataset_info analogue)",
    )
    p.add_argument(
        "--dtype", default=None,
        help="float32|float64|bfloat16 (default: f32 on an accelerator, f64 on CPU)",
    )
    p.add_argument("--path", default="auto", choices=["auto", "dense", "bell", "coo"])
    p.add_argument("--mesh", default=None, help="RxC mesh override, e.g. 4x2 (multi-device)")
    p.add_argument("--block-items", type=int, default=4096)
    p.add_argument("--no-time", action="store_true", help="suppress the trailing time line")
    p.add_argument(
        "--strict", action="store_true",
        help="refuse lossy modes below their measured acceptance floor "
        "(bfloat16 on shapes measured below 98%% argmax agreement, or unmeasured shapes)",
    )


def main(argv=None):
    ap = argparse.ArgumentParser(prog="recsys-tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    run_p = sub.add_parser("run", help="factorize + print top-1 recommendations")
    _add_common(run_p)
    run_p.add_argument("--checkpoint", metavar="PATH", default=None, help="snapshot/resume file")
    run_p.add_argument("--checkpoint-every", type=int, default=500, metavar="N", help="iterations between snapshots")
    run_p.add_argument("--profile", metavar="DIR", default=None, help="write a jax profiler trace here")

    orc_p = sub.add_parser("oracle", help="numpy float64 reference engine")
    orc_p.add_argument("input")
    orc_p.add_argument("--no-time", action="store_true")
    orc_p.add_argument(
        "--dump-mats",
        metavar="PATH",
        default=None,
        help="write the .mats debug dump (initial/per-iter/final L,R,B) and exit",
    )
    orc_p.add_argument("--record", type=int, default=5, help="iterations to record in the dump")

    bench_p = sub.add_parser("bench", help="timed run, JSON metrics line")
    _add_common(bench_p)
    bench_p.add_argument("--repeats", type=int, default=3)

    gen_p = sub.add_parser("generate", help="generate an instance file")
    gen_p.add_argument("name", help="inst<users>-<items>-<k>-<minnz>-<maxnz>")
    gen_p.add_argument("out", help="output .in path")
    gen_p.add_argument("--iters", type=int, default=100)
    gen_p.add_argument("--alpha", type=float, default=0.0001)
    gen_p.add_argument("--seed", type=int, default=42)

    args = ap.parse_args(argv)

    if args.cmd == "generate":
        return _cmd_generate(args)

    # dtype default: conformance-grade f64 on CPU, fast f32 on accelerators.
    if getattr(args, "dtype", None) is None:
        import jax

        args.dtype = "float32" if jax.default_backend() != "cpu" else "float64"
    if getattr(args, "dtype", None) == "float64":
        os.environ.setdefault("JAX_ENABLE_X64", "1")
        import jax

        jax.config.update("jax_enable_x64", True)
    from recsys_tpu.io.parser import load_problem
    from recsys_tpu.utils.cache import enable_persistent_cache
    from recsys_tpu.utils.timing import Timer

    enable_persistent_cache()

    if args.cmd == "oracle":
        from recsys_tpu.engine.oracle import dump_mats, run_oracle

        if args.dump_mats:
            spec = load_problem(args.input)
            with open(args.dump_mats, "w") as f:
                f.write(dump_mats(spec, record=args.record))
            return 0
        with Timer() as t:
            spec = load_problem(args.input)
            out = run_oracle(spec)
        sys.stdout.write(out)
        if not args.no_time:
            print(t.line())
        return 0

    from recsys_tpu.config import RunConfig
    from recsys_tpu.engine import trainer

    mesh_shape = None
    if args.mesh:
        r, c = args.mesh.lower().split("x")
        mesh_shape = (int(r), int(c))
    cfg = RunConfig(
        dtype=args.dtype, path=args.path, mesh_shape=mesh_shape,
        block_items=args.block_items,
    )

    def _banner(spec):
        # The reference's print_dataset_info (datatypes.c:19-24), on stderr
        # so the stdout contract stays clean; also names the path the
        # engine picks and the device it runs on.
        if getattr(args, "verbose", False):
            import jax

            n = 1 if mesh_shape is None else mesh_shape[0] * mesh_shape[1]
            path = trainer.choose_path(spec, cfg, n_devices=n, allow_host=mesh_shape is None)
            dev = jax.devices()[0]
            print(
                f"dataset: {spec.users}x{spec.items} k={spec.features} "
                f"nnz={spec.nnz} iters={spec.iters} alpha={spec.alpha} | "
                f"dtype={cfg.dtype} path={path} platform={dev.platform} "
                f"kind={dev.device_kind} devices={jax.device_count()}",
                file=sys.stderr,
            )

    if args.cmd == "run":
        import contextlib

        prof = contextlib.nullcontext()
        if args.profile:
            import jax

            prof = jax.profiler.trace(args.profile)
        with prof, Timer() as t:
            spec = load_problem(args.input)
            _banner(spec)
            if not _bf16_gate(spec, cfg, args):
                return 2
            if args.checkpoint:
                from recsys_tpu.engine import trainer
                from recsys_tpu.utils.checkpoint import run_with_checkpoints

                state = run_with_checkpoints(spec, cfg, args.checkpoint, args.checkpoint_every)
                top1 = trainer.recommend(state, spec, cfg)
                from recsys_tpu.io.writers import format_recommendations

                out = format_recommendations(top1, spec.rated_counts(), spec.items)
            else:
                out, _ = _dispatch_run(spec, cfg)
        sys.stdout.write(out)
        if not args.no_time:
            print(t.line())
        return 0

    if args.cmd == "bench":
        spec = load_problem(args.input)
        _banner(spec)
        if not _bf16_gate(spec, cfg, args):
            return 2
        # Warm-up run compiles everything.
        _dispatch_run(spec, cfg)
        times = []
        for _ in range(args.repeats):
            with Timer() as t:
                _dispatch_run(spec, cfg)
            times.append(t.seconds)
        import jax

        best = min(times)
        updates = spec.iters * spec.nnz
        dev = jax.devices()[0]
        print(
            json.dumps(
                {
                    "instance": os.path.basename(args.input),
                    "wall_s": best,
                    "updates_per_s": updates / best,
                    "dtype": cfg.dtype,
                    "path": trainer.choose_path(spec, cfg),
                    "repeats": args.repeats,
                    "platform": dev.platform,
                    "device_kind": dev.device_kind,
                    "device_count": jax.device_count(),
                }
            )
        )
        return 0
    return 1


def _bf16_gate(spec, cfg, args) -> bool:
    """bfloat16 acceptance gate shared by run/bench (bf16_policy): warn
    with the benched per-shape agreement; False = refused under --strict."""
    if cfg.dtype != "bfloat16":
        return True
    from recsys_tpu.bench.bf16_policy import check

    if check(spec, strict=args.strict):
        return True
    print("error: refusing bfloat16 under --strict", file=sys.stderr)
    return False


def _dispatch_run(spec, cfg):
    from recsys_tpu.engine import trainer

    if cfg.mesh_shape is not None:
        from recsys_tpu.parallel import engine as parallel_engine

        return parallel_engine.run(spec, cfg)
    return trainer.run(spec, cfg)


def _cmd_generate(args):
    from recsys_tpu.io.generator import generate_instance, parse_instance_name
    from recsys_tpu.io.parser import save_problem

    u, i, k, lo, hi = parse_instance_name(args.name)
    spec = generate_instance(u, i, k, lo, hi, iters=args.iters, alpha=args.alpha, seed=args.seed)
    save_problem(spec, args.out)
    print(f"wrote {args.out}: {u}x{i} k={k} nnz={spec.nnz}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
