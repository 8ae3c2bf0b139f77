#!/usr/bin/env python3
"""Smoke test of the recommender on the GPU, through its normal entry points.

    python chip_smoke.py          # one card
    python chip_smoke.py --four   # the sharded path on four cards, only

The parent process never imports JAX: every phase runs as a child, one
after another, so one process holds the card at a time (a JAX process
reserves most of the card's memory when it starts).  x64 stays per
process — the float64 phases need it process-wide — and all children
share the one persistent compile cache (``recsys_tpu/utils/cache.py``).

One card:

1. precision — the dense training step at gen-instML1M widths
   (6040x3952, k=30) in f32 on the card, 1 and 50 steps, against the
   numpy float64 oracle (``recsys_tpu.bench.precision``): proves that
   float32 means true f32 products and not TF32.
2. the main path, ``python -m recsys_tpu.cli run <instance> --verbose``,
   twice per phase (the second run is warm: compiled programs come from
   the cache), on instML100k (f64, f32, bf16), gen-instML1M (f64, f32)
   and inst50000-5000-100-2-5 (f64, f32).  float64 must reproduce the
   golden .out byte for byte; float32 must agree on at least 99% of the
   top-1 lines; bfloat16's agreement is printed.

``--four``: ``cli run --mesh 2x2`` on gen-instML1M f32 (sharded dense)
and on inst50000-5000-100-2-5 in f32 and f64 (sharded BELL), each
compared with its golden and with the one-card output of the same run
on device 0; no other phase.

Every phase must run on the GPU and on a device path (never the
host-serial engine).  Any failure exits non-zero and prints no result
line.  The last line of a passing run is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
CHILD_TIMEOUT_S = 300
F32_MIN_AGREEMENT = 0.99

# (instance, dtype) phases of the one-card run.
PHASES = [
    ("instML100k", "float64"),
    ("instML100k", "float32"),
    ("instML100k", "bfloat16"),
    ("gen-instML1M", "float64"),
    ("gen-instML1M", "float32"),
    ("inst50000-5000-100-2-5", "float64"),
    ("inst50000-5000-100-2-5", "float32"),
]
# (instance, dtype) phases of --four, each run as --mesh 2x2.
FOUR_PHASES = [
    ("gen-instML1M", "float32"),
    ("inst50000-5000-100-2-5", "float32"),
    ("inst50000-5000-100-2-5", "float64"),
]

_BANNER = re.compile(r"path=(\S+) platform=(\S+) kind=(.+) devices=(\d+)")


class PhaseError(RuntimeError):
    pass


def child(args, env=None, timeout=CHILD_TIMEOUT_S) -> subprocess.CompletedProcess:
    """Run one child to its end (killed at ``timeout``); raise on failure."""
    p = subprocess.run(
        [sys.executable, *args], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=timeout,
    )
    if p.returncode != 0:
        tail = "\n".join((p.stdout + p.stderr).splitlines()[-15:])
        raise PhaseError(f"{' '.join(args)} exited {p.returncode}:\n{tail}")
    return p


def device_probe() -> dict:
    """Platform, device_kind and device count as a JAX child sees them."""
    code = (
        "import json, jax; d = jax.devices()[0]; "
        "print(json.dumps({'platform': d.platform, 'kind': d.device_kind, "
        "'count': len(jax.devices())}))"
    )
    out = child(["-c", code]).stdout.strip().splitlines()[-1]
    return json.loads(out)


def golden(instance: str) -> str:
    with open(os.path.join(FIXTURES, f"{instance}.out")) as f:
        return f.read()


def agreement(out: str, want: str) -> float:
    a, b = out.splitlines(), want.splitlines()
    return sum(x == y for x, y in zip(a, b)) / max(len(b), 1)


def cli_run(instance: str, dtype: str, mesh: str | None = None, env=None):
    """One ``cli run``: (stdout without the time line, wall s, path, platform)."""
    args = ["-m", "recsys_tpu.cli", "run", os.path.join(FIXTURES, f"{instance}.in"),
            "--dtype", dtype, "--verbose"]
    if mesh:
        args += ["--mesh", mesh]
    p = child(args, env=env)
    m = _BANNER.search(p.stderr)
    if m is None:
        raise PhaseError(f"{instance} {dtype}: no banner on stderr:\n{p.stderr[-2000:]}")
    path, platform = m.group(1), m.group(2)
    lines = p.stdout.splitlines(keepends=True)
    if not lines or not lines[-1].startswith("time : "):
        raise PhaseError(f"{instance} {dtype}: no time line")
    wall = float(lines[-1].split(":")[1])
    return "".join(lines[:-1]), wall, path, platform


def check_phase(instance, dtype, out, path, platform, label) -> str:
    """Raise unless the run was on the GPU, on a device path, and right."""
    if platform != "gpu":
        raise PhaseError(f"{label}: ran on {platform!r}, not the GPU")
    if path == "host":
        raise PhaseError(f"{label}: took the host-serial path")
    want = golden(instance)
    if dtype == "float64":
        if out != want:
            raise PhaseError(
                f"{label}: f64 output differs from the golden "
                f"(agreement {agreement(out, want):.6f})"
            )
        return "byte-identical to the golden"
    agree = agreement(out, want)
    if dtype == "float32" and agree < F32_MIN_AGREEMENT:
        raise PhaseError(f"{label}: f32 agreement {agree:.6f} < {F32_MIN_AGREEMENT}")
    return f"argmax agreement with the golden {agree:.6f}"


def one_card() -> None:
    p = child(["-m", "recsys_tpu.bench.precision", "--instance", "gen-instML1M"])
    for line in p.stdout.splitlines():
        if line.startswith(("precision", "device")):
            print(line, flush=True)
    for instance, dtype in PHASES:
        out, cold, path, platform = cli_run(instance, dtype)
        out, warm, path, platform = cli_run(instance, dtype)
        label = f"{instance} {dtype}"
        verdict = check_phase(instance, dtype, out, path, platform, label)
        print(
            f"phase {label}: path={path} platform={platform} wall cold {cold:.3f} s "
            f"warm {warm:.3f} s; {verdict}",
            flush=True,
        )


def four_cards() -> None:
    one = dict(os.environ, CUDA_VISIBLE_DEVICES="0")
    for instance, dtype in FOUR_PHASES:
        label = f"{instance} {dtype} mesh 2x2"
        out4, wall4, path4, plat4 = cli_run(instance, dtype, mesh="2x2")
        verdict = check_phase(instance, dtype, out4, path4, plat4, label)
        out1, wall1, path1, plat1 = cli_run(instance, dtype, env=one)
        check_phase(instance, dtype, out1, path1, plat1, f"{instance} {dtype} one card")
        same = agreement(out4, out1)
        if dtype == "float64" and out4 != out1:
            raise PhaseError(f"{label}: f64 output differs from the one-card output")
        if same < F32_MIN_AGREEMENT:
            raise PhaseError(f"{label}: agreement with the one-card output {same:.6f}")
        print(
            f"phase {label}: path={path4} platform={plat4} wall {wall4:.3f} s; {verdict}; "
            f"one card (device 0, path={path1}) wall {wall1:.3f} s; "
            f"agreement with the one-card output {same:.6f}",
            flush=True,
        )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="chip_smoke")
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded path on four cards (--mesh 2x2)")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(ROOT, "recsys_tpu")):
        print("chip_smoke: the recsys_tpu package is not next to this script", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        print(f"chip_smoke: nvidia-smi failed ({e}); no GPU", file=sys.stderr)
        return 2
    if smi.returncode != 0 or not smi.stdout.strip():
        print(f"chip_smoke: nvidia-smi found no GPU: {smi.stderr.strip()}", file=sys.stderr)
        return 2
    print(smi.stdout.strip(), flush=True)
    try:
        device = device_probe()
        print(f"device: {json.dumps(device)}", flush=True)
        if device["platform"] != "gpu":
            raise PhaseError(f"JAX found no GPU (platform {device['platform']!r})")
        want = 4 if args.four else 1
        if device["count"] < want:
            raise PhaseError(f"needs {want} GPUs, JAX sees {device['count']}")
        # gen-* fixtures are regenerated byte-exactly from their table.
        child(["-c", "from recsys_tpu.io.generator import ensure_fixture; "
               f"ensure_fixture('gen-instML1M', {FIXTURES!r})"])
        four_cards() if args.four else one_card()
    except (PhaseError, subprocess.TimeoutExpired) as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"], "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
