"""CLI surface (argument wiring, stdout contract) on the CPU backend."""

import io
import sys

import pytest

from recsys_tpu import cli

from helpers import FIXTURES


def _run_cli(argv, capsys):
    rc = cli.main(argv)
    out = capsys.readouterr().out
    return rc, out


def test_run_stdout_contract(capsys):
    rc, out = _run_cli(["run", str(FIXTURES / "inst0.in"), "--dtype", "float64"], capsys)
    assert rc == 0
    lines = out.splitlines()
    golden = open(FIXTURES / "inst0.out").read().splitlines()
    assert lines[: len(golden)] == golden
    assert lines[len(golden)].startswith("time : ")


def test_run_no_time(capsys):
    rc, out = _run_cli(
        ["run", str(FIXTURES / "inst0.in"), "--dtype", "float64", "--no-time"], capsys
    )
    assert rc == 0
    assert out == open(FIXTURES / "inst0.out").read()


def test_oracle_matches_golden(capsys):
    rc, out = _run_cli(["oracle", str(FIXTURES / "inst0.in"), "--no-time"], capsys)
    assert rc == 0
    assert out == open(FIXTURES / "inst0.out").read()


def test_oracle_dump_mats(tmp_path, capsys):
    dst = tmp_path / "o.mats"
    rc, _ = _run_cli(
        ["oracle", str(FIXTURES / "inst1.in"), "--dump-mats", str(dst), "--record", "0"],
        capsys,
    )
    assert rc == 0
    assert dst.read_text() == open(FIXTURES / "inst1.mats").read()


def test_generate_roundtrip(tmp_path, capsys):
    dst = tmp_path / "g.in"
    rc, _ = _run_cli(["generate", "inst20-30-4-1-5", str(dst), "--iters", "7"], capsys)
    assert rc == 0
    from recsys_tpu.io.parser import load_problem

    spec = load_problem(str(dst))
    assert (spec.users, spec.items, spec.features, spec.iters) == (20, 30, 4, 7)
    # Entries row-major sorted (the format invariant).
    import numpy as np

    assert np.all(np.diff(spec.rows) >= 0)


def test_run_with_checkpoint(tmp_path, capsys):
    ck = tmp_path / "ck.npz"
    rc, out = _run_cli(
        ["run", str(FIXTURES / "inst0.in"), "--dtype", "float64", "--no-time",
         "--checkpoint", str(ck), "--checkpoint-every", "2000"],
        capsys,
    )
    assert rc == 0
    assert out == open(FIXTURES / "inst0.out").read()
    from recsys_tpu.utils.checkpoint import load

    assert load(str(ck)).completed_iters == 5000


def test_bench_emits_json(capsys):
    rc, out = _run_cli(
        ["bench", str(FIXTURES / "inst0.in"), "--dtype", "float64", "--repeats", "1"],
        capsys,
    )
    assert rc == 0
    import json

    row = json.loads(out.splitlines()[-1])
    assert row["instance"] == "inst0.in" and row["updates_per_s"] > 0
    assert row["platform"] == "cpu" and row["device_count"] >= 1 and row["device_kind"]


def test_bf16_below_floor_warns_and_strict_refuses(capsys, monkeypatch):
    """bf16 on a shape measured below the floor must not run silently:
    plain run warns with the measured agreement, --strict refuses
    before training."""
    from recsys_tpu.bench import bf16_policy

    monkeypatch.setitem(bf16_policy.MEASURED, (500, 500, 20, 10000), 0.736)
    rc = cli.main(["run", str(FIXTURES / "inst500-500-20-2-100.in"),
                   "--dtype", "bfloat16", "--strict", "--no-time"])
    captured = capsys.readouterr()
    assert rc == 2
    assert captured.out == ""  # refused before any recommendation line
    assert "73.60% argmax agreement" in captured.err
    assert "--dtype float32" in captured.err


def test_bf16_unknown_shape_warns(capsys):
    """Unmeasured shapes get the generic lossy-mode warning but still run."""
    rc = cli.main(["run", str(FIXTURES / "inst0.in"), "--dtype", "bfloat16",
                   "--path", "dense", "--no-time"])
    captured = capsys.readouterr()
    assert rc == 0
    assert "no measured argmax agreement" in captured.err
    assert len(captured.out.splitlines()) == 3  # inst0: one top-1 per user


def test_bf16_policy_table():
    """Policy verdicts follow the measured table: above the floor runs
    even under --strict, below it and unmeasured shapes are refused."""
    from recsys_tpu.bench import bf16_policy
    from recsys_tpu.io.generator import ensure_fixture
    from recsys_tpu.io.parser import load_problem

    ml100k = load_problem(str(FIXTURES / "instML100k.in"))
    ml1m = load_problem(ensure_fixture("gen-instML1M", FIXTURES))
    for spec in (ml100k, ml1m):
        agree = bf16_policy.lookup(spec)
        assert agree is None or 0.0 < agree <= 1.0
        assert bf16_policy.check(spec, strict=True) == (
            agree is not None and agree >= bf16_policy.FLOOR
        )
        assert bf16_policy.check(spec, strict=False)


def test_path_option_has_no_kernel_choice():
    """The device paths the CLI offers: auto, dense, bell, coo."""
    with pytest.raises(SystemExit):
        cli.main(["run", str(FIXTURES / "inst0.in"), "--path", "pallas"])
    with pytest.raises(SystemExit):
        cli.main(["run", str(FIXTURES / "inst0.in"), "--precision", "bf16x3"])


def test_verbose_banner_on_stderr(capsys):
    rc = cli.main(["run", str(FIXTURES / "inst0.in"), "--dtype", "float64",
                   "--no-time", "--verbose"])
    captured = capsys.readouterr()
    assert rc == 0
    assert captured.out == open(FIXTURES / "inst0.out").read()  # stdout clean
    assert "dataset: 3x5 k=2 nnz=7" in captured.err
