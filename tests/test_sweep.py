"""Bench sweep harness: rendering, reference mapping, GPU refusal."""

from recsys_tpu.bench.sweep import REFERENCE_S, format_markdown


def _row(**kw):
    base = dict(
        instance="instML100k",
        dtype="float32",
        path="dense",
        wall_s=0.38,
        updates_per_s=7.9e8,
        iters=3000,
        nnz=100000,
        users=943,
        items=1682,
        k=30,
        golden_exact=False,
        agreement=0.9894,
    )
    base.update(kw)
    return base


def test_markdown_contains_speedups():
    md = format_markdown([_row()])
    assert "instML100k" in md
    # 104.93 / 0.38 ≈ 276x vs serial, 13.922 / 0.38 ≈ 36.6x vs best.
    assert "276.1x" in md and "36.6x" in md and "98.94%" in md


def test_markdown_exact_flag():
    md = format_markdown([_row(golden_exact=True, agreement=1.0)])
    assert "| exact |" in md


def test_gen_instances_map_to_original_reference():
    md = format_markdown(
        [_row(instance="gen-instML1M", wall_s=12.5201, agreement=None)]
    )
    # Maps to instML1M's (125.201, 8.60): 10x vs serial.
    assert "10.0x" in md


def test_unknown_instance_renders_dashes():
    md = format_markdown([_row(instance="gen-instX", agreement=None)])
    assert "| - | - |" in md


def test_reference_table_covers_published_instances():
    for k in ("instML100k", "instML1M", "inst50000-5000-100-2-5"):
        serial, best = REFERENCE_S[k]
        assert serial >= best > 0


def test_markdown_names_the_card():
    md = format_markdown([_row(gpu="NVIDIA H100 80GB HBM3, 700.00 W")])
    assert "| NVIDIA H100 80GB HBM3, 700.00 W |" in md


def test_sweep_refuses_without_gpu():
    """A measurement that finds no GPU exits; it never falls back to a
    CPU row (the test suite runs on the CPU backend)."""
    import pytest

    from recsys_tpu.bench.sweep import main

    with pytest.raises(SystemExit, match="no GPU"):
        main(["--instances", "inst0", "--repeats", "1"])
