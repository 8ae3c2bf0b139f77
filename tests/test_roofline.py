"""Roofline model: one peak table keyed by device_kind, least-time bounds."""

import pytest

from recsys_tpu.bench import roofline
from recsys_tpu.bench.roofline import PEAKS, pct_of_roofline, peaks, train_cost_model
from recsys_tpu.config import RunConfig
from recsys_tpu.io.generator import generate_instance

H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(scope="module")
def spec():
    return generate_instance(300, 400, 30, 5, 20, iters=100, alpha=1e-4, seed=3)


def test_unknown_device_raises(spec):
    """A device with no data-sheet entry is an error, never a default."""
    with pytest.raises(ValueError, match="no published peaks"):
        peaks("cpu")
    with pytest.raises(ValueError):
        train_cost_model(spec, RunConfig(dtype="float32"), "dense", "Some Other Accelerator")


def test_h100_entry_matches_data_sheet():
    p = PEAKS[H100]
    assert (p["bf16_tflops"], p["tf32_tflops"], p["fp32_tflops"]) == (989.0, 495.0, 67.0)
    assert p["hbm_gbps"] == 3350.0 and p["nvlink_gbps_each_way"] == 450.0


@pytest.mark.parametrize("dtype,peak", [("float32", 67.0), ("bfloat16", 989.0), ("float64", 67.0)])
def test_dense_model_uses_the_precision_peak(spec, dtype, peak):
    """float32 is priced at the true-f32 rate (not TF32), bfloat16 at
    the tensor-core rate; whichever of FLOPs and bytes is larger binds."""
    bound, t = train_cost_model(spec, RunConfig(dtype=dtype), "dense", H100)
    cells = spec.users * spec.items
    t_flops = 6.0 * cells * spec.features / (peak * 1e12)
    t_bytes = 2 * cells * (8 if dtype == "float64" else 4) / 3350e9
    assert t == pytest.approx(max(t_flops, t_bytes))
    assert bound == ("flops" if t_flops >= t_bytes else "bytes")


@pytest.mark.parametrize("path", ["bell", "coo"])
def test_sparse_models_are_bandwidth_bound(spec, path):
    bound, t32 = train_cost_model(spec, RunConfig(dtype="float32"), path, H100)
    _, t64 = train_cost_model(spec, RunConfig(dtype="float64"), path, H100)
    assert bound == "bytes" and t64 == pytest.approx(2 * t32)
    if path == "coo":
        assert t32 == pytest.approx(4.0 * spec.nnz * spec.features * 4 / 3350e9)


def test_pct_of_roofline(spec):
    cfg = RunConfig(dtype="float32")
    _, per_iter = train_cost_model(spec, cfg, "bell", H100)
    bound, pct = pct_of_roofline(spec, cfg, "bell", 2 * spec.iters * per_iter, H100)
    assert bound == "bytes" and pct == pytest.approx(50.0)
    assert pct_of_roofline(spec, cfg, "host", 1.0, H100) == (None, None)
    assert roofline.pct_of_roofline(spec, cfg, "bell", None, H100) == (None, None)
