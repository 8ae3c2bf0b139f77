"""Per-path roofline model: the least time the device could take.

SURVEY §7.4 asks for updates/s against a roofline: bytes over device
memory bandwidth for the sparse paths, FLOPs over the matmul peak for
the dense paths.  The model counts the minimum work the formulation
must do per iteration, from the instance's shapes, and divides by the
published peaks of the card the row ran on.  ``pct_of_roofline`` is
that minimum over the measured time: 100% would be the card's speed of
light for the formulation, which no program reaches.

The peaks live in ONE table keyed by JAX's ``device_kind``.  A device
that is not in the table is an error, never a default.
"""

from __future__ import annotations

# Published dense (no sparsity) peaks at the card's full power limit.
# Source: NVIDIA H100 Tensor Core GPU data sheet (SXM5 part) and the
# NVIDIA Hopper architecture white paper.  A card set below 700 W
# (nvidia-smi power.limit) cannot hold its top clock under load, so
# every row quotes its power limit beside its percentage.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_tflops": 989.0,  # tensor cores, bf16 operands, f32 accumulation
        "tf32_tflops": 495.0,  # tensor cores, TF32 (not used: f32 here is true f32)
        "fp32_tflops": 67.0,  # CUDA cores: true-f32 products
        "fp64_tflops": 67.0,  # FP64 tensor cores
        "hbm_gbps": 3350.0,
        "nvlink_gbps_each_way": 450.0,  # 900 GB/s total to the other cards
    },
}


def peaks(device_kind: str) -> dict:
    """The peak table entry for ``device_kind``; ValueError if absent."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device {device_kind!r}; add its data-sheet "
            "rates to bench/roofline.PEAKS before computing a roofline share"
        ) from None


def _itemsize(dtype: str) -> int:
    return {"float64": 8, "float32": 4, "bfloat16": 2}[dtype]


def matmul_tflops(p: dict, dtype: str) -> float:
    """Matmul peak for the engine's precision mapping of ``dtype``."""
    return {
        "bfloat16": p["bf16_tflops"],
        "float32": p["fp32_tflops"],
        "float64": p["fp64_tflops"],
    }[dtype]


def train_cost_model(spec, cfg, path: str, device_kind: str):
    """(bound, seconds per iteration) of the least iteration time, where
    ``bound`` names the limit ("flops" or "bytes"); (None, None) for the
    host-serial path, which runs no device program."""
    p = peaks(device_kind)
    k = spec.features
    es = _itemsize(cfg.dtype)
    bw = p["hbm_gbps"] * 1e9
    if path == "dense":
        # Three products of 2*U*I*k FLOPs each (prediction, E·R, Eᵀ·L);
        # A and M must each be read at least once.
        cells = spec.users * spec.items
        flops = 3 * 2.0 * cells * k
        a_bytes = 2 * cells * (8 if cfg.dtype == "float64" else 4)
        t_flops = flops / (matmul_tflops(p, cfg.dtype) * 1e12)
        t_bytes = a_bytes / bw
        return ("flops", t_flops) if t_flops >= t_bytes else ("bytes", t_bytes)
    if path == "bell":
        # Each padded slot gathers one opposite-side factor row.
        from recsys_tpu.ops.bell import bell_side_slots

        su, si = bell_side_slots(spec)
        return "bytes", (su + si) * k * es / bw
    if path == "coo":
        # Two k-rows gathered per entry on each side.
        return "bytes", 4.0 * spec.nnz * k * es / bw
    return None, None


def pct_of_roofline(spec, cfg, path: str, train_s: float, device_kind: str):
    """(bound, percent): the modelled least train time over the
    measured one; (None, None) when no model applies."""
    bound, per_iter = train_cost_model(spec, cfg, path, device_kind)
    if bound is None or not train_s:
        return None, None
    return bound, 100.0 * spec.iters * per_iter / train_s
