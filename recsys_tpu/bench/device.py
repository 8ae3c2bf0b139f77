"""The device a measurement ran on, and the refusal to measure without one.

Every number the benchmark tools print names its device: JAX's
platform, ``device_kind`` and device count, plus the card's name and
power limit as ``nvidia-smi`` reports them (a card set below its
maximum power runs slower under load).  A measurement that finds no GPU
exits; it never falls back to the CPU.
"""

from __future__ import annotations

import subprocess
import sys


def power_limit() -> str:
    """``name, power.limit`` of the cards as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    return out.stdout.strip() or out.stderr.strip()


def require_gpu():
    """The first JAX device; exits with a message when it is not a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"error: no GPU (JAX platform {dev.platform!r}); refusing to measure")
    return dev


def stamp() -> dict:
    """Device fields every benchmark row carries."""
    import jax

    dev = jax.devices()[0]
    return {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": jax.device_count(),
        "gpu": power_limit(),
    }
