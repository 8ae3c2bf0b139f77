"""Measurement tools and the compile cache: GPU-only, device-stamped.

Every measurement path (bench.py, the sweep, the precision check,
chip_smoke.py) must refuse to run when JAX finds no GPU — never fall
back to a CPU number.  The test suite runs on the CPU backend, which is
exactly that case.  The one test marked ``gpu`` runs only on a card.
"""

import os
import pathlib
import shutil
import subprocess
import sys

import jax
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def gpu():
    """Skip unless the machine has an NVIDIA card (decided per test).
    The suite's own process is held to the CPU (conftest.py), so tests
    that use the card run their work in a child process."""
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"], capture_output=True).returncode != 0:
        pytest.skip("needs an NVIDIA GPU")


def _run(args, cwd=REPO, **env):
    e = dict(os.environ, JAX_PLATFORMS="cpu", **env)
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=e, capture_output=True, text=True, timeout=240
    )


def test_cache_dir_from_env(monkeypatch):
    """JAX_COMPILATION_CACHE_DIR, when set, is the cache and the code
    sets no other path (JAX reads the variable itself)."""
    from recsys_tpu.utils import cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append((k, v)))
    cache.enable_persistent_cache()
    assert not any(k == "jax_compilation_cache_dir" for k, _ in calls)


def test_cache_dir_default_is_fixed_in_checkout(monkeypatch):
    from recsys_tpu.utils import cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append((k, v)))
    cache.enable_persistent_cache()
    assert cache.DEFAULT_DIR == str(REPO / ".jax_cache")
    assert ("jax_compilation_cache_dir", cache.DEFAULT_DIR) in calls
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().splitlines()


def test_bench_refuses_without_gpu():
    p = _run(["bench.py"])
    assert p.returncode != 0 and "no GPU" in p.stderr
    assert p.stdout.strip() == ""


def test_chip_smoke_refuses_without_gpu():
    p = _run(["chip_smoke.py"])
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_chip_smoke_alone_refuses(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    p = _run(["chip_smoke.py"], cwd=tmp_path)
    assert p.returncode != 0 and p.stdout == ""


def test_precision_check_refuses_without_gpu():
    from recsys_tpu.bench import precision

    with pytest.raises(SystemExit, match="no GPU"):
        precision.main(["--instance", "inst0"])


def test_device_stamp_names_the_device():
    from recsys_tpu.bench.device import stamp

    s = stamp()
    assert s["platform"] == "cpu" and s["device_count"] == len(jax.devices())
    assert set(s) == {"platform", "device_kind", "device_count", "gpu"}


def test_phase_timing_blocks_on_results():
    import jax.numpy as jnp

    from recsys_tpu.utils.timing import collect_phases, phase

    out = {}
    with collect_phases(out):
        with phase("train") as psync:
            x = psync(jnp.ones((4,)) * 2)
    assert set(out) == {"train"} and out["train"] >= 0.0
    assert float(x[0]) == 2.0
    with phase("idle") as psync:  # no collector: a no-op sync
        assert psync(3) == 3


@pytest.mark.gpu
def test_precision_check_on_gpu(gpu):
    """On the card: float32 products are true f32 (not TF32)."""
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    p = subprocess.run(
        [sys.executable, "-m", "recsys_tpu.bench.precision", "--instance", "instML100k"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )
    assert p.returncode == 0, p.stdout + p.stderr
