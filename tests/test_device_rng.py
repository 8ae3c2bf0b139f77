"""Device-side glibc stream (ops/device_rng.py).

The integer outputs must be BIT-exact against the host generator for
any n (block-aligned or not) and across sequential calls; the f32
scaled values are allowed ~2 ulp (the host divides in f64 and casts).
Runs on the CPU test mesh — the generator is plain XLA.
"""

import numpy as np

from recsys_tpu.io.glibc_random import GlibcRandom
from recsys_tpu.ops.device_rng import DeviceGlibcStream, _block_coeffs, device_init_factors


def test_block_coeffs_reproduce_stream():
    # Host check of the linear-combination identity itself: C @ window
    # (mod 2^32) must equal the next 64 un-shifted recurrence values.
    win = GlibcRandom(0)._window.astype(np.uint64)  # x[t-34..t-1]
    C = _block_coeffs(64).astype(np.uint64)
    pred = (C @ win) & 0xFFFFFFFF
    got = GlibcRandom(0).raw(64).astype(np.uint64)  # raw() returns x >> 1
    np.testing.assert_array_equal(pred >> 1, got)


def test_device_stream_bit_exact_and_continuable():
    st = DeviceGlibcStream(0, block=1000)
    # Two calls with awkward sizes: 2517 (2 blocks + 517), then 1311.
    a = np.asarray(st.rand01_over(2517, 5.0))
    b = np.asarray(st.rand01_over(1311, 5.0))
    host_raw = GlibcRandom(0).raw(2517 + 1311).astype(np.float64)
    want = (host_raw.astype(np.float32)) * np.float32(1.0 / (2147483647.0 * 5.0))
    got = np.concatenate([a, b])
    # integer stream exact => values match the device formula exactly
    np.testing.assert_array_equal(got, want[: len(got)])
    # and within ~2 ulp of the host's f64-divide-then-cast
    host_f = (host_raw / 2147483647.0 / 5.0).astype(np.float32)
    np.testing.assert_allclose(got, host_f, rtol=3e-7)


def test_device_init_factors_matches_host():
    from recsys_tpu.models.mf import init_factors

    L, R = device_init_factors(37, 23, 6)
    want = init_factors(37, 23, 6)
    np.testing.assert_allclose(np.asarray(L), want.L.astype(np.float32), rtol=3e-7)
    np.testing.assert_allclose(np.asarray(R), want.R.astype(np.float32), rtol=3e-7)
    assert L.shape == (37, 6) and R.shape == (23, 6)
