"""Native C ingest layer vs the numpy reference implementations."""

import numpy as np
import pytest

from recsys_tpu.io import _native
from recsys_tpu.io.glibc_random import GlibcRandom
from recsys_tpu.io.parser import load_problem, parse_in_bytes

from helpers import FIXTURES


def fixture_path(name: str) -> str:
    return str(FIXTURES / name)

pytestmark = pytest.mark.skipif(
    not _native.available(), reason="no C toolchain to build the native library"
)


def test_native_rand01_matches_numpy():
    ref = GlibcRandom(0).rand01(10_000)
    nat = _native.rand01(10_000, 0)
    np.testing.assert_array_equal(nat, ref)


def test_native_rand01_nonzero_seed():
    ref = GlibcRandom(12345).rand01(1_000)
    nat = _native.rand01(1_000, 12345)
    np.testing.assert_array_equal(nat, ref)


@pytest.mark.parametrize("name", ["inst0.in", "inst30-40-10-2-10.in", "instML100k.in"])
def test_native_parse_matches_numpy(name):
    path = fixture_path(name)
    with open(path, "rb") as f:
        data = f.read()
    ref = parse_in_bytes(data)
    nat = _native.load_problem(path)
    assert nat is not None
    assert (nat.iters, nat.alpha, nat.features, nat.users, nat.items) == (
        ref.iters,
        ref.alpha,
        ref.features,
        ref.users,
        ref.items,
    )
    np.testing.assert_array_equal(nat.rows, ref.rows)
    np.testing.assert_array_equal(nat.cols, ref.cols)
    np.testing.assert_array_equal(nat.vals, ref.vals)


def test_native_parse_correctly_rounded_adversarial():
    # The fraction reconstruction must match strtod/%lf bit-for-bit
    # (the old 1e-nd multiply-add double-rounded).  Stress it
    # with random many-digit decimals plus known hard cases.
    rng = np.random.default_rng(7)
    lines = []
    values = []
    hard = [
        "0.1", "0.3", "2.675", "4.999999", "0.000001", "123456.789012",
        "0.123456789012345", "1.000000000000001",
        "5.000000000000001", "0.299999999999999", "3.141592653589793",
    ]
    for i, h in enumerate(hard):
        lines.append(f"{i} {i} {h}")
        values.append(float(h))
    for i in range(5000):
        nd = int(rng.integers(1, 16))
        # keep the exact numerator ip*10^nd + fp under 2^53 (beyond it
        # the parser correctly signals the strtod fallback)
        ip_max = max(1, (2**53 - 10**nd) // 10**nd)
        ip = int(rng.integers(0, min(ip_max, 10**6)))
        fp = int(rng.integers(0, 10**nd))
        s = f"{ip}.{fp:0{nd}d}"
        lines.append(f"{i} {i} {s}")
        values.append(float(s))
    body = ("\n".join(lines) + "\n").encode()
    parsed = _native.parse_entries(body, len(lines))
    assert parsed is not None
    _, _, vals = parsed
    ref = np.array(values, dtype=np.float64)
    # bit-exact, not just close
    np.testing.assert_array_equal(vals, ref)


def test_native_parse_overlong_fraction_falls_back():
    # >15 fraction digits or a 2^53-breaching numerator must signal the
    # strtod fallback instead of parsing inexactly.
    body = b"0 0 0.1234567890123456789\n"
    assert _native.parse_entries(body, 1) is None
    body = b"0 0 123456789012.123456\n"  # numerator 1.2e17 > 2^53
    assert _native.parse_entries(body, 1) is None


def test_load_problem_uses_native(tmp_path):
    # load_problem routes through the native parser when available and
    # produces the same spec as the pure-numpy path.
    spec = load_problem(fixture_path("inst2.in"))
    with open(fixture_path("inst2.in"), "rb") as f:
        ref = parse_in_bytes(f.read())
    np.testing.assert_array_equal(spec.vals, ref.vals)


def test_native_format_entries_roundtrip():
    rng = np.random.default_rng(3)
    rows = np.sort(rng.integers(0, 50, 200)).astype(np.int32)
    cols = rng.integers(0, 70, 200).astype(np.int32)
    vals = np.round(rng.uniform(0, 5, 200), 6)
    out = _native.format_entries(rows, cols, vals)
    assert out is not None
    lines = out.decode().splitlines()
    assert len(lines) == 200
    ref_lines = [f"{r} {c} {v:.6f}" for r, c, v in zip(rows, cols, vals)]
    assert lines == ref_lines


def test_native_format_matches_printf_on_ties():
    """The native writer must byte-match %.6f (the numpy fallback) even
    on values where round(v*1e6) double-rounds — printf rounds the EXACT
    binary value; the fast path only fires when v*1e6 is exactly
    integral."""
    import numpy as np

    from recsys_tpu.io import _native

    rng = np.random.default_rng(3)
    vals = np.concatenate([
        rng.uniform(0, 5, 500),                  # arbitrary fractions
        rng.integers(1, 6, 100).astype(float),   # exact fast path
        np.array([0.1235705, 2.0000005, 0.0000005, 4.9999995]),  # ties
        rng.uniform(0, 5, 200).astype(np.float32).astype(np.float64),
    ])
    rows = np.zeros(len(vals), np.int32)
    cols = np.arange(len(vals), dtype=np.int32)
    out = _native.format_entries(rows, cols, vals)
    if out is None:
        pytest.skip("native lib unavailable")
    want = "".join(f"0 {c} {v:.6f}\n" for c, v in zip(cols, vals)).encode()
    assert out == want
