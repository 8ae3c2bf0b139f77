"""Device-side glibc ``random()`` stream — kills the factor-table upload.

The TYPE_3 recurrence x[i] = (x[i-31] + x[i-3]) mod 2^32 is *linear*
over Z/2^32, so a whole block of B outputs is an exact integer
combination of the 34-word state: ``out = C @ s (mod 2^32)`` where C's
rows come from running the recurrence once over coefficient vectors
(host-side, cached per block size).  On device that is 34 scalar x
vector multiply-adds per block (uint32 wraps for free), and the scan
carry is just the 34-word state — the integer stream is BIT-exact
against the host generator (asserted in tests/test_device_rng.py).

This replaces the reference's generate-on-root-and-scatter init
(``matFact-mpi.c:459-515``) with generate-*on-device*: for 1M-dimension
instances the serial host init and the multi-GB factor upload
disappear; only the 34-word state and one (B, 34) coefficient table
are uploaded.

The only inexactness is the final float conversion: the host computes
``(x>>1)/RAND_MAX/k`` in f64 and casts; the device multiplies
``f32(x>>1)`` by the f64-precomputed ``f32(1/(RAND_MAX*k))`` — within
~2 ulp of f32.  Device init is therefore gated (trainer.py) to runs far
above every byte-exact-golden size.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from recsys_tpu.io.glibc_random import RAND_MAX, GlibcRandom

_coeff_cache: dict[int, np.ndarray] = {}


def _block_coeffs(block: int) -> np.ndarray:
    """(block, 34) uint32: row p gives x[t+p] as a combination of the
    state window (x[t-34..t-1])."""
    C = _coeff_cache.get(block)
    if C is None:
        rows = np.zeros((34 + block, 34), np.uint32)
        rows[:34] = np.eye(34, dtype=np.uint32)
        for i in range(34, 34 + block):
            rows[i] = rows[i - 31] + rows[i - 3]  # uint32 wraps
        C = _coeff_cache[block] = rows[34:]
    return C


@functools.partial(jax.jit, static_argnames=("nblocks",))
def _gen_blocks(C, s, scale, nblocks: int):
    """scan: (34,) uint32 state -> ((34,) final state, (nblocks*B,) f32
    of ``f32(x>>1) * scale``)."""

    def body(s, _):
        out = jnp.zeros(C.shape[0], jnp.uint32)
        for j in range(34):
            out = out + C[:, j] * s[j]
        new_s = jnp.concatenate([s, out])[-34:]
        return new_s, (out >> 1).astype(jnp.float32) * scale

    s, blocks = jax.lax.scan(body, s, None, length=nblocks)
    return s, blocks.reshape(-1)


class DeviceGlibcStream:
    """Sequential draw stream on device; state advances across calls so
    L and R are drawn in the reference's global order (SURVEY S0)."""

    def __init__(self, seed: int = 0, block: int = 1 << 20):
        self.block = block
        self._state = jnp.asarray(GlibcRandom(seed)._window.astype(np.uint32))
        self._C = jnp.asarray(_block_coeffs(block))

    def rand01_over(self, n: int, divisor: float) -> jax.Array:
        """Next ``n`` draws of RAND01/divisor as a device f32 array."""
        scale = jnp.float32(1.0 / (float(RAND_MAX) * divisor))
        parts = []
        nb = n // self.block
        if nb:
            self._state, flat = _gen_blocks(self._C, self._state, scale, nb)
            parts.append(flat)
        rem = n - nb * self.block
        if rem:
            Cr = jnp.asarray(_block_coeffs(self.block)[:rem])
            self._state, tail = _gen_blocks(Cr, self._state, scale, 1)
            parts.append(tail)
        if not parts:
            return jnp.zeros(0, jnp.float32)
        return parts[0] if len(parts) == 1 else jnp.concatenate(parts)


def device_init_factors(users: int, items: int, features: int, seed: int = 0):
    """Deterministic glibc initial factors generated ON DEVICE: f32
    (L (users, k), R (items, k)), same draw order as
    ``models.mf.init_factors`` (all of L row-major, then R in
    (k, items) order, transposed)."""
    st = DeviceGlibcStream(seed)
    k = features
    L = st.rand01_over(users * k, float(k)).reshape(users, k)
    R = st.rand01_over(k * items, float(k)).reshape(k, items).T
    return L, R
