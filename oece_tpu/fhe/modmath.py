"""Int32-safe modular arithmetic (no 64-bit integers, no mulhi).

The ring modulus is the FHEW prime Q = 2**27 - 2**11 + 1, which gives the
cheap reduction identity  2**27 ≡ 2**11 - 1 (mod Q).  Everything here is
written so that no intermediate exceeds 2**31 and is used identically by the
jnp device path and the NumPy golden path (bit-exact by construction).

Limb convention for int8 matmuls: ring coefficients v in [0, Q) are split into
L=4 signed base-256 limbs, each in [-128, 127] (top limb in [0, 7]), so they
are int8-safe:  v = sum_l limb_l * 2**(8l).
"""

from __future__ import annotations

import numpy as np

from .params import Q27

N_LIMBS = 4
LIMB_BITS = 8
LIMB_BASE = 1 << LIMB_BITS


# ---------------------------------------------------------------------------
# Host-side (NumPy) limb encoding — used when packing keys for the device.
# ---------------------------------------------------------------------------


def to_limbs_i8(v: np.ndarray, n_limbs: int = N_LIMBS) -> np.ndarray:
    """Split nonneg int64 values < 2**(8*n_limbs - 1) into signed base-256
    limbs, each in [-128, 127] (top limb unsigned-small).  Exact:
    sum_l limb_l * 256**l == v."""
    v = np.asarray(v, dtype=np.int64)
    assert np.all(v >= 0)
    out = np.empty(v.shape + (n_limbs,), dtype=np.int8)
    cur = v.copy()
    for l in range(n_limbs - 1):
        r = cur % LIMB_BASE
        r = np.where(r >= LIMB_BASE // 2, r - LIMB_BASE, r)
        out[..., l] = r.astype(np.int8)
        cur = (cur - r) >> LIMB_BITS
    assert np.all(cur >= -128) and np.all(cur <= 127), "value too wide for limbs"
    out[..., n_limbs - 1] = cur.astype(np.int8)
    return out


def from_limbs(limbs: np.ndarray) -> np.ndarray:
    limbs = np.asarray(limbs, dtype=np.int64)
    v = np.zeros(limbs.shape[:-1], dtype=np.int64)
    for l in range(limbs.shape[-1]):
        v = v + limbs[..., l] * (1 << (LIMB_BITS * l))
    return v


# ---------------------------------------------------------------------------
# Device-side (works on jnp or np int32 arrays).
#
# These are pure elementwise expressions — pass in the array module `xp`
# (numpy or jax.numpy); the arithmetic is identical.
# ---------------------------------------------------------------------------


def red31(x, Q: int = Q27):
    """Reduce 0 <= x < 2**31 to [0, Q) using 2**27 ≡ 2**11 - 1 (mod Q).

    After folding the top bits, at most two conditional subtracts remain.
    """
    m27 = (1 << 27) - 1
    hi = x >> 27            # < 16
    lo = x & m27            # < 2**27
    y = hi * ((1 << 11) - 1) + lo   # < 2**27 + 2**15
    y = y - Q * (y >= Q).astype(y.dtype)
    return y


def mod_q(x, Q: int = Q27):
    """Reduce signed int32 x with |x| <= 2**30 to [0, Q)."""
    # x + 8Q is nonnegative (8Q ≈ 2**30.0 > 2**30 ... use 8Q) and < 2**31.
    y = x + 8 * Q
    y = red31(y, Q)
    return y


def mul_pow8_mod(x, Q: int = Q27):
    """(x * 2**8) mod Q for x in [0, Q)."""
    hi = x >> 19            # < 2**8
    lo = x & ((1 << 19) - 1)
    y = hi * ((1 << 11) - 1) + (lo << 8)  # < 2**27 + 2**19
    y = y - Q * (y >= Q).astype(y.dtype)
    return y


def combine_limbs_mod_q(r_limbs, Q: int = Q27):
    """Given int32 limb accumulators r_l (last axis, length L) with
    |r_l| <= 2**27 (the exact bound of a [*, 8192] int8 matmul), return
    sum_l r_l * 2**(8l) mod Q, elementwise, in [0, Q).

    Horner evaluation: acc = ((r3 * 2^8 + r2) * 2^8 + r1) * 2^8 + r0.
    """
    L = r_limbs.shape[-1]
    acc = mod_q(r_limbs[..., L - 1], Q)
    for l in range(L - 2, -1, -1):
        acc = mul_pow8_mod(acc, Q)
        acc = acc + mod_q(r_limbs[..., l], Q)
        acc = acc - Q * (acc >= Q).astype(acc.dtype)
    return acc


def mod_switch_from_q27(x, M_log2: int, Q: int = Q27):
    """round((x * 2**M_log2) / Q) for x in [0, Q), exactly, in int32.

    Uses x = x1*2**12 + x0 and 2**27 ≡ 2**11 - 1 (mod Q); requires
    M_log2 <= 15 so every intermediate stays below 2**29.
    """
    assert M_log2 + 12 <= 27
    sh = 27 - M_log2  # >= 12
    x1 = x >> sh              # < 2**M_log2
    x0 = x & ((1 << sh) - 1)  # < 2**sh
    z = x1 * ((1 << 11) - 1) + (x0 << M_log2) + Q // 2  # < 2**26+2**27+2**26
    q2 = (z >= Q).astype(x.dtype) + (z >= 2 * Q).astype(x.dtype) + (
        z >= 3 * Q
    ).astype(x.dtype)
    return x1 + q2
