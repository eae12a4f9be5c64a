"""Device (jnp) negacyclic NTT over Z_Q[X]/(X^N+1) — the speed-of-light
comparison kernel (BASELINE.md item 4 / SURVEY §7.2).

The production bootstrap deliberately avoids the NTT: the negacyclic
product runs as a dense int8 matmul on the tensor cores, while an NTT is
log2 N sequential butterfly stages of int32 modular multiplies.  This
module exists to MEASURE that trade instead of arguing it
(tools/bench_ntt.py): a batched, jit-compatible, int32-exact
forward/inverse transform, bit-identical to the host reference fhe/ntt.py.

int32 discipline (no 64-bit mulhi): a modular multiply by a
CONSTANT twiddle w splits both operands at 2**14 —

    x*w = (x1*w1)*2**28 + (x1*w0 + x0*w1)*2**14 + x0*w0

with every partial product < 2**28 and the power-of-two factors folded by
2**27 ≡ 2**11 - 1 (mod Q) shift-reduction (fhe/modmath.py discipline).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from . import ntt as ntt_host
from .params import Q27


def _mul_pow2_mod(x, k: int, Q: int = Q27):
    """(x << k) mod Q for x in [0, Q), 1 <= k <= 14, exactly in int32."""
    hi = x >> (27 - k)          # < 2**k
    lo = x & ((1 << (27 - k)) - 1)
    y = hi * ((1 << 11) - 1) + (lo << k)  # < 2**25 + 2**27
    y = y - Q * (y >= Q).astype(y.dtype)
    y = y - Q * (y >= Q).astype(y.dtype)
    return y


def _mulmod_const(x, w0, w1, Q: int = Q27):
    """x in [0, Q) times constant w = w1*2**14 + w0, exact int32.

    w0 < 2**14 and w1 < 2**13 are int32 twiddle-table planes.
    """
    from . import modmath

    x1 = x >> 14            # < 2**13
    x0 = x & ((1 << 14) - 1)
    t2 = modmath.red31(x1 * w1, Q)        # x1*w1 < 2**26
    t2 = _mul_pow2_mod(_mul_pow2_mod(t2, 14, Q), 14, Q)   # * 2**28
    t1 = modmath.red31(x1 * w0 + x0 * w1, Q)              # < 2**28
    t1 = _mul_pow2_mod(t1, 14, Q)
    t0 = modmath.red31(x0 * w0, Q)                        # < 2**28
    y = t2 + t1 + t0  # < 3Q
    y = y - Q * (y >= Q).astype(y.dtype)
    y = y - Q * (y >= Q).astype(y.dtype)
    return y


@functools.lru_cache(maxsize=None)
def _tables_dev(N: int, Q: int = Q27):
    # NumPy planes (not jnp): tiny tables embed as trace-time constants, so
    # the cache never captures tracers across jit scopes.
    psis, ipsis, n_inv = ntt_host._tables(N, Q)

    def planes(t):
        t = np.asarray(t, dtype=np.int64)
        return (
            np.asarray(t & ((1 << 14) - 1), np.int32),
            np.asarray(t >> 14, np.int32),
        )

    return planes(psis), planes(ipsis), planes(np.array([n_inv]))


def ntt_forward_dev(a, Q: int = Q27):
    """Forward negacyclic NTT, batch on axis 0: [B, N] int32 in [0, Q) ->
    [B, N] (bit-reversed order).  Bit-exact vs ntt.ntt_forward."""
    N = a.shape[-1]
    (p0, p1), _, _ = _tables_dev(N, Q)
    m = 1
    t = N
    while m < N:
        t //= 2
        a = a.reshape(a.shape[0], m, 2, t)
        w0 = p0[m : 2 * m].reshape(1, m, 1)
        w1 = p1[m : 2 * m].reshape(1, m, 1)
        u = a[:, :, 0, :]
        v = _mulmod_const(a[:, :, 1, :], w0, w1, Q)
        s = u + v
        s = s - Q * (s >= Q).astype(s.dtype)
        d = u - v
        d = d + Q * (d < 0).astype(d.dtype)
        a = jnp.concatenate([s, d], axis=-1).reshape(a.shape[0], -1)
        m *= 2
    return a


def ntt_inverse_dev(a, Q: int = Q27):
    """Inverse negacyclic NTT (GS butterflies): bit-exact vs ntt.ntt_inverse."""
    N = a.shape[-1]
    _, (ip0, ip1), (ni0, ni1) = _tables_dev(N, Q)
    m = N
    t = 1
    while m > 1:
        h = m // 2
        a = a.reshape(a.shape[0], h, 2, t)
        w0 = ip0[h : 2 * h].reshape(1, h, 1)
        w1 = ip1[h : 2 * h].reshape(1, h, 1)
        u = a[:, :, 0, :]
        v = a[:, :, 1, :]
        s = u + v
        s = s - Q * (s >= Q).astype(s.dtype)
        d = u - v
        d = d + Q * (d < 0).astype(d.dtype)
        d = _mulmod_const(d, w0, w1, Q)
        a = jnp.stack([s, d], axis=-2).reshape(a.shape[0], -1)
        m = h
        t *= 2
    return _mulmod_const(a, ni0[0], ni1[0], Q)


def negacyclic_mul_ntt_dev(a, b, Q: int = Q27):
    """a ⊛ b on device via NTT — equals golden.negacyclic_mul exactly."""
    fa = ntt_forward_dev(a, Q)
    fb = ntt_forward_dev(b, Q)
    prod = _mulmod_var(fa, fb, Q)
    return ntt_inverse_dev(prod, Q)


def _mulmod_var(x, y, Q: int = Q27):
    """Variable-variable (x * y) mod Q, both in [0, Q), exact int32."""
    from . import modmath

    x1 = x >> 14
    x0 = x & ((1 << 14) - 1)
    y1 = y >> 14
    y0 = y & ((1 << 14) - 1)
    t2 = modmath.red31(x1 * y1, Q)
    t2 = _mul_pow2_mod(_mul_pow2_mod(t2, 14, Q), 14, Q)
    t1 = modmath.red31(x1 * y0 + x0 * y1, Q)
    t1 = _mul_pow2_mod(t1, 14, Q)
    t0 = modmath.red31(x0 * y0, Q)
    z = t2 + t1 + t0
    z = z - Q * (z >= Q).astype(z.dtype)
    z = z - Q * (z >= Q).astype(z.dtype)
    return z
