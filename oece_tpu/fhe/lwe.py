"""Batched LWE operations.

Host-side (NumPy, randomness lives here): batched encrypt / decrypt — the
client-side boundary ops of the reference (``cc.Encrypt`` circuit.cpp:506,
``cc.Decrypt`` circuit.cpp:800).  Device-side (jnp-compatible, deterministic):
the linear ops used by the evaluator (EvalNOT gate.cpp:112, ciphertext
add/sub, mod switching).

Ciphertext layout: int32 ``[..., n+1]`` = (a_0..a_{n-1}, b) mod q, with the
q/4 bit encoding  b = <a, s> + e + m * q/4.
"""

from __future__ import annotations

import numpy as np

from .golden import LWESecretKey, gauss
from .params import BinFHEParams


def encrypt_bits(
    sk: LWESecretKey, bits: np.ndarray, rng: np.random.Generator
) -> np.ndarray:
    """Encrypt a batch of bits -> int32 [B, n+1] mod q (host, vectorized)."""
    p = sk.params
    bits = np.asarray(bits, dtype=np.int64).reshape(-1)
    B = bits.shape[0]
    a = rng.integers(0, p.q, (B, p.n), dtype=np.int64)
    e = gauss(rng, p.sigma, (B,))
    b = (a @ sk.s + e + bits * (p.q // 4)) % p.q
    return np.concatenate([a, b[:, None]], axis=1).astype(np.int32)


def decrypt_bits(sk: LWESecretKey, cts: np.ndarray) -> np.ndarray:
    """Decrypt a batch of ciphertexts -> bits [B] (host, vectorized)."""
    p = sk.params
    cts = np.asarray(cts, dtype=np.int64)
    phase = (cts[..., -1] - cts[..., :-1] @ sk.s) % p.q
    return (((phase + p.q // 8) // (p.q // 4)) % 4 & 1).astype(np.int32)


def decrypt_noise(sk: LWESecretKey, cts: np.ndarray, bits: np.ndarray) -> np.ndarray:
    """Centered noise of each ciphertext given its known plaintext (tests)."""
    p = sk.params
    cts = np.asarray(cts, dtype=np.int64)
    phase = (cts[..., -1] - cts[..., :-1] @ sk.s) % p.q
    err = (phase - np.asarray(bits, dtype=np.int64) * (p.q // 4)) % p.q
    return np.where(err > p.q // 2, err - p.q, err)


# ---------------------------------------------------------------------------
# Device-safe linear ops (work on numpy or jax.numpy int32 arrays).
# ---------------------------------------------------------------------------


def eval_not_batch(cts, q: int):
    """EvalNOT, batched: (-a, q/4 - b) mod q (gate.cpp:112 parity).

    Works on numpy or jnp int32 arrays; q is a power of two so % is a mask.
    """
    import jax.numpy as jnp

    cts = jnp.asarray(cts)
    out = (q - cts) & (q - 1)
    return out.at[..., -1].set((out[..., -1] + q // 4) & (q - 1))


def encrypt_bits_dev(s_dev, bits, key, params):
    """DEVICE-side batched encryption with the jax PRNG (threefry):
    bits [B] -> int32 [B, n+1] mod q.

    The host path (encrypt_bits) stays the golden anchor; this exists so
    accelerator runs never upload ciphertext arrays — only the plaintext
    bits and a PRNG key cross the host/device boundary.
    Distributions match encrypt_bits (uniform a, rounded-Gaussian e, q/4
    encoding); values differ (different RNG), which decryption-based tests
    absorb.
    """
    import jax
    import jax.numpy as jnp

    p = params
    B = bits.shape[0]
    k1, k2 = jax.random.split(key)
    a = jax.random.randint(k1, (B, p.n), 0, p.q, jnp.int32)
    e = jnp.rint(p.sigma * jax.random.normal(k2, (B,), jnp.float32)).astype(
        jnp.int32
    )
    b = (jnp.einsum("bi,i->b", a, s_dev) + e + bits * (p.q // 4)) % p.q
    return jnp.concatenate([a, b[:, None]], axis=1)


def decrypt_bits_dev(s_dev, cts, q: int):
    """Device-side decrypt to bits: cts int32 [..., n+1] -> [...] int32."""
    import jax.numpy as jnp

    phase = (cts[..., -1] - jnp.einsum("...i,i->...", cts[..., :-1], s_dev)) % q
    return (((phase + q // 8) // (q // 4)) % 4) & 1


def phase_margin_dev(s_dev, cts, q: int):
    """Device-side nearest-VALID decode + centered phase error.

    Valid gate plaintexts encode only at {0, q/4} (bits), so the nearest
    valid decode is bit=1 iff phase in the half-open window [q/8, 5q/8)
    (the lower boundary decodes as 1; boundary phases sit exactly at
    threshold |err| == q/8 either way).  Returns (bit, err)
    with err = center(phase - bit*q/4) — the phase margin used by the
    encrypted-mode failure recovery (evaluator.setRecovery): |err| >= q/8
    proves a bootstrap failure WITHOUT the plaintext model (the phase sits
    outside every valid decode window).
    """
    import jax.numpy as jnp

    phase = (cts[..., -1] - jnp.einsum("...i,i->...", cts[..., :-1], s_dev)) % q
    bit = (((phase - q // 8) % q) < (q // 2)).astype(jnp.int32)
    err = (phase - bit * (q // 4) + q // 2) % q - q // 2
    return bit, err
