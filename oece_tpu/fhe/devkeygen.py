"""Device-side bootstrap key generation and packing.

The reference regenerates its keys host-side every run (``BTKeyGen``,
circuit.cpp:91); here the whole key — RGSW refresh keys, key-switch key —
is generated on the accelerator from a PRNG seed.  Only the seed crosses
the host/device boundary (plus the 2 KB LWE secret coming back for
host-side encrypt/decrypt), and the multi-GB packed key never exists on
the host.

Structure mirrors fhe/golden.py's keygen semantics (same distributions,
same RGSW row layout, same packing as fhe/boot.pack_bootstrap_key —
pinned bit-exactly by tests/test_devkeygen.py), but all arrays are jnp and
the negacyclic products run as one int8 matmul.  Sampling is threefry, so
every value except the rounded Gaussian is identical across backends; the
Gaussian's float rounding may differ in the last bit between backends, so
keys of one seed are not compared across backends.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from . import boot, golden, modmath
from .params import BinFHEParams, BinFHEMethod


# ---------------------------------------------------------------------------
# device sampling (threefry)
# ---------------------------------------------------------------------------


def _ternary(key, shape):
    return jax.random.randint(key, shape, -1, 2, jnp.int32)


def _uniform_mod(key, shape, mod):
    return jax.random.randint(key, shape, 0, mod, jnp.int32)


def _gauss(key, sigma, shape):
    """Rounded continuous Gaussian (golden.gauss semantics)."""
    return jnp.rint(sigma * jax.random.normal(key, shape, jnp.float32)).astype(
        jnp.int32
    )


# ---------------------------------------------------------------------------
# device ring arithmetic
# ---------------------------------------------------------------------------


def _negacyclic_by_ternary(A, z, Q):
    """A [..., N] int32 mod Q  ⊛  z [N] ternary -> [..., N] mod Q.

    Dense negacyclic matrix of z is int8 (entries in {-1, 0, 1}); A splits
    into 4 signed base-256 limbs so the contraction is an exact int8
    matmul with int32 accumulation (|sum| <= N * 128 < 2**18 per limb).
    """
    N = A.shape[-1]
    i = jnp.arange(N, dtype=jnp.int32)
    idx = (i[None, :] - i[:, None]) & (2 * N - 1)  # [i, k] -> (k - i) mod 2N
    zext = jnp.concatenate([z, -z]).astype(jnp.int8)
    Zm = jnp.take(zext, idx, axis=0)  # [N, N] int8
    limbs = _to_limbs_i8_dev(A)  # [..., N, 4]
    flat = jnp.moveaxis(limbs, -1, -2).reshape(-1, N).astype(jnp.int8)
    prod = jax.lax.dot_general(
        flat, Zm, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32
    ).reshape(*A.shape[:-1], 4, N)
    return modmath.combine_limbs_mod_q(jnp.moveaxis(prod, -2, -1), Q)


def _to_limbs_i8_dev(v):
    """modmath.to_limbs_i8 on device: [...,] int32 in [0, 2**31) ->
    [..., 4] int8 signed base-256 limbs, exact."""
    digs = []
    cur = v
    for _ in range(modmath.N_LIMBS - 1):
        r = cur & 0xFF
        r = r - ((r >= 128) << 8)
        digs.append(r.astype(jnp.int8))
        cur = (cur - r) >> 8
    digs.append(cur.astype(jnp.int8))
    return jnp.stack(digs, axis=-1)


# ---------------------------------------------------------------------------
# packing (boot.pack_bootstrap_key's layout on device)
# ---------------------------------------------------------------------------


def _ext_limb_planes(polys, Q):
    """[..., N] int32 mod Q -> [..., L, 2N] int8 (boot._poly_ext_limbs)."""
    neg = jnp.where(polys == 0, 0, Q - polys)
    ext = jnp.concatenate([polys, neg], axis=-1)  # [..., 2N]
    limbs = _to_limbs_i8_dev(ext)  # [..., 2N, L]
    return jnp.moveaxis(limbs, -1, -2)  # [..., L, 2N]


def pack_layout(kext):
    """Limb planes [steps, P, R, O, L, 2N] -> DeviceBootKeys.brk, built one
    step at a time (lax.map) so the peak stays near the output size."""
    return jax.lax.map(lambda k: boot.toeplitz_blocks(k, jnp), kext)


# ---------------------------------------------------------------------------
# key generation
# ---------------------------------------------------------------------------


def _seed_words(seed) -> np.ndarray:
    """Normalize a seed to 8 uint32 words (256 bits of PRF input).

    ``None`` draws full OS entropy (os.urandom) — the PRODUCTION path.
    Small int / word-array seeds are for tests and benchmarks only: a
    32-bit seed makes the whole key space enumerable by seed search
    (ADVICE r3 high), so deployments must pass ``seed=None``.
    """
    if seed is None:
        return np.frombuffer(os.urandom(32), dtype=np.uint32).copy()
    if isinstance(seed, (int, np.integer)):
        w = np.zeros(8, dtype=np.uint32)
        v = int(seed)
        for i in range(8):
            w[i] = v & 0xFFFFFFFF
            v >>= 32
            if not v:
                break
        return w
    w = np.asarray(seed, dtype=np.uint32).reshape(-1)
    assert w.size == 8, f"seed word array must have 8 uint32 words, got {w.size}"
    return w



def _prf_root_and_secrets(params: BinFHEParams, seed_words):
    """Shared PRF derivation for ALL keygens: fold the 256-bit seed into the
    root key, split into the fixed stream order, sample (s, z).

    GINX and AP keygens MUST both use this so one seed yields one LWE
    secret / ring secret / key-switch key across methods (pinned by
    tests/test_devkeygen.py::test_device_keygen_ap_shares_secrets_with_ginx).
    """
    root = jax.random.PRNGKey(0)
    for i in range(8):
        root = jax.random.fold_in(root, seed_words[i])
    ks = jax.random.split(root, 8)  # (s, z, ba, be, aa, ae, ka, ke)
    s = _ternary(ks[0], (params.n,))
    z = _ternary(ks[1], (params.N,))
    return ks, s, z


def _keyswitch_key_limbs(params: BinFHEParams, k_ka, k_ke, s, z):
    """Key-switch key as centered base-256 int8 limbs (shared by both
    method keygens; derivation identical to golden.keyswitch_keygen)."""
    p = params
    N, n, Qks = p.N, p.n, p.Q_ks
    d_ks, B_ks = p.d_ks, p.B_ks
    Aks = _uniform_mod(k_ka, (N * d_ks, n), Qks)
    Eks = _gauss(k_ke, p.sigma, (N * d_ks,))
    gk = jnp.asarray([pow(B_ks, j, Qks) for j in range(d_ks)], jnp.int32)
    zg = (jnp.repeat(z, d_ks) * jnp.tile(gk, N)) % Qks
    bks = (jnp.einsum("ki,i->k", Aks, s) + Eks + zg) % Qks
    ksk = jnp.concatenate([Aks, bks[:, None]], axis=1)
    kc = ksk - (ksk >= Qks // 2) * Qks  # centered
    l0 = kc - ((kc + 128) >> 8 << 8)
    l1 = (kc - l0) >> 8
    return jnp.stack([l0, l1], axis=-1).astype(jnp.int8)


def _refresh_keys_compact(p: BinFHEParams, k_a, k_e, z, msg_a, msg_b, Q):
    """RGSW rows with messages added to coefficient-aligned slots ->
    compact limb planes.  msg_a / msg_b: [steps, P, R, N] mod Q added to
    the a / b slot (golden.rgsw_encrypt: rows j<d carry m*g in a, rows d+j
    in b)."""
    shape = msg_a.shape
    A = _uniform_mod(k_a, shape, Q)
    E = _gauss(k_e, p.sigma, shape)
    B = modmath.mod_q(_negacyclic_by_ternary(A, z, Q) + E + 2 * Q, Q)
    a_slot = modmath.mod_q(A + msg_a, Q)
    b_slot = modmath.mod_q(B + msg_b, Q)
    rows = jnp.stack([a_slot, b_slot], axis=3)  # [steps, P, R, out, N]
    return _ext_limb_planes(rows, Q)  # [steps, P, R, out, L, 2N]


@functools.partial(jax.jit, static_argnames=("params",))
def _keygen_jit(params: BinFHEParams, seed_words):
    p = params
    n, N, Q = p.n, p.N, p.Q
    d = p.d_g_used
    shift = p.g_shift
    # Security model: all key material (secrets, masks, noise) is derived
    # from the 256-bit seed via the threefry PRF — the standard PRF key
    # derivation assumption.  The seed itself must be full-entropy in
    # production (see _seed_words).
    ks, s, z = _prf_root_and_secrets(params, seed_words)
    k_s, k_z, k_ba, k_be, k_aa, k_ae, k_ka, k_ke = ks

    # ---- GINX refresh keys --------------------------------------------------
    # parts: m = (s==1), (s==-1); rows j<d add m*g to a, rows d+j to b.
    m = jnp.stack([(s == 1), (s == -1)], axis=1).astype(jnp.int32)  # [n, 2]
    g = jnp.asarray(
        [(pow(p.B_g, j, Q) << shift) % Q for j in range(d)], jnp.int32
    )  # [d]
    mg = m[:, :, None] * g[None, None, :]  # [n, 2, d] (< Q since m in {0,1})
    zero = jnp.zeros_like(mg)
    coeff0 = jnp.zeros((N,), jnp.int32).at[0].set(1)  # m is a scalar message
    add_a = jnp.concatenate([mg, zero], axis=2)[..., None] * coeff0
    add_b = jnp.concatenate([zero, mg], axis=2)[..., None] * coeff0
    kext = _refresh_keys_compact(p, k_ba, k_be, z, add_a, add_b, Q)

    ksk_limbs = _keyswitch_key_limbs(p, k_ka, k_ke, s, z)
    return s, z, pack_layout(kext), ksk_limbs


@functools.partial(jax.jit, static_argnames=("params",))
def _keygen_ap_jit(params: BinFHEParams, seed_words):
    """Binary-base AP refresh keys: ak[i, j, v=1] = RGSW(X^{2^j s_i mod 2N})
    for the n*d_r steps.  v=0 is the identity and stays a public-bit select
    on device (boot.ap_binary_step).

    Secrets (s, z) and the key-switch key derive from the same PRF splits
    as the GINX keygen, so GINX and AP keys of one seed share ciphertext
    compatibility (same LWE secret, same ksk).
    """
    p = params
    n, N, Q = p.n, p.N, p.Q
    assert p.B_r == 2, "device AP keygen targets the binary rotation base"
    d = p.d_g_used
    shift = p.g_shift
    d_r = p.d_r
    ks, s, z = _prf_root_and_secrets(params, seed_words)
    k_s, k_z, k_ba, k_be, k_aa, k_ae, k_ka, k_ke = ks

    steps = n * d_r
    jj = jnp.arange(d_r, dtype=jnp.int32)
    # exponent of the v=1 monomial per (i, j): (2^j * s_i) mod 2N
    c = (s[:, None] * (1 << jj)[None, :]) % (2 * N)  # [n, d_r] in [0, 2N)
    c = c.reshape(steps)
    # monomial ring message: mono[cc] = ±1 mod Q with X^N == -1 wraparound
    kpos = jnp.arange(N, dtype=jnp.int32)
    sgn = jnp.where(c < N, 1, Q - 1).astype(jnp.int32)
    mono = jnp.where(
        kpos[None, :] == (c % N)[:, None], sgn[:, None], 0
    )  # [steps, N]
    g = jnp.asarray(
        [(pow(p.B_g, j_, Q) << shift) % Q for j_ in range(d)], jnp.int32
    )
    # mono entries are {0, 1, Q-1}: form (mono * g) mod Q without the
    # int32-overflowing product (Q-1)*g
    m_b = mono[:, None, :]  # [steps, 1, N]
    g_b = g[None, :, None]  # [1, d, 1]
    mg = (m_b == 1) * g_b + (m_b == (Q - 1)) * (Q - g_b)  # [steps, d, N] < Q
    zero = jnp.zeros_like(mg)
    add_a = jnp.concatenate([mg, zero], axis=1)[:, None]  # [steps, 1, R, N]
    add_b = jnp.concatenate([zero, mg], axis=1)[:, None]
    kext = _refresh_keys_compact(p, k_aa, k_ae, z, add_a, add_b, Q)

    ksk_limbs = _keyswitch_key_limbs(p, k_ka, k_ke, s, z)
    return s, z, pack_layout(kext), ksk_limbs


def _device_keys(params, method, seed, jit_fn):
    s, z, brk, ksk_limbs = jit_fn(params, jnp.asarray(_seed_words(seed)))
    s_host = np.asarray(s).astype(np.int64)  # 2 KB fetch
    sk = golden.LWESecretKey(s=s_host, params=params)
    dkeys = boot.DeviceBootKeys(
        params=params, method=method, brk=brk, ap_kext=None, ksk=ksk_limbs,
        tv_table=boot.make_tv_table(params),
    )
    return sk, z, dkeys


def device_keygen(
    params: BinFHEParams, seed=None
) -> tuple[golden.LWESecretKey, jnp.ndarray, boot.DeviceBootKeys]:
    """Generate GINX bootstrap keys ON DEVICE from a seed.

    ``seed=None`` (the production default) derives the key from 256 bits of
    OS entropy; an int or uint32[8] array gives a deterministic key for
    tests/benchmarks (NOT secure — 2**31 seeds are enumerable).

    Returns (sk_host, z_dev, DeviceBootKeys) — the LWE secret is downloaded
    (2 KB) so the host can encrypt/decrypt; everything else stays on device.
    """
    return _device_keys(params, BinFHEMethod.GINX, seed, _keygen_jit)


def device_keygen_ap(
    params: BinFHEParams, seed=None
) -> tuple[golden.LWESecretKey, jnp.ndarray, boot.DeviceBootKeys]:
    """Generate binary-base AP bootstrap keys ON DEVICE from a seed (same
    seed policy and return value as device_keygen)."""
    return _device_keys(params, BinFHEMethod.AP, seed, _keygen_ap_jit)
