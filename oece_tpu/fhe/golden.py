"""Exact NumPy golden model of the FHEW/TFHE scheme.

This is the correctness anchor for the device implementation: every JAX
function in ``fhe/`` must reproduce these functions *bit-exactly* given the same
keys and ciphertexts.  All randomness (key generation, encryption noise) lives
here on the host; the device-side bootstrap (fhe/boot.py) is a deterministic
function of (ciphertext, keys), which is what makes bitwise differential
testing possible.

Functional parity targets (reference call sites, SURVEY.md §2.8):
  * ``BinFHEContext::KeyGen``      -> :func:`lwe_keygen`           (circuit.cpp:90)
  * ``BinFHEContext::Encrypt``     -> :func:`lwe_encrypt`          (circuit.cpp:506)
  * ``BinFHEContext::Decrypt``     -> :func:`lwe_decrypt`          (circuit.cpp:800)
  * ``BinFHEContext::BTKeyGen``    -> :func:`bootstrap_keygen`     (circuit.cpp:91)
  * ``BinFHEContext::EvalBinGate`` -> :func:`eval_bin_gate`        (gate.cpp:133,171)
  * ``BinFHEContext::EvalNOT``     -> :func:`eval_not`             (gate.cpp:112)

Arithmetic safety: everything is int64 NumPy; the largest products are
Q**2 < 2**54 which fits exactly.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .params import BinFHEParams, BinFHEMethod, BinGate

# ---------------------------------------------------------------------------
# Ring helpers: Z_Q[X]/(X^N + 1)
# ---------------------------------------------------------------------------


def negacyclic_matrix(b: np.ndarray, Q: int) -> np.ndarray:
    """Dense negacyclic multiplication matrix M with (a ⊛ b) = a @ M.

    M[i, k] = sign * b[(k - i) mod N], negated when (k - i) wraps below 0.
    This identical construction is used on-device to turn polynomial products
    into int8 matmuls (fhe/boot.py).
    """
    b = np.asarray(b, dtype=np.int64) % Q
    N = b.shape[-1]
    b_ext = np.concatenate([b, (-b) % Q], axis=-1)  # [..., 2N]
    i = np.arange(N)[:, None]
    k = np.arange(N)[None, :]
    idx = (k - i) % (2 * N)  # [N, N]
    return b_ext[..., idx]  # [..., N, N]


def negacyclic_mul(a: np.ndarray, b: np.ndarray, Q: int) -> np.ndarray:
    """Exact negacyclic polynomial product a ⊛ b in Z_Q[X]/(X^N+1).

    Vectorized O(N^2) with 14-bit limb splitting of `a` so int64 partial sums
    never exceed 2**51 (Q < 2**27, N <= 2**10).
    """
    a = np.asarray(a, dtype=np.int64) % Q
    M = negacyclic_matrix(np.asarray(b, dtype=np.int64), Q)
    a_lo = a & 0x3FFF
    a_hi = a >> 14
    lo = np.einsum("...i,...ik->...k", a_lo, M)
    hi = np.einsum("...i,...ik->...k", a_hi, M)
    return (lo % Q + (hi % Q) * (1 << 14)) % Q


def negacyclic_monomial_mul(p: np.ndarray, c: int, N: int, Q: int) -> np.ndarray:
    """p(X) * X^c in Z_Q[X]/(X^N+1), c taken mod 2N."""
    c = int(c) % (2 * N)
    out = np.empty_like(p)
    sign = 1
    if c >= N:
        c -= N
        sign = -1
    if c == 0:
        out[...] = (sign * p) % Q
        return out
    out[..., c:] = (sign * p[..., : N - c]) % Q
    out[..., :c] = (-sign * p[..., N - c :]) % Q
    return out


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------


def gauss(rng: np.random.Generator, sigma: float, shape) -> np.ndarray:
    """Rounded continuous Gaussian (the standard FHEW noise sampler)."""
    return np.rint(rng.normal(0.0, sigma, shape)).astype(np.int64)


def ternary(rng: np.random.Generator, shape) -> np.ndarray:
    return rng.integers(-1, 2, shape, dtype=np.int64)


def binary(rng: np.random.Generator, shape) -> np.ndarray:
    return rng.integers(0, 2, shape, dtype=np.int64)


# ---------------------------------------------------------------------------
# LWE: ciphertexts are length n+1 int64 vectors (a_0..a_{n-1}, b), modulus q.
#   b = <a, s> + e + m * q/4       (q/4 encoding, OpenFHE binfhe convention)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LWESecretKey:
    s: np.ndarray  # [n] in {-1,0,1} (ternary) or {0,1}
    params: BinFHEParams


def lwe_keygen(params: BinFHEParams, rng: np.random.Generator) -> LWESecretKey:
    sample = ternary if params.secret == "ternary" else binary
    return LWESecretKey(s=sample(rng, (params.n,)), params=params)


def lwe_encrypt(
    sk: LWESecretKey, m: int, rng: np.random.Generator, q: int | None = None
) -> np.ndarray:
    """Encrypt bit m under modulus q (default params.q) with q/4 encoding."""
    p = sk.params
    q = q or p.q
    a = rng.integers(0, q, (p.n,), dtype=np.int64)
    e = int(gauss(rng, p.sigma, ()))
    b = (int(a @ sk.s) + e + (int(m) % 4) * (q // 4)) % q
    return np.concatenate([a, np.array([b], dtype=np.int64)])


def lwe_phase(sk_s: np.ndarray, ct: np.ndarray, q: int) -> int:
    a, b = ct[:-1], int(ct[-1])
    return (b - int(a @ sk_s)) % q


def lwe_decrypt(sk: LWESecretKey, ct: np.ndarray, q: int | None = None) -> int:
    """Decrypt to a bit: round(phase / (q/4)) mod 4 -> expect 0 or 1."""
    p = sk.params
    q = q or p.q
    phase = lwe_phase(sk.s, ct, q)
    return int(((phase + q // 8) // (q // 4)) % 4) & 1


def eval_not(ct: np.ndarray, q: int) -> np.ndarray:
    """EvalNOT: (-a, q/4 - b).  Linear, no bootstrap (gate.cpp:112)."""
    out = (-ct) % q
    out[-1] = (q // 4 + out[-1]) % q
    return out


def lwe_mod_switch(ct: np.ndarray, q_from: int, q_to: int) -> np.ndarray:
    """Round-to-nearest modulus switch."""
    return ((np.asarray(ct, dtype=np.int64) * q_to * 2 + q_from) // (2 * q_from)) % q_to


# ---------------------------------------------------------------------------
# Gadget decomposition: signed balanced base-B digits.
#   v = sum_j d_j * B^j with d_j in [-B/2, B/2); exact for v in [0, B^d).
# ---------------------------------------------------------------------------


def signed_digits(v: np.ndarray, B: int, d: int) -> np.ndarray:
    """Decompose nonneg ints v (any shape) into d signed base-B digits.

    Returns shape v.shape + (d,), digits in [-B/2, B/2).  Any residual carry is
    dropped: only valid when B^d ≡ 0 (mod working modulus), as in key
    switching where B_ks^d_ks == Q_ks exactly.
    """
    v = np.asarray(v, dtype=np.int64)
    digs = np.empty(v.shape + (d,), dtype=np.int64)
    cur = v.copy()
    half = B // 2
    for j in range(d):
        r = cur % B
        r = np.where(r >= half, r - B, r)
        digs[..., j] = r
        cur = (cur - r) // B
    return digs


def gadget_digits(v: np.ndarray, B: int, d: int) -> np.ndarray:
    """Gadget decomposition for external products: signed digits for positions
    0..d-2 and an *unsigned* top digit, so sum_j d_j B^j == v exactly.

    For v in [0, Q) with Q < 2**27, B = 2**7, d = 4 the top digit lies in
    [0, 66] — still int8-safe on device.
    """
    v = np.asarray(v, dtype=np.int64)
    digs = np.empty(v.shape + (d,), dtype=np.int64)
    cur = v.copy()
    half = B // 2
    for j in range(d - 1):
        r = cur % B
        r = np.where(r >= half, r - B, r)
        digs[..., j] = r
        cur = (cur - r) // B
    digs[..., d - 1] = cur
    return digs


def gadget_digits_approx(
    v: np.ndarray, Q: int, B: int, d_eff: int, shift: int
) -> np.ndarray:
    """TFHE-style approximate gadget decomposition.

    Center v in (-Q/2, Q/2], round away the low ``shift`` bits, then take
    ``d_eff`` signed base-B digits:  sum_j dig_j * (B**j * 2**shift)  ==
    round(center(v) / 2**shift) * 2**shift  =  center(v) - r,  |r| <=
    2**(shift-1).  Digits lie in [-B/2, B/2] (top digit may hit +B/2 at the
    extreme boundary), int8-safe for B <= 128.  Bit-identical to the device
    path (fhe/boot.gadget_digits_approx_dev).
    """
    v = np.asarray(v, dtype=np.int64)
    c = np.where(v >= (Q + 1) // 2, v - Q, v)
    r = (c + (1 << (shift - 1))) >> shift  # floor((c + 2^(s-1)) / 2^s)
    digs = np.empty(v.shape + (d_eff,), dtype=np.int64)
    half = B // 2
    cur = r
    for j in range(d_eff - 1):
        dj = ((cur + half) & (B - 1)) - half
        digs[..., j] = dj
        cur = (cur - dj) >> int(np.log2(B))
    digs[..., d_eff - 1] = cur
    return digs


# ---------------------------------------------------------------------------
# RLWE / RGSW over R_Q = Z_Q[X]/(X^N+1)
#
# RLWE ciphertext of message z (a ring element): (a, b) with b = a*s + e + z.
# RGSW ciphertext of scalar/ring z: 2*d_g RLWE rows:
#     row j      (j<d_g) : RLWE( z * B_g^j * s )   ("a-part" rows)
#     row d_g+j          : RLWE( z * B_g^j )       ("b-part" rows)
# External product  RLWE'(m) ⊡ RGSW(z) -> RLWE(m*z):
#     decompose (a, b) into signed digits, dot with the RGSW rows.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RGSWKey:
    """Ring secret + per-coefficient RGSW encryptions of the LWE secret bits."""

    z: np.ndarray  # ring secret s(X), [N]
    params: BinFHEParams


def rlwe_encrypt(
    params: BinFHEParams, z_ring: np.ndarray, msg: np.ndarray, rng: np.random.Generator
) -> np.ndarray:
    """RLWE encryption of ring message msg: returns [2, N] = (a, b)."""
    N, Q = params.N, params.Q
    a = rng.integers(0, Q, (N,), dtype=np.int64)
    e = gauss(rng, params.sigma, (N,))
    b = (negacyclic_mul(a, z_ring, Q) + e + np.asarray(msg, dtype=np.int64)) % Q
    return np.stack([a, b])


def rgsw_encrypt(
    params: BinFHEParams, z_ring: np.ndarray, m: np.ndarray | int, rng: np.random.Generator
) -> np.ndarray:
    """RGSW encryption of message m (scalar or ring elt): [2*d_g_used, 2, N].

    With the approximate gadget (params.d_g_eff > 0) the gadget values are
    B_g**j * 2**g_shift and only d_g_eff row pairs exist."""
    N, Q, B_g = params.N, params.Q, params.B_g
    d_g, shift = params.d_g_used, params.g_shift
    if np.isscalar(m):
        m_ring = np.zeros(N, dtype=np.int64)
        m_ring[0] = int(m) % Q
    else:
        m_ring = np.asarray(m, dtype=np.int64) % Q
    rows = []
    for j in range(d_g):
        g = (pow(B_g, j, Q) << shift) % Q
        # a-part row: RLWE( -m * g * s )  encoded in the 'a' slot:
        # we use the standard form: row = (a + m*g, a*s + e)  so that
        # <digits(a-part), rows> contributes  m*g*digit  to the a slot.
        a = rng.integers(0, Q, (N,), dtype=np.int64)
        e = gauss(rng, params.sigma, (N,))
        b = (negacyclic_mul(a, z_ring, Q) + e) % Q
        a2 = (a + m_ring * g) % Q
        rows.append(np.stack([a2, b]))
    for j in range(d_g):
        g = (pow(B_g, j, Q) << shift) % Q
        a = rng.integers(0, Q, (N,), dtype=np.int64)
        e = gauss(rng, params.sigma, (N,))
        b = (negacyclic_mul(a, z_ring, Q) + e + m_ring * g) % Q
        rows.append(np.stack([a, b]))
    return np.stack(rows)  # [2*d_g_used, 2, N]


def _ep_digits(params: BinFHEParams, poly: np.ndarray) -> np.ndarray:
    """Gadget digits of one accumulator polynomial (exact or approximate)."""
    if params.d_g_eff:
        return gadget_digits_approx(
            poly % params.Q, params.Q, params.B_g, params.d_g_eff, params.g_shift
        )
    return gadget_digits(poly % params.Q, params.B_g, params.d_g)


def external_product(params: BinFHEParams, ct: np.ndarray, rgsw: np.ndarray) -> np.ndarray:
    """RLWE (2,N) ⊡ RGSW (2*d_g_used,2,N) -> RLWE (2,N) encrypting
    m_ct * m_rgsw (up to the approximate-gadget rounding term when
    params.d_g_eff > 0)."""
    Q, d_g = params.Q, params.d_g_used
    da = _ep_digits(params, ct[0])  # [N, d_g_used]
    db = _ep_digits(params, ct[1])
    acc = np.zeros((2, params.N), dtype=np.int64)
    for j in range(d_g):
        acc = (acc + negacyclic_mul(da[:, j], rgsw[j], Q)) % Q
        acc = (acc + negacyclic_mul(db[:, j], rgsw[d_g + j], Q)) % Q
    return acc


# ---------------------------------------------------------------------------
# Bootstrapping keys
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BootstrapKey:
    """Everything BTKeyGen produces (reference circuit.cpp:91).

    brk_pos/brk_neg : GINX refresh keys, RGSW(s+_i)/RGSW(s-_i), [n, 2*d_g, 2, N]
    ak              : AP refresh keys, [n, d_r, B_r, 2*d_g, 2, N] (optional)
    ksk             : key-switch key KS[i,j] = LWE_{Qks}(z_i * B_ks^j * ...)
                      stored as [N, d_ks, n+1] int64 mod Q_ks
    z               : ring secret (kept for tests only)
    """

    brk_pos: np.ndarray | None
    brk_neg: np.ndarray | None
    ak: np.ndarray | None
    ksk: np.ndarray
    z: np.ndarray
    params: BinFHEParams
    method: BinFHEMethod


def keyswitch_keygen(
    params: BinFHEParams, z_ring: np.ndarray, sk: LWESecretKey, rng: np.random.Generator
) -> np.ndarray:
    """KS key: for each ring-coeff i and digit j, LWE_{Q_ks,n}( z_i * B_ks^j ).

    Multiplication-style key switching (one int8 matmul on device):
        ct'(n) = sum_{i,j} digit_{i,j}(a_i) * KS[i,j]  then  b' += b.
    """
    N, n, Qks, d_ks, B_ks = params.N, params.n, params.Q_ks, params.d_ks, params.B_ks
    z = np.asarray(z_ring, dtype=np.int64)
    ksk = np.empty((N, d_ks, n + 1), dtype=np.int64)
    for i in range(N):
        for j in range(d_ks):
            a = rng.integers(0, Qks, (n,), dtype=np.int64)
            e = int(gauss(rng, params.sigma, ()))
            b = (int(a @ sk.s) + e + int(z[i]) * pow(B_ks, j, Qks)) % Qks
            ksk[i, j, :n] = a
            ksk[i, j, n] = b
    return ksk


def bootstrap_keygen(
    params: BinFHEParams,
    sk: LWESecretKey,
    rng: np.random.Generator,
    method: BinFHEMethod = BinFHEMethod.GINX,
) -> BootstrapKey:
    """BTKeyGen: ring secret, refresh keys (GINX or AP), key-switch key."""
    N = params.N
    z = ternary(rng, (N,)) if params.secret == "ternary" else binary(rng, (N,))
    ksk = keyswitch_keygen(params, z, sk, rng)
    brk_pos = brk_neg = ak = None
    if method == BinFHEMethod.GINX:
        sp = (sk.s == 1).astype(np.int64)
        sn = (sk.s == -1).astype(np.int64)
        brk_pos = np.stack([rgsw_encrypt(params, z, int(sp[i]), rng) for i in range(params.n)])
        brk_neg = np.stack([rgsw_encrypt(params, z, int(sn[i]), rng) for i in range(params.n)])
    else:
        # AP/DM: for each LWE coeff i, digit position j (base B_r over q) and
        # digit value v: RGSW( X^{ v * B_r^j * s_i } ).
        q, B_r, d_r = params.q, params.B_r, params.d_r
        ak = np.empty(
            (params.n, d_r, B_r, 2 * params.d_g_used, 2, N), dtype=np.int64
        )
        for i in range(params.n):
            for j in range(d_r):
                for v in range(B_r):
                    c = (int(v) * pow(B_r, j, 2 * N) * int(sk.s[i])) % (2 * N)
                    mono = np.zeros(N, dtype=np.int64)
                    sgn, cc = (1, c) if c < N else (-1, c - N)
                    mono[cc] = sgn % params.Q
                    ak[i, j, v] = rgsw_encrypt(params, z, mono, rng)
        ak = np.asarray(ak)
    return BootstrapKey(
        brk_pos=brk_pos, brk_neg=brk_neg, ak=ak, ksk=ksk, z=z,
        params=params, method=method,
    )


# ---------------------------------------------------------------------------
# Gate bootstrap
# ---------------------------------------------------------------------------

# Gate windows over the q-phase circle with q/4 bit encoding (bits {0, q/4}).
# Window [lo, hi) (in units of q/8) where the test function is +Q/8; the
# window must be antiperiodic: [lo + q/2, hi + q/2) == complement.
# Sums: AND/OR see phases {0, q/4, q/2}; XOR uses 2*(c1 - c2) -> {0, ±q/2}.
GATE_WINDOW = {
    BinGate.AND: (3, 7),   # [3q/8, 7q/8): only q/2 inside
    BinGate.NAND: (7, 11),  # complement of AND
    BinGate.OR: (1, 5),    # [q/8, 5q/8): q/4 and q/2 inside
    BinGate.NOR: (5, 9),
    BinGate.XOR: (2, 6),   # on 2*(c1-c2): ±q/2 inside, 0 outside
    BinGate.XNOR: (6, 10),
}


def gate_prepare(gate: BinGate, c1: np.ndarray, c2: np.ndarray, q: int) -> np.ndarray:
    """The linear combination fed into the bootstrap for each gate."""
    if gate in (BinGate.XOR, BinGate.XNOR):
        return (2 * (c1 - c2)) % q
    return (c1 + c2) % q


def make_test_vector(params: BinFHEParams, gate: BinGate) -> np.ndarray:
    """Test polynomial t(X) s.t. blind-rotation extracts f(phase)*Q/8.

    With ACC init = t(X) * X^{b_tilde} and rotation by -<a,s>, coefficient 0 of
    the result equals f(phase_tilde) where phase_tilde = round(2N/q * phase).
    t_j = f_ext(-j) on the 2N circle, folded negacyclically onto N coeffs:
    t(X)_j = f_ext(-j),  f_ext(k+N) = -f_ext(k),  f_ext(k) = +Q/8 iff
    (k mod 2N) in window (scaled to 2N units).
    """
    N, Q, q = params.N, params.Q, params.q
    lo8, hi8 = GATE_WINDOW[gate]
    scale = 2 * N // q  # q <= 2N guaranteed
    lo, hi = lo8 * q // 8 * scale, hi8 * q // 8 * scale
    j = np.arange(2 * N)
    inside = ((j - lo) % (2 * N)) < (hi - lo)
    f_ext = np.where(inside, Q // 8, Q - Q // 8).astype(np.int64)  # ±Q/8 mod Q
    t = np.empty(N, dtype=np.int64)
    idx = (-np.arange(N)) % (2 * N)
    t = f_ext[idx]
    return t % Q


def blind_rotate_ginx(
    params: BinFHEParams, bk: BootstrapKey, ct_2N: np.ndarray, tv: np.ndarray
) -> np.ndarray:
    """GINX/CGGI blind rotation with ternary secret split into +/- parts.

    ct_2N: [n+1] LWE ct already switched to modulus 2N.
    Returns ACC as RLWE [2, N] encrypting (approx) tv * X^{-phase_tilde}... up
    to the convention that coefficient extraction yields f(phase).
    """
    N, Q, n = params.N, params.Q, params.n
    a, b = ct_2N[:-1], int(ct_2N[-1])
    acc = np.zeros((2, N), dtype=np.int64)
    acc[1] = negacyclic_monomial_mul(tv, b, N, Q)
    for i in range(n):
        ai = int(a[i]) % (2 * N)
        if ai == 0:
            continue
        # parallel CMUX pair: acc += (X^{-a_i}-1)(acc ⊡ Z+_i) + (X^{a_i}-1)(acc ⊡ Z-_i)
        p_pos = external_product(params, acc, bk.brk_pos[i])
        p_neg = external_product(params, acc, bk.brk_neg[i])
        rot_pos = negacyclic_monomial_mul(p_pos, (2 * N - ai), N, Q)
        rot_neg = negacyclic_monomial_mul(p_neg, ai, N, Q)
        acc = (acc + rot_pos - p_pos + rot_neg - p_neg) % Q
    return acc


def blind_rotate_ginx_rot(
    params: BinFHEParams, bk: BootstrapKey, ct_2N: np.ndarray, tv: np.ndarray
) -> np.ndarray:
    """GINX blind rotation in the CGGI ROTATED-DIFFERENCE form (the device
    step's golden twin, fhe/boot.ginx_step): per step,

        acc += Z+_i ⊡ ((X^{-a_i} - 1) * acc)  +  Z-_i ⊡ ((X^{a_i} - 1) * acc)

    i.e. the monomial rotation applies to the ACCUMULATOR before gadget
    decomposition (the original CMUX of Chillotti et al. 2016), instead of
    to the external-product output afterwards (blind_rotate_ginx above,
    which mirrors the per-output-rotation layout the r1-r3 kernels used).
    Same contract, same matmul work, but the device step needs no post-matmul
    rotation/subtraction pass — and the decomposition rounding error is NOT
    amplified by the (X^c - 1) factor, so per-step noise is slightly lower.

    Kept separate from blind_rotate_ginx (not a flag) because the two forms
    produce different ciphertext bits for identical keys and the device
    kernels are pinned bit-exactly against their matching golden form.
    """
    N, Q, n = params.N, params.Q, params.n
    a, b = ct_2N[:-1], int(ct_2N[-1])
    acc = np.zeros((2, N), dtype=np.int64)
    acc[1] = negacyclic_monomial_mul(tv, b, N, Q)
    for i in range(n):
        ai = int(a[i]) % (2 * N)
        if ai == 0:
            continue
        d_pos = (negacyclic_monomial_mul(acc, 2 * N - ai, N, Q) - acc) % Q
        d_neg = (negacyclic_monomial_mul(acc, ai, N, Q) - acc) % Q
        p_pos = external_product(params, d_pos, bk.brk_pos[i])
        p_neg = external_product(params, d_neg, bk.brk_neg[i])
        acc = (acc + p_pos + p_neg) % Q
    return acc


def blind_rotate_ap(
    params: BinFHEParams, bk: BootstrapKey, ct_2N: np.ndarray, tv: np.ndarray
) -> np.ndarray:
    """AP/DM blind rotation: digit-decompose each a_i, multiply ACC by
    RGSW(X^{v B_r^j s_i}) looked up from the rotation key."""
    N, Q, n = params.N, params.Q, params.n
    B_r, d_r = params.B_r, params.d_r
    a, b = ct_2N[:-1], int(ct_2N[-1])
    acc = np.zeros((2, N), dtype=np.int64)
    acc[1] = negacyclic_monomial_mul(tv, b, N, Q)
    for i in range(n):
        ai = int(-a[i]) % (2 * N)  # rotate by -a_i * s_i in total
        for j in range(d_r):
            v = (ai // (B_r**j)) % B_r
            # v == 0 is the identity rotation: skipped entirely (the device
            # paths select the unchanged accumulator for v == 0 gates, so
            # skipping keeps golden<->device bit-exact AND saves noise).
            if v == 0:
                continue
            acc = external_product(params, acc, bk.ak[i, j, v])
    return acc


def sample_extract(params: BinFHEParams, acc: np.ndarray) -> np.ndarray:
    """Extract coefficient 0 of the RLWE ACC as an LWE_{N,Q} ciphertext.

    phase_0(acc) = b_0 - sum_i a'_i z_i with a'_0 = a_0, a'_i = -a_{N-i}.
    """
    N, Q = params.N, params.Q
    a = acc[0]
    a_ext = np.empty(N, dtype=np.int64)
    a_ext[0] = a[0]
    a_ext[1:] = (-a[1:][::-1]) % Q
    return np.concatenate([a_ext, acc[1][:1]])


def key_switch(params: BinFHEParams, ksk: np.ndarray, ct_N: np.ndarray) -> np.ndarray:
    """LWE dim-N mod-Q_ks -> dim-n mod-Q_ks using the multiplication-form key."""
    N, n, Qks = params.N, params.n, params.Q_ks
    d_ks, B_ks = params.d_ks, params.B_ks
    a, b = ct_N[:-1] % Qks, int(ct_N[-1]) % Qks
    digs = signed_digits(a, B_ks, d_ks)  # [N, d_ks]
    out = np.zeros(n + 1, dtype=np.int64)
    out[n] = b
    # b' = b - sum digit * KS_b ; a' = -sum digit * KS_a   (subtracting re-keys)
    acc = np.tensordot(digs.reshape(-1), ksk.reshape(N * d_ks, n + 1), axes=1)
    out = (out - acc) % Qks
    return out


def bootstrap(
    params: BinFHEParams, bk: BootstrapKey, ct: np.ndarray, gate: BinGate,
    form: str = "std",
) -> np.ndarray:
    """Full gate bootstrap of the prepared LWE ct (mod q) -> fresh ct (mod q).

    ``form="rot"`` selects the rotated-difference GINX step
    (blind_rotate_ginx_rot — the device step's golden twin)."""
    N, Q, q = params.N, params.Q, params.q
    ct_2N = lwe_mod_switch(ct, q, 2 * N)
    tv = make_test_vector(params, gate)
    if bk.method == BinFHEMethod.GINX:
        rot_fn = blind_rotate_ginx_rot if form == "rot" else blind_rotate_ginx
        acc = rot_fn(params, bk, ct_2N, tv)
    else:
        acc = blind_rotate_ap(params, bk, ct_2N, tv)
    ct_N = sample_extract(params, acc)
    ct_N[-1] = (ct_N[-1] + Q // 8) % Q  # ±Q/8 -> {0, Q/4}
    ct_ks_in = lwe_mod_switch(ct_N, Q, params.Q_ks)
    ct_n = key_switch(params, bk.ksk, ct_ks_in)
    return lwe_mod_switch(ct_n, params.Q_ks, q)


def eval_bin_gate(
    params: BinFHEParams, bk: BootstrapKey, gate: BinGate, c1: np.ndarray,
    c2: np.ndarray, form: str = "std",
) -> np.ndarray:
    """EvalBinGate parity (gate.cpp:133,171): one bootstrap per gate
    (``form`` as in bootstrap)."""
    prep = gate_prepare(gate, c1, c2, params.q)
    return bootstrap(params, bk, prep, gate, form=form)
