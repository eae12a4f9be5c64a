"""Batched gate bootstrapping on the accelerator.

This is the replacement for OpenFHE's ``EvalBinGate`` (reference call sites
src/gate.cpp:133,171) — the operation that accounts for ~99% of the
reference's encrypted runtime (SURVEY.md §3.5).  Instead of the reference's
one-gate-per-OpenMP-task model (circuit.cpp:698-710), gates are evaluated in
large batches: a whole circuit level (plus test-case batching) bootstraps as
one ``lax.scan`` whose body is a single int8 matrix product.

Design (GINX / CGGI blind rotation, ternary secret split into +/- parts,
rotated-difference form — golden.blind_rotate_ginx_rot):

  * The accumulator RLWE ciphertext ACC lives as int32 [B, 2, N] in [0, Q).
  * Each of the n scan steps forms the two rotated differences
    (X^{-a_i} - 1)·ACC and (X^{a_i} - 1)·ACC, gadget-decomposes both into
    signed int8 digits [B, 2*R*N] (R = 2*d_g_used) and contracts them with
    the step's RGSW key in ONE s8 x s8 -> s32 ``dot_general``.  The
    contraction is exact: |sum| <= 2*R*N * 128 * 128 = 2**27 < 2**31.
  * Key limbs are recombined mod Q with int32-only arithmetic
    (fhe/modmath.py) and the CMUX add closes the step.
  * Sample-extract, Q->Q_ks mod switch, a key-switch int8 matmul, and the
    final Q_ks->q mod switch produce fresh gate ciphertexts.

Key layout: see ``DeviceBootKeys`` (block-Toeplitz: the 2*nt-1 distinct
T x T blocks of each step's dense negacyclic key matrix, chosen over a
compact key plus a per-step gather by measured SHA-256 wall; PERF.md).
Binary-base AP (B_r = 2) uses the
same contraction against the shared v=1 rotation key followed by a
public-bit select; generic-base AP keeps a per-gate gather path.

Bit-exactness: every step is exact integer arithmetic, so the whole pipeline
matches fhe/golden.py bit-for-bit given identical keys (tests/test_boot.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import golden, modmath
from .params import BinFHEParams, BinFHEMethod, BinGate

# Fixed gate enumeration for per-gate test-vector / prep-weight tables.
GATE_ORDER = [
    BinGate.AND,
    BinGate.OR,
    BinGate.NAND,
    BinGate.NOR,
    BinGate.XOR,
    BinGate.XNOR,
]
GATE_INDEX = {g: i for i, g in enumerate(GATE_ORDER)}

# gate_prepare weights (golden.gate_prepare): prep = w1*c1 + w2*c2 mod q.
PREP_WEIGHTS = np.array(
    [[1, 1], [1, 1], [1, 1], [1, 1], [2, -2], [2, -2]], dtype=np.int32
)

# Row alignment of int8 matrix operands (batch rows, key-switch columns):
# the int8 GEMM routes want every dimension a multiple of 4.
GEMM_ALIGN = 4

# Tile edge of the block-Toeplitz key layout.
TILE = 128


# ---------------------------------------------------------------------------
# Key packing (host side, NumPy): golden.BootstrapKey -> device arrays.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DeviceBootKeys:
    """Device-resident bootstrap key material.

    brk      : int8 refresh keys of the shared-key contraction.  GINX: one
               entry per LWE coefficient, parts P = 2 (s = +1, s = -1).
               Binary-base AP: one entry per (coefficient, digit) step, the
               v = 1 key only, P = 1.  Block-Toeplitz layout
               [steps, out*L*T, 2*nt-1, P, R, T] (T = TILE, nt = N/T,
               L = 4 limbs): the 2*nt-1 distinct T x T blocks of the step's
               dense [P*R*N, out*L*N] negacyclic matrix, stored transposed
               (the int8 GEMM's preferred [out, contraction] order); output
               tile k contracts the static block slice nt-1-k .. 2nt-2-k.
               Tensor parallelism shards the R axis.
    ap_kext  : int8 [n, d_r, B_r, R, out, L, 2N] generic-base AP keys
               (per-gate gather path; B_r > 2 only)
    ksk      : int8 [N*d_ks, n+1, 2]  centered base-256 limbs mod Q_ks
    tv_table : int32 [len(GATE_ORDER), N] test vectors mod Q
    """

    params: BinFHEParams
    method: BinFHEMethod
    brk: Optional[jnp.ndarray]
    ap_kext: Optional[jnp.ndarray]
    ksk: jnp.ndarray
    tv_table: jnp.ndarray


def _dbk_flatten(k: DeviceBootKeys):
    return ((k.brk, k.ap_kext, k.ksk, k.tv_table), (k.params, k.method))


def _dbk_unflatten(aux, children):
    params, method = aux
    brk, ap_kext, ksk, tv_table = children
    return DeviceBootKeys(
        params=params, method=method, brk=brk, ap_kext=ap_kext, ksk=ksk,
        tv_table=tv_table,
    )


jax.tree_util.register_pytree_node(DeviceBootKeys, _dbk_flatten, _dbk_unflatten)


def _poly_ext_limbs(polys: np.ndarray, Q: int) -> np.ndarray:
    """[..., N] int64 mod Q -> [..., L, 2N] int8: limbs of v and of (-v mod Q).

    Used to materialize negacyclic matrices on device by gathering along the
    last (2N) axis.
    """
    v = np.asarray(polys, dtype=np.int64) % Q
    neg = (Q - v) % Q
    ext = np.concatenate([v, neg], axis=-1)  # [..., 2N]
    limbs = modmath.to_limbs_i8(ext)  # [..., 2N, L]
    return np.moveaxis(limbs, -1, -2)  # [..., L, 2N]


def toeplitz_index(N: int, xp=np):
    """[2*nt-1, T(u), T(t)] index into the 2N extension: block d' holds
    ((nt-1-d')*T + t - u) mod 2N."""
    assert N % TILE == 0, N
    T, nt = TILE, N // TILE
    dp = xp.arange(2 * nt - 1)[:, None, None]
    u = xp.arange(T)[None, :, None]
    t = xp.arange(T)[None, None, :]
    return ((nt - 1 - dp) * T + t - u) % (2 * N)


def toeplitz_blocks(kext, xp=np):
    """Limb planes [..., P, R, O, L, 2N] -> [..., O*L*T, 2nt-1, P, R, T].

    Entry (o, l, t; d', p, r, u) holds kext[p, r, o, l,
    ((nt-1-d')*T + t - u) mod 2N]: block d' = nt-1-k+j is the (input tile
    j, output tile k) block of the dense negacyclic matrix."""
    *lead, P, R, O, L, two_n = kext.shape
    g = kext[..., toeplitz_index(two_n // 2, xp)]  # [.., P, R, O, L, nd, u, t]
    nl = len(lead)
    perm = tuple(range(nl)) + tuple(
        nl + a for a in (2, 3, 6, 4, 0, 1, 5)
    )  # -> [..., O, L, t, nd, P, R, u]
    g = xp.transpose(g, perm)
    return g.reshape(*lead, O * L * TILE, *g.shape[nl + 3:])


def pack_bootstrap_key(bk: golden.BootstrapKey) -> DeviceBootKeys:
    """Pack golden keys for the device (the layout device keygen emits)."""
    p = bk.params
    Q = p.Q
    brk = ap_kext = None
    if bk.method == BinFHEMethod.GINX:
        polys = np.stack([bk.brk_pos, bk.brk_neg], axis=1)  # [n, P, R, out, N]
        brk = jnp.asarray(toeplitz_blocks(_poly_ext_limbs(polys, Q)))
    elif p.B_r == 2:
        # binary-base AP: pack only the v=1 keys; v=0 is the identity and
        # becomes a public-bit select on device.
        v1 = bk.ak[:, :, 1]  # [n, d_r, R, out, N]
        v1 = v1.reshape(-1, 1, *v1.shape[2:])  # [n*d_r, P=1, R, out, N]
        brk = jnp.asarray(toeplitz_blocks(_poly_ext_limbs(v1, Q)))
    else:
        ap_kext = jnp.asarray(_poly_ext_limbs(bk.ak, Q))

    return DeviceBootKeys(
        params=p,
        method=bk.method,
        brk=brk,
        ap_kext=ap_kext,
        ksk=pack_ksk(p, bk.ksk),
        tv_table=make_tv_table(p),
    )


def pack_ksk(p: BinFHEParams, ksk: np.ndarray) -> jnp.ndarray:
    """Key-switch key [N, d_ks, n+1] mod Q_ks -> int8 [N*d_ks, n+1, 2]:
    centered mod Q_ks, then 2 signed base-256 limbs."""
    Qks = p.Q_ks
    ksk = np.asarray(ksk, dtype=np.int64).reshape(p.N * p.d_ks, p.n + 1) % Qks
    ksk_c = np.where(ksk >= Qks // 2, ksk - Qks, ksk)
    l0 = ksk_c - ((ksk_c + 128) >> 8 << 8)  # centered low limb in [-128, 127]
    l1 = (ksk_c - l0) >> 8  # in [-64, 64]
    assert np.all(l0 >= -128) and np.all(l0 <= 127)
    assert np.all(l1 >= -128) and np.all(l1 <= 127)
    assert np.array_equal(l0 + (l1.astype(np.int64) << 8), ksk_c)
    return jnp.asarray(np.stack([l0, l1], axis=-1).astype(np.int8))


def make_tv_table(p: BinFHEParams) -> jnp.ndarray:
    tv = np.stack([golden.make_test_vector(p, g) for g in GATE_ORDER])
    return jnp.asarray(tv.astype(np.int64), dtype=jnp.int32)


# ---------------------------------------------------------------------------
# Device primitives (all int32-safe, jit-compatible).
# ---------------------------------------------------------------------------


def gadget_digits_dev(x: jnp.ndarray, B: int, d: int) -> jnp.ndarray:
    """x int32 [...,] in [0, Q) -> int8 [..., d]; matches golden.gadget_digits."""
    log_b = int(np.log2(B))
    half = B // 2
    digs = []
    cur = x
    for _ in range(d - 1):
        r = cur & (B - 1)
        r = r - (B * (r >= half)).astype(jnp.int32)
        digs.append(r.astype(jnp.int8))
        cur = (cur - r) >> log_b
    digs.append(cur.astype(jnp.int8))
    return jnp.stack(digs, axis=-1)


def gadget_digits_approx_dev(
    x: jnp.ndarray, Q: int, B: int, d_eff: int, shift: int
) -> jnp.ndarray:
    """Approximate gadget digits (golden.gadget_digits_approx, bit-exact):
    center mod Q, round away ``shift`` low bits, d_eff signed base-B digits."""
    c = x - Q * (x >= (Q + 1) // 2).astype(jnp.int32)
    cur = (c + (1 << (shift - 1))) >> shift  # arithmetic shift = floor div
    half = B // 2
    log_b = int(np.log2(B))
    digs = []
    for _ in range(d_eff - 1):
        r = ((cur + half) & (B - 1)) - half
        digs.append(r.astype(jnp.int8))
        cur = (cur - r) >> log_b
    digs.append(cur.astype(jnp.int8))
    return jnp.stack(digs, axis=-1)


def acc_gadget_digits_dev(acc: jnp.ndarray, p: BinFHEParams) -> jnp.ndarray:
    """Dispatch exact/approximate gadget digits: [..., d_g_used] int8."""
    if p.d_g_eff:
        return gadget_digits_approx_dev(acc, p.Q, p.B_g, p.d_g_eff, p.g_shift)
    return gadget_digits_dev(acc, p.B_g, p.d_g)


def signed_digits_dev(x: jnp.ndarray, B: int, d: int) -> jnp.ndarray:
    """All-signed digits (key switching); matches golden.signed_digits."""
    log_b = int(np.log2(B))
    half = B // 2
    digs = []
    cur = x
    for _ in range(d):
        r = cur & (B - 1)
        r = r - (B * (r >= half)).astype(jnp.int32)
        digs.append(r.astype(jnp.int8))
        cur = (cur - r) >> log_b
    return jnp.stack(digs, axis=-1)


def monomial_rotate(P: jnp.ndarray, c: jnp.ndarray, N: int, Q: int) -> jnp.ndarray:
    """P [B, ..., N] * X^{c[B]} in Z_Q[X]/(X^N+1); c in [0, 2N).

    Coefficient k of the product is +-P[(k - c) mod N], negated where
    (k - c) mod 2N >= N (the product wrapped past X^N): one per-lane gather
    (measured faster on the GPU than a log2(N)-round roll barrel; PERF.md).
    """
    cshape = (P.shape[0],) + (1,) * (P.ndim - 1)
    k = jnp.arange(N, dtype=c.dtype)
    src = (k - c.reshape(cshape)) & (2 * N - 1)  # [B, 1.., N]
    x = jnp.take_along_axis(P, jnp.broadcast_to(src & (N - 1), P.shape), axis=-1)
    wrap = src >= N
    return jnp.where(wrap, jnp.where(x == 0, 0, Q - x), x)


def _acc_init(tv_sel: jnp.ndarray, b2N: jnp.ndarray, N: int, Q: int) -> jnp.ndarray:
    """ACC = (0, tv * X^{b~}) as int32 [B, 2, N]."""
    rot = monomial_rotate(tv_sel, b2N, N, Q)  # [B, N]
    return jnp.stack([jnp.zeros_like(rot), rot], axis=1)


def _digits_rows(x: jnp.ndarray, p: BinFHEParams) -> jnp.ndarray:
    """RLWE [B, 2, N] -> gadget digit rows int8 [B, R, N], r = (poly, dig)
    (golden.external_product's RGSW row order)."""
    digs = acc_gadget_digits_dev(x, p)  # [B, 2, N, d]
    B = x.shape[0]
    return jnp.transpose(digs, (0, 1, 3, 2)).reshape(B, 2 * p.d_g_used, p.N)


def _key_product(digs, key_i, p: BinFHEParams, tp_axis=None):
    """Shared-key external product of a batch of digit rows.

    digs  : int8 [B, P, R, N] (R local to the tp shard under tp_axis)
    key_i : one step of DeviceBootKeys.brk, [O*L*T, 2nt-1, P, R, T]
    -> int32 [B, 2, N] mod Q:  sum_{p,r,i} digs[b,p,r,i] * key[p,r,o](X)
       negacyclically, i.e. coefficient k gathers key[(k - i) mod 2N]
       over the [v, -v] extension.  Output tile k is one s8 x s8 -> s32
       dot of all nt input tiles against blocks nt-1-k .. 2nt-2-k.
    """
    B, P, R, N = digs.shape
    OLT, nd, _, _, T = key_i.shape
    nt = (nd + 1) // 2
    D = jnp.transpose(digs.reshape(B, P, R, nt, T), (0, 3, 1, 2, 4))
    D = D.reshape(B, nt * P * R * T)
    tiles = [
        jax.lax.dot_general(
            D, key_i[:, nt - 1 - k: 2 * nt - 1 - k].reshape(OLT, -1),
            (((1,), (1,)), ((), ())), preferred_element_type=jnp.int32,
        ).reshape(B, OLT // T, T)
        for k in range(nt)
    ]
    prod = jnp.stack(tiles, axis=2).reshape(B, 2, OLT // T // 2, N)
    if tp_axis is not None:
        prod = jax.lax.psum(prod, tp_axis)
    return modmath.combine_limbs_mod_q(jnp.moveaxis(prod, 2, -1), p.Q)


def _rot_diff_digits(acc, a_col, p: BinFHEParams, tp_axis=None, R_local=None):
    """Digits of both rotated differences: int8 [B, P=2, R, N].
    Part 0: (X^{-a} - 1)·acc (key s = +1); part 1: (X^{a} - 1)·acc."""
    Q, N = p.Q, p.N
    c_pos = (2 * N - a_col) & (2 * N - 1)
    parts = []
    for c in (c_pos, a_col):
        d = monomial_rotate(acc, c, N, Q) - acc
        d = jnp.where(d < 0, d + Q, d)  # (X^c - 1)*acc mod Q
        parts.append(_digits_rows(d, p))
    digs = jnp.stack(parts, axis=1)  # [B, 2, R, N]
    if tp_axis is not None:
        r0 = jax.lax.axis_index(tp_axis) * R_local
        digs = jax.lax.dynamic_slice_in_dim(digs, r0, R_local, axis=2)
    return digs


def ginx_step(acc, a_col, key_i, p: BinFHEParams, tp_axis=None):
    """One GINX CMUX step in the rotated-difference form:

        acc += K+_i ⊡ ((X^{-a_i} - 1)·acc)  +  K-_i ⊡ ((X^{a_i} - 1)·acc)

    Bit-exact vs golden.blind_rotate_ginx_rot's step (a_i = 0 lanes add
    zero, matching golden's skip)."""
    digs = _rot_diff_digits(acc, a_col, p, tp_axis, key_i.shape[3])
    prod = _key_product(digs, key_i, p, tp_axis)
    return modmath.red31(acc + prod, p.Q)


def blind_rotate_ginx_dev(
    acc: jnp.ndarray, a2N: jnp.ndarray, keys: DeviceBootKeys, tp_axis=None
) -> jnp.ndarray:
    """Scan the n CMUX steps.  a2N: int32 [B, n] in [0, 2N)."""
    p = keys.params

    def body(carry, xs):
        a_col, key_i = xs
        return ginx_step(carry, a_col, key_i, p, tp_axis), None

    acc, _ = jax.lax.scan(body, acc, (a2N.T, keys.brk))
    return acc


def ap_binary_step(acc, bit, key_i, p: BinFHEParams):
    """One binary-base AP step: acc <- bit ? acc ⊡ RGSW(X^{2^j s_i}) : acc.
    The digit bit of the public rotation amount selects per gate between
    the shared-key external product and the unchanged accumulator."""
    digs = _digits_rows(acc, p)[:, None]  # [B, P=1, R, N]
    new = _key_product(digs, key_i, p)
    return jnp.where((bit != 0)[:, None, None], new, acc)


def blind_rotate_ap_dev(
    acc: jnp.ndarray, a2N: jnp.ndarray, keys: DeviceBootKeys
) -> jnp.ndarray:
    """AP/DM blind rotation.  Binary base: n*d_r shared-key steps (the GINX
    contraction).  Generic base: per (i, digit j), per-gate key row gathered
    by digit value and applied as a batched external product."""
    p = keys.params
    Q, N, d_g, B_r, d_r = p.Q, p.N, p.d_g_used, p.B_r, p.d_r
    neg_a = (2 * N - a2N) & (2 * N - 1)  # rotate by -a_i * s_i in total
    if keys.brk is not None:
        j = jnp.arange(d_r, dtype=jnp.int32)
        bits = (neg_a[:, :, None] >> j) & 1  # [B, n, d_r]
        bits = bits.reshape(acc.shape[0], p.n * d_r).T

        def body_bin(carry, xs):
            bit, key_i = xs
            return ap_binary_step(carry, bit, key_i, p), None

        acc, _ = jax.lax.scan(body_bin, acc, (bits, keys.brk))
        return acc

    B = a2N.shape[0]
    i = jnp.arange(N, dtype=jnp.int32)
    idx2n = (i[None, :] - i[:, None]) & (2 * N - 1)

    def body(carry, xs):
        na_col, ak_i = xs  # na_col [B]; ak_i [d_r, B_r, rows, out, L, 2N]
        acc = carry
        for j in range(d_r):
            v = (na_col >> (j * int(np.log2(B_r)))) & (B_r - 1)  # [B]
            k_sel = jnp.take(ak_i[j], v, axis=0)  # [B, rows, out, L, 2N]
            digs = acc_gadget_digits_dev(acc, p)
            digs = jnp.transpose(digs, (0, 1, 3, 2)).reshape(B, 2 * d_g, N)
            dense = k_sel[..., idx2n]  # [B, rows, out, L, N, N]
            prod = jnp.einsum(
                "bri,brolik->bokl", digs, dense, preferred_element_type=jnp.int32
            )
            new = modmath.combine_limbs_mod_q(prod, Q)
            # v == 0 is the identity rotation: keep acc (golden parity)
            acc = jnp.where((v == 0)[:, None, None], acc, new)
        return acc, None

    acc, _ = jax.lax.scan(body, acc, (neg_a.T, keys.ap_kext))
    return acc


def sample_extract(acc: jnp.ndarray, Q: int) -> jnp.ndarray:
    """RLWE [B, 2, N] -> LWE [B, N+1] mod Q (coefficient 0)."""
    a = acc[:, 0]
    rest = a[:, 1:][:, ::-1]
    neg = jnp.where(rest == 0, 0, Q - rest)
    a_ext = jnp.concatenate([a[:, :1], neg], axis=1)
    return jnp.concatenate([a_ext, acc[:, 1, :1]], axis=1)


def _pad_to(x: jnp.ndarray, axis: int, mult: int) -> jnp.ndarray:
    pad = (-x.shape[axis]) % mult
    if not pad:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return jnp.pad(x, widths)


def key_switch_dev(ct_N: jnp.ndarray, keys: DeviceBootKeys, tp_axis=None) -> jnp.ndarray:
    """LWE [B, N+1] mod Q_ks -> [B, n+1] mod Q_ks via one int8 matmul.

    The key's (n+1)*2 output columns are zero-padded to a multiple of
    GEMM_ALIGN for the int8 GEMM and sliced back.  Under tensor parallelism
    keys.ksk is a shard of the contraction axis (N*d_ks) and the partial
    sums are psum-reduced over tp_axis."""
    p = keys.params
    Qks, N, n = p.Q_ks, p.N, p.n
    B = ct_N.shape[0]
    digs = signed_digits_dev(ct_N[:, :N], p.B_ks, p.d_ks)  # [B, N, d_ks]
    digs = digs.reshape(B, N * p.d_ks)
    if tp_axis is not None:
        k_local = keys.ksk.shape[0]
        k0 = jax.lax.axis_index(tp_axis) * k_local
        digs = jax.lax.dynamic_slice_in_dim(digs, k0, k_local, axis=1)
    kmat = keys.ksk.reshape(keys.ksk.shape[0], 2 * (n + 1))
    prod = jax.lax.dot_general(
        digs, _pad_to(kmat, 1, GEMM_ALIGN), (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )[:, : 2 * (n + 1)].reshape(B, n + 1, 2)
    if tp_axis is not None:
        prod = jax.lax.psum(prod, tp_axis)
    val = prod[..., 0] + (prod[..., 1] << 8)
    out = -val
    out = out.at[:, n].add(ct_N[:, N])
    return out & (Qks - 1)


def _mod_switch_pow2(x: jnp.ndarray, from_log2: int, to_log2: int) -> jnp.ndarray:
    if to_log2 >= from_log2:
        return (x << (to_log2 - from_log2)) & ((1 << to_log2) - 1)
    sh = from_log2 - to_log2
    return ((x + (1 << (sh - 1))) >> sh) & ((1 << to_log2) - 1)


def bootstrap_batch(
    prep: jnp.ndarray, gate_ids: jnp.ndarray, keys: DeviceBootKeys, tp_axis=None
) -> jnp.ndarray:
    """Bootstrap a batch of prepared LWE cts [B, n+1] mod q -> fresh cts.

    ``prep`` is the gate linear combination (golden.gate_prepare);
    ``gate_ids`` indexes GATE_ORDER and selects each gate's test vector.
    The batch is zero-padded to a multiple of GEMM_ALIGN rows (padded rows
    are bootstrapped like any other and dropped).
    """
    p = keys.params
    Q, N, q, Qks = p.Q, p.N, p.q, p.Q_ks
    B = prep.shape[0]
    prep = _pad_to(prep, 0, GEMM_ALIGN)
    gate_ids = _pad_to(gate_ids, 0, GEMM_ALIGN)
    log_q = int(np.log2(q))
    log_qks = int(np.log2(Qks))
    # q -> 2N (exact: q <= 2N, power-of-two ratio)
    ct2N = _mod_switch_pow2(prep, log_q, int(np.log2(2 * N)))
    a2N, b2N = ct2N[:, :-1], ct2N[:, -1]
    tv_sel = jnp.take(keys.tv_table, gate_ids, axis=0)  # [B, N]
    acc = _acc_init(tv_sel, b2N, N, Q)
    if keys.method == BinFHEMethod.GINX:
        acc = blind_rotate_ginx_dev(acc, a2N, keys, tp_axis)
    else:
        assert tp_axis is None, "AP method supports data parallelism only"
        acc = blind_rotate_ap_dev(acc, a2N, keys)
    ct_N = sample_extract(acc, Q)
    ct_N = ct_N.at[:, -1].set(
        jax.lax.rem(ct_N[:, -1] + Q // 8, jnp.int32(Q))
    )
    ct_ks = modmath.mod_switch_from_q27(ct_N, log_qks, Q)
    ct_n = key_switch_dev(ct_ks, keys, tp_axis)
    return _mod_switch_pow2(ct_n, log_qks, log_q)[:B]


def prepare_gates(
    ct1: jnp.ndarray, ct2: jnp.ndarray, gate_ids: jnp.ndarray, q: int
) -> jnp.ndarray:
    """Per-gate linear combination w1*c1 + w2*c2 mod q (golden.gate_prepare)."""
    w = jnp.take(jnp.asarray(PREP_WEIGHTS), gate_ids, axis=0)  # [B, 2]
    y = w[:, :1] * ct1 + w[:, 1:] * ct2  # |y| <= 4q
    return (y + 4 * q) & (q - 1)


def eval_bin_gate_batch(
    keys: DeviceBootKeys,
    gate_ids: jnp.ndarray,
    ct1: jnp.ndarray,
    ct2: jnp.ndarray,
    tp_axis=None,
) -> jnp.ndarray:
    """Batched EvalBinGate (gate.cpp:133,171 parity): one bootstrap per gate,
    all gates in the batch fused into one device program."""
    prep = prepare_gates(ct1, ct2, gate_ids, keys.params.q)
    return bootstrap_batch(prep, gate_ids, keys, tp_axis)
