"""Approximate gadget decomposition (params.d_g_eff): golden correctness and
golden<->device bitwise equivalence at MICRO_A scale."""

import numpy as np
import pytest

from oece_tpu.fhe import golden
from oece_tpu.fhe.params import MICRO_A, BinFHEMethod, BinGate


def test_approx_digits_reconstruct():
    p = MICRO_A
    Q, B, d, s = p.Q, p.B_g, p.d_g_eff, p.g_shift
    rng = np.random.default_rng(0)
    v = np.concatenate(
        [rng.integers(0, Q, 4096), np.array([0, 1, Q - 1, Q // 2, (Q + 1) // 2])]
    )
    digs = golden.gadget_digits_approx(v, Q, B, d, s)
    assert digs.min() >= -B // 2 and digs.max() <= B // 2
    recon = sum(digs[..., j] * (B**j << s) for j in range(d))
    c = np.where(v >= (Q + 1) // 2, v - Q, v)
    err = c - recon
    assert np.all(np.abs(err) <= 1 << (s - 1))


def test_approx_digits_device_matches_golden():
    import jax.numpy as jnp

    from oece_tpu.fhe import boot

    p = MICRO_A
    rng = np.random.default_rng(1)
    v = rng.integers(0, p.Q, (64, 2, p.N)).astype(np.int64)
    want = golden.gadget_digits_approx(v, p.Q, p.B_g, p.d_g_eff, p.g_shift)
    got = np.asarray(
        boot.gadget_digits_approx_dev(
            jnp.asarray(v.astype(np.int32)), p.Q, p.B_g, p.d_g_eff, p.g_shift
        )
    )
    assert np.array_equal(got, want.astype(np.int8))


def test_external_product_approx_error_bound():
    """EP with the approximate gadget = message product + bounded error."""
    p = MICRO_A
    rng = np.random.default_rng(2)
    z = golden.ternary(rng, (p.N,))
    msg = np.zeros(p.N, dtype=np.int64)
    msg[3] = 1  # X^3 monomial
    rgsw = golden.rgsw_encrypt(p, z, msg, rng)
    assert rgsw.shape == (2 * p.d_g_eff, 2, p.N)
    pt = rng.integers(0, p.Q, (p.N,))
    ct = golden.rlwe_encrypt(p, z, pt, rng)
    out = golden.external_product(p, ct, rgsw)
    # decrypt: b - a*z = msg*pt + noise
    phase = (out[1] - golden.negacyclic_mul(out[0], z, p.Q)) % p.Q
    want = golden.negacyclic_mul(pt, msg, p.Q)
    diff = (phase - want) % p.Q
    diff = np.where(diff > p.Q // 2, diff - p.Q, diff)
    # error: mu*(z*r_a - r_b) + key noise.  r_* uniform +-2^{s-1}; the a-side
    # term is amplified by the ring secret z (std ~ sqrt(2N/3)); bound at
    # ~5 sigma of that plus slack.
    bound = (1 << (p.g_shift - 1)) * (1 + 5 * np.sqrt(2 * p.N / 3) / np.sqrt(3))
    assert np.max(np.abs(diff)) < bound


@pytest.mark.parametrize("gate", [BinGate.AND, BinGate.OR, BinGate.XOR])
def test_micro_a_gate_bootstrap_golden(gate):
    p = MICRO_A
    rng = np.random.default_rng(3)
    sk = golden.lwe_keygen(p, rng)
    bk = golden.bootstrap_keygen(p, sk, rng, BinFHEMethod.GINX)
    truth = {
        BinGate.AND: lambda a, b: a & b,
        BinGate.OR: lambda a, b: a | b,
        BinGate.XOR: lambda a, b: a ^ b,
    }[gate]
    for m1 in (0, 1):
        for m2 in (0, 1):
            c1 = golden.lwe_encrypt(sk, m1, rng)
            c2 = golden.lwe_encrypt(sk, m2, rng)
            out = golden.eval_bin_gate(p, bk, gate, c1, c2)
            assert golden.lwe_decrypt(sk, out) == truth(m1, m2)


def test_micro_a_device_jnp_matches_golden():
    """Full batched device bootstrap == golden (rotated-difference form),
    bit-exact, with the approximate gadget."""
    import jax.numpy as jnp

    from oece_tpu.fhe import boot, lwe

    p = MICRO_A
    rng = np.random.default_rng(4)
    sk = golden.lwe_keygen(p, rng)
    bk = golden.bootstrap_keygen(p, sk, rng, BinFHEMethod.GINX)
    dkeys = boot.pack_bootstrap_key(bk)
    B = 16
    bits1 = rng.integers(0, 2, B)
    bits2 = rng.integers(0, 2, B)
    c1 = lwe.encrypt_bits(sk, bits1, rng)
    c2 = lwe.encrypt_bits(sk, bits2, rng)
    gids = rng.integers(0, len(boot.GATE_ORDER), B).astype(np.int32)
    got = np.asarray(
        boot.eval_bin_gate_batch(
            dkeys, jnp.asarray(gids), jnp.asarray(c1), jnp.asarray(c2)
        )
    )
    for b in range(B):
        gate = boot.GATE_ORDER[int(gids[b])]
        want = golden.eval_bin_gate(p, bk, gate, c1[b], c2[b], form="rot")
        assert np.array_equal(got[b] % p.q, want % p.q), (b, gate)
