"""Device-side keygen (fhe/devkeygen.py): packing parity + end-to-end gates.

Two layers of evidence:
  * the jnp packing helpers reproduce the host packers BIT-EXACTLY on the
    same key material (this pins the limb and layout logic), and
  * keys generated entirely on device produce correct encrypted gate
    results end to end (encrypt -> eval_bin_gate_batch -> decrypt), which
    validates the generation math without requiring RNG parity with golden.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from oece_tpu.fhe import boot, devkeygen, golden, lwe, modmath
from oece_tpu.fhe.params import MICRO, MICRO_A, TOY, BinFHEMethod


def test_ext_limb_planes_parity():
    rng = np.random.default_rng(4)
    Q = MICRO.Q
    polys = rng.integers(0, Q, (3, 5, 64), dtype=np.int64)
    want = boot._poly_ext_limbs(polys, Q)  # [..., L, 2N]
    got = np.asarray(devkeygen._ext_limb_planes(jnp.asarray(polys, jnp.int32), Q))
    np.testing.assert_array_equal(got, want)


def test_to_limbs_dev_parity():
    rng = np.random.default_rng(5)
    v = rng.integers(0, 2**27, (100,), dtype=np.int64)
    want = modmath.to_limbs_i8(v)
    got = np.asarray(devkeygen._to_limbs_i8_dev(jnp.asarray(v, jnp.int32)))
    np.testing.assert_array_equal(got, want)


def test_negacyclic_by_ternary():
    rng = np.random.default_rng(6)
    Q, N = MICRO.Q, 64
    A = rng.integers(0, Q, (3, N), dtype=np.int64)
    z = rng.integers(-1, 2, (N,), dtype=np.int64)
    want = np.stack([golden.negacyclic_mul(a, z % Q, Q) for a in A])
    got = np.asarray(
        devkeygen._negacyclic_by_ternary(
            jnp.asarray(A, jnp.int32), jnp.asarray(z, jnp.int32), Q
        )
    )
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("params", [MICRO, MICRO_A], ids=lambda p: p.name)
def test_device_keys_end_to_end(params):
    """Keys generated on (virtual) device evaluate all 6 gates correctly."""
    sk, z, dkeys = devkeygen.device_keygen(params, seed=7)
    rng = np.random.default_rng(8)
    B = 24
    m1 = rng.integers(0, 2, B)
    m2 = rng.integers(0, 2, B)
    gids = np.arange(B, dtype=np.int32) % 6
    c1 = jnp.asarray(lwe.encrypt_bits(sk, m1, rng))
    c2 = jnp.asarray(lwe.encrypt_bits(sk, m2, rng))
    out = np.asarray(
        boot.eval_bin_gate_batch(dkeys, jnp.asarray(gids), c1, c2)
    )
    truth = [
        lambda a, b: a & b, lambda a, b: a | b, lambda a, b: 1 - (a & b),
        lambda a, b: 1 - (a | b), lambda a, b: a ^ b, lambda a, b: 1 - (a ^ b),
    ]
    want = np.array([truth[g](int(a), int(b)) for g, a, b in zip(gids, m1, m2)])
    got = lwe.decrypt_bits(sk, out)
    np.testing.assert_array_equal(got, want)
    # chained second generation (fresh outputs feed new gates)
    out2 = np.asarray(
        boot.eval_bin_gate_batch(dkeys, jnp.asarray(gids), jnp.asarray(out), c1)
    )
    want2 = np.array([truth[g](int(a), int(b)) for g, a, b in zip(gids, want, m1)])
    np.testing.assert_array_equal(lwe.decrypt_bits(sk, out2), want2)


def test_device_keys_deterministic():
    sk1, _, dk1 = devkeygen.device_keygen(MICRO, seed=11)
    sk2, _, dk2 = devkeygen.device_keygen(MICRO, seed=11)
    np.testing.assert_array_equal(sk1.s, sk2.s)
    assert dk1.brk is not None
    np.testing.assert_array_equal(np.asarray(dk1.brk), np.asarray(dk2.brk))
    sk3, _, _ = devkeygen.device_keygen(MICRO, seed=12)
    assert not np.array_equal(sk1.s, sk3.s)


def test_device_keygen_ap_end_to_end():
    """Binary-base AP keys generated ON DEVICE evaluate all 6 gates
    correctly through the shared-key AP step."""
    import dataclasses

    p = dataclasses.replace(MICRO_A, name="MICRO_AP2", B_r=2)
    sk, z, dkeys = devkeygen.device_keygen_ap(p, seed=7)
    assert dkeys.brk is not None and dkeys.method.name == "AP"
    rng = np.random.default_rng(8)
    B = 12
    m1 = rng.integers(0, 2, B)
    m2 = rng.integers(0, 2, B)
    gids = np.arange(B, dtype=np.int32) % 6
    c1 = jnp.asarray(lwe.encrypt_bits(sk, m1, rng))
    c2 = jnp.asarray(lwe.encrypt_bits(sk, m2, rng))
    out = np.asarray(boot.eval_bin_gate_batch(dkeys, jnp.asarray(gids), c1, c2))
    truth = [
        lambda a, b: a & b, lambda a, b: a | b, lambda a, b: 1 - (a & b),
        lambda a, b: 1 - (a | b), lambda a, b: a ^ b, lambda a, b: 1 - (a ^ b),
    ]
    want = np.array([truth[g](int(a), int(b)) for g, a, b in zip(gids, m1, m2)])
    np.testing.assert_array_equal(lwe.decrypt_bits(sk, out), want)


def test_device_keygen_ap_shares_secrets_with_ginx():
    """Same seed => same LWE secret and key-switch key across methods
    (the AP and GINX keygens split the PRF identically)."""
    import dataclasses

    p = dataclasses.replace(MICRO_A, name="MICRO_AP2", B_r=2)
    sk_g, _, dk_g = devkeygen.device_keygen(p, seed=13)
    sk_a, _, dk_a = devkeygen.device_keygen_ap(p, seed=13)
    np.testing.assert_array_equal(sk_g.s, sk_a.s)
    np.testing.assert_array_equal(np.asarray(dk_g.ksk), np.asarray(dk_a.ksk))


@pytest.mark.parametrize("params", [MICRO, TOY], ids=lambda p: p.name)
def test_kept_layout_device_matches_host(params):
    """devkeygen.pack_layout (jnp, on device) == boot.toeplitz_blocks
    (NumPy) on golden GINX key material: the device keygen emits exactly
    the layout pack_bootstrap_key builds from golden keys."""
    rng = np.random.default_rng(31)
    p = params
    R = 2 * p.d_g_used
    polys = rng.integers(0, p.Q, (2, 2, R, 2, p.N), dtype=np.int64)
    kext = boot._poly_ext_limbs(polys, p.Q)  # [steps, P, R, out, L, 2N]
    want = boot.toeplitz_blocks(kext)
    got = np.asarray(devkeygen.pack_layout(jnp.asarray(kext)))
    np.testing.assert_array_equal(got, want)


def test_pack_bootstrap_key_from_golden_keys():
    """pack_bootstrap_key(golden keys) == device layout of the same rows."""
    p = MICRO
    rng = np.random.default_rng(32)
    sk = golden.lwe_keygen(p, rng)
    bk = golden.bootstrap_keygen(p, sk, rng, BinFHEMethod.GINX)
    dk = boot.pack_bootstrap_key(bk)
    polys = np.stack([bk.brk_pos, bk.brk_neg], axis=1) % p.Q
    kext = devkeygen._ext_limb_planes(jnp.asarray(polys, jnp.int32), p.Q)
    got = np.asarray(devkeygen.pack_layout(kext))
    np.testing.assert_array_equal(got, np.asarray(dk.brk))


def test_ap_binary_step_bitexact_vs_golden():
    """Binary-base AP (B_r = 2): the shared-key step + public-bit select ==
    golden.blind_rotate_ap, bit-exact, through the full gate bootstrap."""
    import dataclasses

    p = dataclasses.replace(MICRO, name="MICRO_AP2", B_r=2)
    rng = np.random.default_rng(33)
    sk = golden.lwe_keygen(p, rng)
    bk = golden.bootstrap_keygen(p, sk, rng, BinFHEMethod.AP)
    dk = boot.pack_bootstrap_key(bk)
    assert dk.brk is not None and dk.brk.shape[0] == p.n * p.d_r
    B = 12
    gids = (np.arange(B) % 6).astype(np.int32)
    c1 = lwe.encrypt_bits(sk, rng.integers(0, 2, B), rng)
    c2 = lwe.encrypt_bits(sk, rng.integers(0, 2, B), rng)
    got = np.asarray(boot.eval_bin_gate_batch(
        dk, jnp.asarray(gids), jnp.asarray(c1), jnp.asarray(c2)))
    for k in range(B):
        want = golden.eval_bin_gate(
            p, bk, boot.GATE_ORDER[gids[k]], c1[k].astype(np.int64),
            c2[k].astype(np.int64),
        )
        np.testing.assert_array_equal(got[k], want)
