"""Device bootstrap vs golden model: bit-exact differential tests at MICRO,
plus functional self-tests at TOY.

The device pipeline (fhe/boot.py) is exact integer arithmetic end to end, so
given identical keys it must reproduce fhe/golden.py to the bit.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from oece_tpu.fhe import boot, golden as g, lwe
from oece_tpu.fhe.params import MICRO, TOY, BinFHEMethod, BinGate


@pytest.fixture(scope="module")
def micro_ginx():
    rng = np.random.default_rng(42)
    sk = g.lwe_keygen(MICRO, rng)
    bk = g.bootstrap_keygen(MICRO, sk, rng, BinFHEMethod.GINX)
    return sk, bk, boot.pack_bootstrap_key(bk)


@pytest.fixture(scope="module")
def micro_ap():
    rng = np.random.default_rng(43)
    sk = g.lwe_keygen(MICRO, rng)
    bk = g.bootstrap_keygen(MICRO, sk, rng, BinFHEMethod.AP)
    return sk, bk, boot.pack_bootstrap_key(bk)


def _all_cases(sk, rng):
    """24 cases: 6 gates x 4 input combos, fresh host encryptions."""
    gates, m1s, m2s = [], [], []
    for gate in boot.GATE_ORDER:
        for m1 in (0, 1):
            for m2 in (0, 1):
                gates.append(boot.GATE_INDEX[gate])
                m1s.append(m1)
                m2s.append(m2)
    c1 = lwe.encrypt_bits(sk, np.array(m1s), rng)
    c2 = lwe.encrypt_bits(sk, np.array(m2s), rng)
    return np.array(gates, dtype=np.int32), np.array(m1s), np.array(m2s), c1, c2


@pytest.mark.parametrize("fix", ["micro_ginx", "micro_ap"])
def test_device_matches_golden_bitwise(fix, request):
    sk, bk, dkeys = request.getfixturevalue(fix)
    rng = np.random.default_rng(7)
    gate_ids, m1s, m2s, c1, c2 = _all_cases(sk, rng)
    out_dev = np.asarray(
        boot.eval_bin_gate_batch(dkeys, jnp.asarray(gate_ids), jnp.asarray(c1), jnp.asarray(c2))
    ).astype(np.int64)
    for k in range(len(gate_ids)):
        gate = boot.GATE_ORDER[gate_ids[k]]
        ref = g.eval_bin_gate(
            MICRO, bk, gate, c1[k].astype(np.int64), c2[k].astype(np.int64),
            form="rot",
        )
        assert np.array_equal(out_dev[k], ref), (gate, m1s[k], m2s[k])
    # and they decrypt to the truth table
    got = lwe.decrypt_bits(sk, out_dev)
    truth = {
        BinGate.AND: lambda x, y: x & y,
        BinGate.OR: lambda x, y: x | y,
        BinGate.NAND: lambda x, y: 1 - (x & y),
        BinGate.NOR: lambda x, y: 1 - (x | y),
        BinGate.XOR: lambda x, y: x ^ y,
        BinGate.XNOR: lambda x, y: 1 - (x ^ y),
    }
    for k in range(len(gate_ids)):
        assert got[k] == truth[boot.GATE_ORDER[gate_ids[k]]](m1s[k], m2s[k])


def test_device_composability_toy():
    """TOY-scale device-only: chain gates, decrypt, check logic + noise."""
    rng = np.random.default_rng(3)
    sk = g.lwe_keygen(TOY, rng)
    bk = g.bootstrap_keygen(TOY, sk, rng, BinFHEMethod.GINX)
    dkeys = boot.pack_bootstrap_key(bk)
    B = 16
    m1 = rng.integers(0, 2, B)
    m2 = rng.integers(0, 2, B)
    c1 = jnp.asarray(lwe.encrypt_bits(sk, m1, rng))
    c2 = jnp.asarray(lwe.encrypt_bits(sk, m2, rng))
    gid = jnp.full((B,), boot.GATE_INDEX[BinGate.XOR], dtype=jnp.int32)
    x = boot.eval_bin_gate_batch(dkeys, gid, c1, c2)  # m1 ^ m2
    gid2 = jnp.full((B,), boot.GATE_INDEX[BinGate.AND], dtype=jnp.int32)
    y = boot.eval_bin_gate_batch(dkeys, gid2, x, c1)  # (m1^m2) & m1
    got = lwe.decrypt_bits(sk, np.asarray(y))
    want = (m1 ^ m2) & m1
    assert np.array_equal(got, want)
    noise = lwe.decrypt_noise(sk, np.asarray(y), want)
    # fresh bootstrap outputs should sit far inside the q/8 = 64 margin
    assert np.max(np.abs(noise)) < TOY.q // 16, noise


def test_eval_not_batch():
    rng = np.random.default_rng(4)
    sk = g.lwe_keygen(TOY, rng)
    m = rng.integers(0, 2, 32)
    c = lwe.encrypt_bits(sk, m, rng)
    nc = np.asarray(lwe.eval_not_batch(c, TOY.q))
    assert np.array_equal(lwe.decrypt_bits(sk, nc), 1 - m)


@pytest.mark.parametrize("n", [16, 17, 21], ids=lambda n: f"n{n}")
def test_key_switch_padded_width_matches_golden(n):
    """key_switch_dev pads the key's (n+1)*2 output columns to a multiple of
    GEMM_ALIGN (34, 36 and 44 -> 36, 36, 44 here) and slices back: the
    result equals golden.key_switch for every width."""
    import dataclasses

    p = dataclasses.replace(MICRO, name=f"MICRO_n{n}", n=n)
    rng = np.random.default_rng(60 + n)
    sk = g.lwe_keygen(p, rng)
    z = g.ternary(rng, (p.N,))
    ksk = g.keyswitch_keygen(p, z, sk, rng)
    dk = boot.DeviceBootKeys(
        params=p, method=BinFHEMethod.GINX, brk=None, ap_kext=None,
        ksk=boot.pack_ksk(p, ksk), tv_table=None,
    )
    Qks = p.Q_ks
    B = 5
    ct = rng.integers(0, Qks, (B, p.N + 1)).astype(np.int32)
    got = np.asarray(boot.key_switch_dev(jnp.asarray(ct), dk))
    assert got.shape == (B, n + 1)
    for b in range(B):
        np.testing.assert_array_equal(got[b], g.key_switch(p, ksk, ct[b]))


@pytest.mark.parametrize("B", [1, 3, 5, 6])
def test_odd_batch_padding_matches_unpadded_rows(micro_ginx, B):
    """bootstrap_batch zero-pads B to a multiple of GEMM_ALIGN and drops the
    padded rows: each row equals the same row of an aligned batch of 8."""
    sk, bk, dkeys = micro_ginx
    rng = np.random.default_rng(70)
    gids = (np.arange(8) % 6).astype(np.int32)
    c1 = jnp.asarray(lwe.encrypt_bits(sk, rng.integers(0, 2, 8), rng))
    c2 = jnp.asarray(lwe.encrypt_bits(sk, rng.integers(0, 2, 8), rng))
    full = np.asarray(boot.eval_bin_gate_batch(dkeys, jnp.asarray(gids), c1, c2))
    part = np.asarray(
        boot.eval_bin_gate_batch(dkeys, jnp.asarray(gids[:B]), c1[:B], c2[:B])
    )
    assert part.shape == (B, MICRO.n + 1)
    np.testing.assert_array_equal(part, full[:B])


def test_monomial_rotate_matches_golden():
    """The per-lane gather rotation == golden.negacyclic_monomial_mul for
    every amount in [0, 2N) (both signs of the wrap)."""
    p = MICRO
    rng = np.random.default_rng(71)
    c = np.arange(2 * p.N, dtype=np.int32)
    P = rng.integers(0, p.Q, (c.size, p.N)).astype(np.int64)
    got = np.asarray(boot.monomial_rotate(
        jnp.asarray(P.astype(np.int32)), jnp.asarray(c), p.N, p.Q))
    for k in range(c.size):
        np.testing.assert_array_equal(
            got[k], g.negacyclic_monomial_mul(P[k], int(c[k]), p.N, p.Q))
