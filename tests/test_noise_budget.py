"""CI statistical noise test (NOISE.md §3): the measured bootstrap output
noise at MICRO_A (approximate gadget) must sit far inside the q/8 decrypt
margin, and no failures may occur.  A regression in any crypto kernel
(decompose, matmul, combine, rotation, key/mod switch) surfaces here as a
noise blowup long before it would flip bits at production scale."""

import numpy as np

import jax.numpy as jnp

from oece_tpu.fhe import boot, golden, lwe
from oece_tpu.fhe.params import MICRO_A, BinFHEMethod


def test_bootstrap_noise_within_budget():
    p = MICRO_A
    q = p.q
    rng = np.random.default_rng(42)
    sk = golden.lwe_keygen(p, rng)
    bk = golden.bootstrap_keygen(p, sk, rng, BinFHEMethod.GINX)
    dkeys = boot.pack_bootstrap_key(bk)
    B = 256
    truth = [
        lambda a, b: a & b, lambda a, b: a | b, lambda a, b: 1 - (a & b),
        lambda a, b: 1 - (a | b), lambda a, b: a ^ b, lambda a, b: 1 - (a ^ b),
    ]
    m1 = rng.integers(0, 2, B)
    m2 = rng.integers(0, 2, B)
    gids = rng.integers(0, 6, B).astype(np.int32)
    c1 = jnp.asarray(lwe.encrypt_bits(sk, m1, rng))
    c2 = jnp.asarray(lwe.encrypt_bits(sk, m2, rng))
    out = np.asarray(boot.eval_bin_gate_batch(dkeys, jnp.asarray(gids), c1, c2))
    want = np.array([truth[g](int(a), int(b)) for g, a, b in zip(gids, m1, m2)])
    got = lwe.decrypt_bits(sk, out)
    assert np.array_equal(got, want), "bootstrap failures at MICRO_A"
    noise = lwe.decrypt_noise(sk, out, want)
    std = float(np.std(noise))
    # NOISE.md budget at MICRO_A: sigma ~ 1.3 q-units; 4.0 leaves slack for
    # sampling variance while still being ~8x under the q/8 = 32 margin.
    assert std < 4.0, f"noise sigma {std} exceeds budget"
    assert int(np.max(np.abs(noise))) < q // 8 // 2, "noise too close to margin"
