"""The rotated-difference GINX step (the device blind-rotation step).

Three layers of evidence:
  * golden.blind_rotate_ginx_rot produces correct gate results (the form
    itself is sound crypto — it is the original CGGI CMUX);
  * boot.ginx_step is BIT-EXACT vs the golden rot-form step given the same
    RGSW key material (MICRO exact gadget, MICRO_A approximate, TOY with
    several output tiles);
  * device_keygen keys evaluate all six gates correctly end to end through
    eval_bin_gate_batch.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from oece_tpu.fhe import boot, devkeygen, golden, lwe
from oece_tpu.fhe.params import MICRO, MICRO_A, TOY, BinFHEMethod

TRUTH = [
    lambda a, b: a & b, lambda a, b: a | b, lambda a, b: 1 - (a & b),
    lambda a, b: 1 - (a | b), lambda a, b: a ^ b, lambda a, b: 1 - (a ^ b),
]


def _golden_rot_step(p, acc, ai, brk_pos_i, brk_neg_i):
    """One step of golden.blind_rotate_ginx_rot (works for ai == 0 too)."""
    N, Q = p.N, p.Q
    if ai % (2 * N) == 0:
        return acc % Q
    d_pos = (golden.negacyclic_monomial_mul(acc, 2 * N - ai, N, Q) - acc) % Q
    d_neg = (golden.negacyclic_monomial_mul(acc, ai, N, Q) - acc) % Q
    p_pos = golden.external_product(p, d_pos, brk_pos_i)
    p_neg = golden.external_product(p, d_neg, brk_neg_i)
    return (acc + p_pos + p_neg) % Q


def _key_from_brk(p, brk_pos_i, brk_neg_i):
    """One step of DeviceBootKeys.brk from golden key rows."""
    brk = np.stack([brk_pos_i, brk_neg_i])[None]  # [1, part, rows, out, N]
    kext = boot._poly_ext_limbs(brk, p.Q)
    return jnp.asarray(boot.toeplitz_blocks(kext)[0])


@pytest.mark.parametrize("params", [MICRO, MICRO_A, TOY], ids=lambda p: p.name)
def test_rot_step_bitexact_vs_golden(params):
    p = params
    rng = np.random.default_rng(51)
    Q, N = p.Q, p.N
    R = 2 * p.d_g_used
    # synthetic RGSW-shaped material: the two paths must agree on ANY keys
    brk = rng.integers(0, Q, (2, 2, R, 2, N), dtype=np.int64)  # [step, part,..]
    B = 8
    acc0 = rng.integers(0, Q, (B, 2, N)).astype(np.int64)
    scale = 2 * N // p.q  # valid a_col values after the q->2N mod switch
    a_col = (scale * rng.integers(0, p.q, (B,))).astype(np.int32)
    a_col[0] = 0  # identity-step lane must match the golden `continue`
    acc = acc0.copy()
    acc_dev = jnp.asarray(acc0.astype(np.int32))
    for step in range(2):
        key = _key_from_brk(p, brk[step, 0], brk[step, 1])
        want = np.stack([
            _golden_rot_step(p, acc[b_], int(a_col[b_]), brk[step, 0], brk[step, 1])
            for b_ in range(B)
        ])
        got_dev = boot.ginx_step(
            acc_dev, jnp.asarray(a_col), key, p
        )
        np.testing.assert_array_equal(np.asarray(got_dev), want)
        acc = want
        acc_dev = got_dev


def test_golden_rot_form_gates_correct():
    """The rotated-difference form is a correct bootstrap (all gates, all
    input combinations, MICRO)."""
    p = MICRO
    rng = np.random.default_rng(52)
    sk = golden.lwe_keygen(p, rng)
    bk = golden.bootstrap_keygen(p, sk, rng, BinFHEMethod.GINX)
    for gi, gate in enumerate(boot.GATE_ORDER):
        for m1 in (0, 1):
            for m2 in (0, 1):
                c1 = golden.lwe_encrypt(sk, m1, rng)
                c2 = golden.lwe_encrypt(sk, m2, rng)
                prep = golden.gate_prepare(gate, c1, c2, p.q)
                out = golden.bootstrap(p, bk, prep, gate, form="rot")
                assert golden.lwe_decrypt(sk, out) == TRUTH[gi](m1, m2), (
                    gate, m1, m2,
                )


@pytest.mark.parametrize("params", [MICRO, MICRO_A], ids=lambda p: p.name)
def test_device_keys_rev2_end_to_end(params):
    """device_keygen -> eval_bin_gate_batch: correct gates."""
    sk, z, dkeys = devkeygen.device_keygen(params, seed=7)
    assert dkeys.brk is not None and dkeys.brk.shape[0] == params.n
    rng = np.random.default_rng(8)
    B = 24
    m1 = rng.integers(0, 2, B)
    m2 = rng.integers(0, 2, B)
    gids = np.arange(B, dtype=np.int32) % 6
    c1 = jnp.asarray(lwe.encrypt_bits(sk, m1, rng))
    c2 = jnp.asarray(lwe.encrypt_bits(sk, m2, rng))
    out = np.asarray(boot.eval_bin_gate_batch(dkeys, jnp.asarray(gids), c1, c2))
    want = np.array([TRUTH[g](int(a), int(b)) for g, a, b in zip(gids, m1, m2)])
    np.testing.assert_array_equal(lwe.decrypt_bits(sk, out), want)
    # chained second generation
    out2 = np.asarray(
        boot.eval_bin_gate_batch(dkeys, jnp.asarray(gids), jnp.asarray(out), c1)
    )
    want2 = np.array([TRUTH[g](int(a), int(b)) for g, a, b in zip(gids, want, m1)])
    np.testing.assert_array_equal(lwe.decrypt_bits(sk, out2), want2)
