"""End-to-end encrypted circuit evaluation at MICRO parameters.

Mirrors the reference harness flow (test_*.cpp): plaintext pass, then
encrypted pass with verify, comparing outputs to the golden model —
src/test_sha256.cpp:284-341 pattern, on the 2-bit adder circuit.
"""

import numpy as np
import pytest

from oece_tpu.circuits.asm import parse_asm
from oece_tpu.harness.tb import R
from oece_tpu.runtime.evaluator import Circuit

ADDER = f"{R}/simple_ckts/adder_2bit/adder_2bit.out"


def bits(v, n):
    v = np.atleast_1d(np.asarray(v, dtype=np.uint64))
    return ((v[:, None] >> np.arange(n, dtype=np.uint64)) & np.uint64(1)).astype(np.int64)


def unbits(b):
    b = np.asarray(b).astype(np.uint64)
    return (b << np.arange(b.shape[1], dtype=np.uint64)).sum(1)


@pytest.mark.parametrize("xor_mode", ["native", "compound"])
def test_adder2bit_encrypted_micro(xor_mode):
    c = Circuit(set="MICRO", method="GINX", seed=11, xor_mode=xor_mode)
    c.LoadNetlist(parse_asm(ADDER))
    cases = [(x, y) for x in range(4) for y in range(4)]
    xa = bits(np.array([x for x, _ in cases]), 2)
    xb = bits(np.array([y for _, y in cases]), 2)
    want = np.array([x + y for x, y in cases], dtype=np.uint64)

    # plaintext pass (test_sha256.cpp:284-289 pattern)
    c.setPlaintext(True)
    c.setEncrypted(False)
    c.setVerify(False)
    c.SetInput([xa, xb])
    c.Clock()
    assert np.array_equal(unbits(c.GetOutput()[0]), want)

    # encrypted pass with verify (test_sha256.cpp:322-326 pattern)
    c.Reset()
    c.setPlaintext(False)
    c.setEncrypted(True)
    c.setVerify(True)  # forces plaintext back on
    assert c.plaintext_flag and c.encrypted_flag
    c.SetInput([xa, xb])
    c.Clock()
    assert np.array_equal(unbits(c.GetOutput()[0]), want)
    # expected bootstrap counts: adder_2bit has 3 XOR, 3 AND, 1 OR
    assert c.gate_counts["AND"] >= 3 * 16


def test_encrypted_only_mode():
    c = Circuit(set="MICRO", method="GINX", seed=12)
    c.LoadNetlist(parse_asm(ADDER))
    c.setPlaintext(False)
    c.setEncrypted(True)
    c.setVerify(False)
    xa = bits(np.array([1, 3]), 2)
    xb = bits(np.array([2, 3]), 2)
    c.SetInput([xa, xb])
    c.Clock()
    assert np.array_equal(unbits(c.GetOutput()[0]), np.array([3, 6], dtype=np.uint64))


def test_reset_required_after_clock():
    c = Circuit(set="MICRO", generate_keys=False)
    c.LoadNetlist(parse_asm(ADDER))
    c.setPlaintext(True)
    c.setEncrypted(False)
    c.SetInput([bits(np.array([1]), 2), bits(np.array([1]), 2)])
    c.Clock()
    with pytest.raises(RuntimeError):
        c.Clock()  # circuit.cpp:538-541 parity
    c.Reset()
    c.SetInput([bits(np.array([1]), 2), bits(np.array([1]), 2)])
    c.Clock()
    assert unbits(c.GetOutput()[0])[0] == 2


def test_level_jit_matches_eager(monkeypatch):
    """The fused per-level jit path (OECE_LEVEL_JIT=1; the accelerator
    engine: one donated-arena device program per level chunk with padded
    index buckets) produces the same decrypted outputs and zero bad gates
    as the eager per-level glue, given identical keys."""
    rng_in = np.random.default_rng(9)
    in1 = rng_in.integers(0, 2, (3, 2))
    in2 = rng_in.integers(0, 2, (3, 2))

    def run(level_jit):
        monkeypatch.setenv("OECE_LEVEL_JIT", "1" if level_jit else "0")
        c = Circuit(set="MICRO", method="GINX", seed=17)
        c.LoadNetlist(parse_asm(ADDER))
        c.setVerify(True)
        c.SetInput([in1, in2])
        c.Clock()
        assert c.bad_gate_counts == {}, c.bad_gate_counts
        return c.GetOutput()[0]

    a = run(False)
    b = run(True)
    assert np.array_equal(a, b), (a, b)


def test_level_jit_padding_uses_dummy_slot(monkeypatch):
    """Padded lanes must not corrupt real wires: a circuit whose level width
    is far from the pow2 bucket still evaluates correctly under the fused
    path, and verify reports no (masked-out) phantom bad gates."""
    monkeypatch.setenv("OECE_LEVEL_JIT", "1")
    c = Circuit(set="MICRO", method="GINX", seed=23)
    c.LoadNetlist(parse_asm(ADDER))
    c.setVerify(True)
    in1 = np.array([[1, 0]])
    in2 = np.array([[1, 1]])
    c.SetInput([in1, in2])
    c.Clock()
    (out,) = c.GetOutput()
    assert (out @ (1 << np.arange(out.shape[1])))[0] == 1 + 3
    assert c.bad_gate_counts == {}, c.bad_gate_counts


@pytest.mark.parametrize("level_jit", [False, True])
def test_verify_repair_localized_by_level(monkeypatch, level_jit):
    """An induced bootstrap failure is repaired AND localized: corrupting
    one input ciphertext (bit flip via +q/2 on b) makes the first bootstrap
    level consuming it disagree with the plaintext model; verify repairs it
    and bad_gate_levels records exactly which level (round-5 localization —
    the r4 AES run's repairs could not be placed)."""
    import jax.numpy as jnp

    monkeypatch.setenv("OECE_LEVEL_JIT", "1" if level_jit else "0")
    c = Circuit(set="MICRO", method="GINX", seed=31)
    c.LoadNetlist(parse_asm(ADDER))
    c.setVerify(True)
    in1 = np.array([[1, 0]])
    in2 = np.array([[1, 1]])
    c.SetInput([in1, in2])
    w = int(c.netlist.inputs[0][0])
    slot = int(c._slot[w])
    c._ct_arena = c._ct_arena.at[slot, 0, -1].add(c.params.q // 2)
    c.Clock()
    (out,) = c.GetOutput()
    # outputs repaired to the plaintext-correct sum
    assert (out @ (1 << np.arange(out.shape[1])))[0] == 1 + 3
    assert c.bad_gate_counts, "corruption must surface as repaired gates"
    assert c.bad_gate_levels, "repairs must be localized"
    # the corrupted wire's first consumers sit in the earliest levels: every
    # recorded repair level must contain a gate reading the corrupted wire
    bad_lvls = set(c.bad_gate_levels)
    reading = {
        lv
        for lv, level in enumerate(c.plan.levels)
        if w in level["boot_in0"] or w in level["boot_in1"]
    }
    assert bad_lvls <= reading, (bad_lvls, reading)
    total_by_level = sum(
        sum(d.values()) for d in c.bad_gate_levels.values()
    )
    assert total_by_level == sum(c.bad_gate_counts.values())


@pytest.mark.parametrize("level_jit", [False, True])
def test_verify_repair_localized_by_lane(monkeypatch, level_jit):
    """OECE_BAD_TRACE=1 places each verify repair at an exact
    (level, lane, case, op, wire) — gate resolution, not just level counts
    (the instrumentation the NOISE.md §3 AES-anomaly hunt needs).  The
    induced corruption sits in case 1 of 2, so the recorded lanes must all
    carry case==1, and each lane must map to a gate reading the corrupted
    wire."""
    monkeypatch.setenv("OECE_LEVEL_JIT", "1" if level_jit else "0")
    monkeypatch.setenv("OECE_BAD_TRACE", "1")
    c = Circuit(set="MICRO", method="GINX", seed=31)
    c.LoadNetlist(parse_asm(ADDER))
    c.setVerify(True)
    in1 = np.array([[1, 0], [0, 1]])
    in2 = np.array([[1, 1], [1, 0]])
    c.SetInput([in1, in2])
    w = int(c.netlist.inputs[0][0])
    slot = int(c._slot[w])
    c._ct_arena = c._ct_arena.at[slot, 1, -1].add(c.params.q // 2)
    c.Clock()
    (out,) = c.GetOutput()
    assert list(unbits(out)) == [1 + 3, 2 + 1]
    assert c.bad_gate_lanes, "lane trace must record the induced repairs"
    n_lanes = len(c.bad_gate_lanes)
    assert n_lanes == sum(c.bad_gate_counts.values()), (
        c.bad_gate_lanes, c.bad_gate_counts,
    )
    for rec in c.bad_gate_lanes:
        assert rec["case"] == 1, rec  # only case 1 was corrupted
        level = c.plan.levels[rec["level"]]
        assert rec["wire"] == int(level["boot_out"][rec["lane"]])
        # the repaired gate reads the corrupted wire (first consumers)
        ins = (int(level["boot_in0"][rec["lane"]]),
               int(level["boot_in1"][rec["lane"]]))
        assert w in ins, (rec, ins)
