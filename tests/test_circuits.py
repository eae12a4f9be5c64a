"""Circuits layer: Bristol/.out parsing, levelization, asm round trips."""

import numpy as np
import pytest

from oece_tpu.circuits.asm import emit_asm, parse_asm
from oece_tpu.circuits.bristol import parse_bristol
from oece_tpu.circuits.netlist import Netlist, Op, levelize
from oece_tpu.runtime.evaluator import Circuit

from oece_tpu.harness.tb import R as REF


def bits(v, n):
    v = np.atleast_1d(np.asarray(v, dtype=np.uint64))
    return ((v[:, None] >> np.arange(n, dtype=np.uint64)) & np.uint64(1)).astype(np.int64)


def unbits(b):
    b = np.asarray(b).astype(np.uint64)
    return (b << np.arange(b.shape[1], dtype=np.uint64)).sum(1)


def _plain_eval(nl, inputs):
    c = Circuit(set="TOY", generate_keys=False)
    c.LoadNetlist(nl)
    c.setPlaintext(True)
    c.setEncrypted(False)
    c.SetInput(inputs)
    c.Clock()
    return c.GetOutput()


@pytest.mark.parametrize(
    "path,fmt", [("old_bristol_ckts/arith/adder_32bit.txt", 32), ("new_bristol_ckts/arith/adder64.txt", 64)]
)
def test_bristol_adders_plaintext(path, fmt):
    nl = parse_bristol(f"{REF}/{path}")
    nl.validate()
    rng = np.random.default_rng(1)
    T = 16
    a = rng.integers(0, 2 ** (fmt - 1), T, dtype=np.uint64)
    b = rng.integers(0, 2 ** (fmt - 1), T, dtype=np.uint64)
    out = _plain_eval(nl, [bits(a, fmt), bits(b, fmt)])[0]
    assert np.array_equal(unbits(out) & ((1 << fmt) - 1 if fmt == 64 else (1 << 33) - 1), (a + b) & np.uint64((1 << fmt) - 1) if fmt == 64 else a + b)


def test_bristol_comparator_plaintext():
    nl = parse_bristol(f"{REF}/old_bristol_ckts/arith/comparator_32bit_unsigned_lt.txt")
    nl.validate()
    rng = np.random.default_rng(2)
    T = 32
    a = rng.integers(0, 2**32, T, dtype=np.uint64)
    b = rng.integers(0, 2**32, T, dtype=np.uint64)
    out = _plain_eval(nl, [bits(a, 32), bits(b, 32)])[0]
    # reference semantics: output is "in2 cmp in1" (test_comparator.cpp)
    got = out[:, 0].astype(bool)
    assert np.array_equal(got, b < a) or np.array_equal(got, a < b)


def test_mult32_plaintext():
    nl = parse_bristol(f"{REF}/old_bristol_ckts/arith/mult_32x32.txt")
    nl.validate()
    rng = np.random.default_rng(3)
    T = 4
    a = rng.integers(0, 2**32, T, dtype=np.uint64)
    b = rng.integers(0, 2**32, T, dtype=np.uint64)
    out = _plain_eval(nl, [bits(a, 32), bits(b, 32)])[0]
    assert np.array_equal(unbits(out), a * b)


def test_asm_parse_and_roundtrip():
    nl = parse_asm(f"{REF}/simple_ckts/adder_2bit/adder_2bit.out")
    nl.validate()
    assert nl.input_bits == [2, 2] and nl.output_bits == [3]
    cases = [(x, y) for x in range(4) for y in range(4)]
    xa = bits(np.array([x for x, _ in cases]), 2)
    xb = bits(np.array([y for _, y in cases]), 2)
    want = np.array([x + y for x, y in cases], dtype=np.uint64)
    out = _plain_eval(nl, [xa, xb])[0]
    assert np.array_equal(unbits(out), want)
    for reuse in (False, True):
        nl2 = parse_asm(emit_asm(nl, reuse_registers=reuse), name="rt")
        nl2.validate()
        out2 = _plain_eval(nl2, [xa, xb])[0]
        assert np.array_equal(unbits(out2), want)


def test_register_reuse_allocator_is_smaller():
    nl = parse_bristol(f"{REF}/old_bristol_ckts/arith/adder_32bit.txt")
    import re

    def nregs(txt):
        return max(int(m) for m in re.findall(r"R(\d+)", txt)) + 1

    plain = emit_asm(nl, reuse_registers=False)
    reuse = emit_asm(nl, reuse_registers=True)
    assert nregs(reuse) < nregs(plain) // 2


def test_parity_circuit_semantics():
    """parity.out: Out0 = even indicator, Out1 = odd (reference comments)."""
    nl = parse_asm(f"{REF}/simple_ckts/parity/parity.out")
    rng = np.random.default_rng(4)
    v = rng.integers(0, 256, 16, dtype=np.uint64)
    inp = np.concatenate([bits(v, 8), np.zeros((16, 1), dtype=np.int64)], axis=1)
    out = _plain_eval(nl, [inp])[0]
    par = np.array([bin(int(x)).count("1") & 1 for x in v])
    assert np.array_equal(out[:, 0], 1 - par)
    assert np.array_equal(out[:, 1], par)


def test_levelizer_stats_sha256():
    nl = parse_bristol(f"{REF}/new_bristol_ckts/crypto/sha256.txt")
    plan = levelize(nl)
    s = plan.stats()
    # the in-repo new-Bristol file's own ASAP schedule
    assert s["depth"] == 3919
    assert s["bootstrap_gates"] == 124920
    assert s["max_level_width"] == 1056


def test_levelizer_not_chains_free():
    """NOT gates must not advance levels (they are linear under FHEW)."""
    # x -> NOT -> NOT -> AND(x)
    nl = Netlist(
        name="t",
        n_wires=5,
        inputs=[np.array([0, 1], dtype=np.int32)],
        outputs=[np.array([4], dtype=np.int32)],
        op=np.array([int(Op.NOT), int(Op.NOT), int(Op.AND)], dtype=np.int32),
        in0=np.array([0, 2, 3], dtype=np.int32),
        in1=np.array([0, 2, 1], dtype=np.int32),
        out=np.array([2, 3, 4], dtype=np.int32),
    )
    plan = levelize(nl)
    assert plan.depth == 2  # NOTs in level 0, AND in level 1
    out = _plain_eval(nl, [np.array([[1, 1], [0, 1], [1, 0]])])[0]
    assert np.array_equal(out[:, 0], np.array([1, 0, 0]))  # NOT(NOT(x)) & y == x & y
