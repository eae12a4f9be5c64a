"""Empirically pin the bit/operand conventions of the new-Bristol circuits (aes_*, mult2_64, udivide64, FP-add) by evaluating
the real files in plaintext mode against golden models under all
candidate conventions.  One batched run per circuit."""
import os
import sys
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from oece_tpu.circuits.bristol import parse_bristol
from oece_tpu.runtime.evaluator import Circuit
from oece_tpu.harness import models

REF = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "examples", "new_bristol_ckts",
)

def hl(x: bytes) -> np.ndarray:
    return models.hex_to_bits_lsb(x.hex())

CONVS = {
    "A:byteLSB": lambda x: hl(x),
    "B:byteLSBrev": lambda x: hl(x)[::-1],
    "C:valueLE": lambda x: hl(x[::-1]),
    "D:msbfirst": lambda x: hl(x[::-1])[::-1],
}

def run_plain(path, in_words):
    c = Circuit(set="MICRO", method="GINX", generate_keys=False)
    c.ReadFile(path)
    c.Reset(); c.setPlaintext(True); c.setEncrypted(False); c.setVerify(False)
    c.SetInput(in_words)
    c.Clock()
    return c.GetOutput()

def probe_aes():
    path = os.path.join(REF, "crypto", "aes_128.txt")
    key = bytes.fromhex("000102030405060708090a0b0c0d0e0f")
    pt = bytes.fromhex("00112233445566778899aabbccddeeff")
    ct = models.aes_encrypt(pt, key)
    combos = []
    in1, in2 = [], []
    for kc, kf in CONVS.items():
        for pc, pf in CONVS.items():
            for swap in (False, True):
                a, b = kf(key), pf(pt)
                if swap:
                    a, b = pf(pt), kf(key)
                in1.append(a); in2.append(b)
                combos.append((kc, pc, swap))
    outs = run_plain(path, [np.stack(in1), np.stack(in2)])[0]
    outs = np.asarray(outs)
    for i, (kc, pc, swap) in enumerate(combos):
        for oc, of in CONVS.items():
            if np.array_equal(outs[i], of(ct)):
                print(f"AES128 MATCH key={kc} pt={pc} swap={swap} out={oc}")

def probe_mult2():
    path = os.path.join(REF, "arith", "mult2_64.txt")
    a, b = 0x0123456789ABCDEF, 0xFEDCBA9876543210
    prod = a * b
    lo, hi = prod & ((1 << 64) - 1), prod >> 64
    def w64(v):
        return ((np.uint64(v) >> np.arange(64, dtype=np.uint64)) & np.uint64(1)).astype(np.int64)
    in1 = np.stack([w64(a), w64(b)])
    in2 = np.stack([w64(b), w64(a)])
    outs = run_plain(path, [in1, in2])
    print("mult2_64 outputs:", len(outs), [o.shape for o in outs])
    for i in range(2):
        o0, o1 = np.asarray(outs[0][i]), np.asarray(outs[1][i])
        got0 = int(sum(int(x) << j for j, x in enumerate(o0)))
        got1 = int(sum(int(x) << j for j, x in enumerate(o1)))
        print(f"  case{i}: out0={got0:#x} out1={got1:#x} want lo={lo:#x} hi={hi:#x}",
              "LO,HI" if (got0, got1) == (lo, hi) else
              "HI,LO" if (got0, got1) == (hi, lo) else
              "LO,LO?" if got0 == lo else "???")

def probe_udiv():
    path = os.path.join(REF, "arith", "udivide64.txt")
    cases = [(100, 7), (0xFFFFFFFFFFFFFFFF, 1), (5, 0), (0, 0), (123456789, 3)]
    def w64(v):
        return ((np.uint64(v) >> np.arange(64, dtype=np.uint64)) & np.uint64(1)).astype(np.int64)
    in1 = np.stack([w64(a) for a, b in cases])
    in2 = np.stack([w64(b) for a, b in cases])
    outs = run_plain(path, [in1, in2])[0]
    for i, (a, b) in enumerate(cases):
        got = int(sum(int(x) << j for j, x in enumerate(np.asarray(outs[i]))))
        want = a // b if b else None
        print(f"  udiv {a}/{b}: got={got:#x} ({got}) python_div={want}")

def probe_fpadd():
    import struct
    path = os.path.join(REF, "fp", "FP-add.txt")
    def f2b(f):
        return struct.unpack("<Q", struct.pack("<d", f))[0]
    cases = [
        (1.0, 2.0), (1.5, -0.25), (0.0, -0.0), (-0.0, -0.0),
        (float("inf"), 1.0), (float("inf"), -float("inf")),
        (float("nan"), 1.0), (5e-324, 5e-324), (1e308, 1e308),
        (1e-310, -5e-324), (3.141592653589793, 2.718281828459045),
        (1e16, 1.0), (-1.0, 1.0), (2.0**-1074, -(2.0**-1073)),
    ]
    def w64(v):
        return ((np.uint64(v) >> np.arange(64, dtype=np.uint64)) & np.uint64(1)).astype(np.int64)
    in1 = np.stack([w64(f2b(a)) for a, b in cases])
    in2 = np.stack([w64(f2b(b)) for a, b in cases])
    outs = run_plain(path, [in1, in2])[0]
    for i, (a, b) in enumerate(cases):
        got = int(sum(int(x) << j for j, x in enumerate(np.asarray(outs[i]))))
        want_ieee = f2b(a + b)
        mine = models.fp_add(f2b(a), f2b(b))
        tag = "IEEE" if got == want_ieee else ("MODEL" if got == mine else "NEITHER")
        print(f"  fpadd {a!r}+{b!r}: got={got:#018x} ieee={want_ieee:#018x} model={mine:#018x} {tag}")

if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which in ("all", "aes"): probe_aes()
    if which in ("all", "mult2"): probe_mult2()
    if which in ("all", "udiv"): probe_udiv()
    if which in ("all", "fpadd"): probe_fpadd()

def _w64(v):
    return ((np.uint64(v) >> np.arange(64, dtype=np.uint64)) & np.uint64(1)).astype(np.int64)

def _getint(o):
    return int(sum(int(x) << j for j, x in enumerate(np.asarray(o))))

def probe_fp2(name, cases, goldenf, n_in=2, out_w=None):
    import struct
    path = os.path.join(REF, "fp", name + ".txt")
    def f2b(f):
        if isinstance(f, int):
            return f
        return struct.unpack("<Q", struct.pack("<d", f))[0]
    in1 = np.stack([_w64(f2b(c[0])) for c in cases])
    words = [in1]
    if n_in == 2:
        words.append(np.stack([_w64(f2b(c[1])) for c in cases]))
    outs = run_plain(path, words)[0]
    for i, c in enumerate(cases):
        got = _getint(outs[i])
        mine = goldenf(*[f2b(x) for x in c])
        tag = "MODEL" if got == mine else "DIFF"
        print(f"  {name} {c}: got={got:#018x} model={mine:#018x} {tag}")

def probe_fp_more():
    import struct
    inf, ninf, nan = float("inf"), -float("inf"), float("nan")
    qnan_pay = 0x7ff800000000beef  # NaN with payload
    snan = 0x7ff000000000beef     # signaling NaN
    nnan = 0xfff8000000000000     # negative quiet NaN
    probe_fp2("FP-add", [
        (ninf, inf), (inf, inf), (ninf, ninf),
        (qnan_pay, 1.0), (1.0, qnan_pay), (snan, 1.0), (nnan, 1.0),
        (qnan_pay, nnan),
    ], models.fp_add)
    probe_fp2("FP-mul", [
        (2.0, 3.0), (0.0, inf), (inf, 0.0), (-0.0, inf), (inf, inf), (ninf, inf),
        (qnan_pay, 1.0), (1.0, nnan), (snan, 1.0),
        (5e-324, 0.5), (1e200, 1e200), (1e-200, 1e-200), (1.5, -2.5),
        (5e-324, 5e-324), (1e-310, 2.0),
    ], models.fp_mul)
    probe_fp2("FP-eq", [
        (1.0, 1.0), (0.0, -0.0), (nan, nan), (qnan_pay, qnan_pay), (1.0, 2.0),
        (inf, inf), (nan, 1.0),
    ], models.fp_eq)
    probe_fp2("FP-f2i", [
        (1.9,), (-1.9,), (0.5,), (-0.5,), (2.5,), (1e18,), (-1e18,), (1e20,),
        (nan,), (inf,), (ninf,), (0.0,), (-0.0,), (1.5,), (-2.5,),
    ], models.fp_f2i, n_in=1)

def probe_rest():
    # signed divide64: div-by-zero and INT_MIN/-1 conventions
    path = os.path.join(REF, "arith", "divide64.txt")
    M = (1 << 64) - 1
    cases = [(100, 7), (-100 & M, 7), (100, -7 & M), (-100 & M, -7 & M),
             (5, 0), (-5 & M, 0), (0, 0), ((1 << 63), M)]  # INT_MIN / -1
    in1 = np.stack([_w64(a) for a, b in cases])
    in2 = np.stack([_w64(b) for a, b in cases])
    outs = run_plain(path, [in1, in2])[0]
    for i, (a, b) in enumerate(cases):
        got = _getint(outs[i])
        sa = a - (1 << 64) if a >> 63 else a
        sb = b - (1 << 64) if b >> 63 else b
        trunc = None if sb == 0 else (abs(sa) // abs(sb)) * (1 if (sa >= 0) == (sb >= 0) else -1)
        print(f"  sdiv {sa}/{sb}: got={got:#018x} trunc={trunc}")
    # both-NaN ordering for FP-add/mul (payloads distinguish operands)
    na = 0x7ff800000000aaaa
    nb = 0x7ff800000000bbbb
    probe_fp2("FP-add", [(na, nb), (nb, na)], models.fp_add)
    probe_fp2("FP-mul", [(na, nb), (nb, na)], models.fp_mul)
    # negative NaN / negative overflow for f2i
    nnan = 0xfff8000000000000
    probe_fp2("FP-f2i", [(nnan,), (-1e20,), (9.223372036854776e18,), (-9.223372036854776e18,)],
              models.fp_f2i, n_in=1)

def probe_udiv2():
    path = os.path.join(REF, "arith", "udivide64.txt")
    import numpy as _np
    rng = _np.random.default_rng(17)
    a = rng.integers(0, 1 << 64, 4, dtype=_np.uint64)
    b = rng.integers(0, 1 << 64, 4, dtype=_np.uint64)
    b[1] = 0
    cases = list(zip([int(x) for x in a], [int(y) for y in b]))
    cases += [(0x8000000000000000, 0), (0x123456789, 0), (1, 0)]
    in1 = np.stack([_w64(x) for x, y in cases])
    in2 = np.stack([_w64(y) for x, y in cases])
    outs = run_plain(path, [in1, in2])[0]
    for i, (x, y) in enumerate(cases):
        got = _getint(outs[i])
        want = x // y if y else models.udiv(x, y, 64)
        print(f"  udiv {x:#x}/{y:#x}: got={got:#018x} model={want:#018x} {'OK' if got==want else 'DIFF'}")

def nonrestoring_udiv64(a, b, width=64):
    mask = (1 << width) - 1
    top = 1 << (width - 1)
    r = 0
    q = 0
    for i in range(width - 1, -1, -1):
        bit = (a >> i) & 1
        if not (r & top):  # r >= 0 signed
            r = (((r << 1) | bit) - b) & mask
        else:
            r = (((r << 1) | bit) + b) & mask
        q |= (0 if (r & top) else 1) << i
    return q

def probe_udiv3():
    path = os.path.join(REF, "arith", "udivide64.txt")
    import numpy as _np
    rng = _np.random.default_rng(123)
    cases = []
    for _ in range(8):
        cases.append((int(rng.integers(0, 1 << 64, dtype=_np.uint64)),
                      int(rng.integers(0, 1 << 64, dtype=_np.uint64))))
    for _ in range(8):  # force b >= 2^63
        cases.append((int(rng.integers(0, 1 << 64, dtype=_np.uint64)),
                      int(rng.integers(0, 1 << 64, dtype=_np.uint64)) | (1 << 63)))
    cases += [(0xdeadbeefcafebabe, 0), (0x8000000000000000, 0), (0, 0)]
    in1 = np.stack([_w64(x) for x, y in cases])
    in2 = np.stack([_w64(y) for x, y in cases])
    outs = run_plain(path, [in1, in2])[0]
    nok = 0
    for i, (x, y) in enumerate(cases):
        got = _getint(outs[i])
        want = nonrestoring_udiv64(x, y)
        ok = got == want
        nok += ok
        if not ok:
            print(f"  NR-MISMATCH {x:#x}/{y:#x}: got={got:#018x} nr={want:#018x}")
    print(f"udiv non-restoring model: {nok}/{len(cases)} match")

def probe_sdiv2():
    path = os.path.join(REF, "arith", "divide64.txt")
    import numpy as _np
    M = (1 << 64) - 1
    rng = _np.random.default_rng(321)
    cases = []
    for _ in range(12):
        cases.append((int(rng.integers(0, 1 << 64, dtype=_np.uint64)),
                      int(rng.integers(0, 1 << 64, dtype=_np.uint64))))
    cases += [((1 << 63), 0), ((1 << 63), (1 << 63)), (5, (1 << 63)), ((1<<63)|5, 0)]
    in1 = np.stack([_w64(x) for x, y in cases])
    in2 = np.stack([_w64(y) for x, y in cases])
    outs = run_plain(path, [in1, in2])[0]
    nok = 0
    for i, (x, y) in enumerate(cases):
        got = _getint(outs[i])
        sa, sb = (x >> 63) & 1, (y >> 63) & 1
        aa = ((-x) if sa else x) & M
        ab = ((-y) if sb else y) & M
        q = nonrestoring_udiv64(aa, ab)
        want = ((-q) if sa ^ sb else q) & M
        ok = got == want
        nok += ok
        if not ok:
            print(f"  SDIV-MISMATCH {x:#x}/{y:#x}: got={got:#018x} want={want:#018x}")
    print(f"sdiv sign-fixed non-restoring: {nok}/{len(cases)} match")

def probe_aes_sizes():
    for name, kb in (("aes_192", 24), ("aes_256", 32)):
        path = os.path.join(REF, "crypto", f"{name}.txt")
        key = bytes(range(kb))
        pt = bytes.fromhex("00112233445566778899aabbccddeeff")
        ct = models.aes_encrypt(pt, key)
        conv = CONVS["C:valueLE"]
        outs = run_plain(path, [np.stack([conv(key)]), np.stack([conv(pt)])])[0]
        got = np.asarray(outs[0])
        print(f"{name} valueLE: {'MATCH' if np.array_equal(got, conv(ct)) else 'MISMATCH'}")

def nonrestoring_udiv_w(a, b, width=64, regw=65):
    mask = (1 << regw) - 1
    top = 1 << (regw - 1)
    r = 0
    q = 0
    for i in range(width - 1, -1, -1):
        bit = (a >> i) & 1
        if not (r & top):
            r = (((r << 1) | bit) - b) & mask
        else:
            r = (((r << 1) | bit) + b) & mask
        q |= (0 if (r & top) else 1) << i
    return q

def probe_udiv4():
    path = os.path.join(REF, "arith", "udivide64.txt")
    import numpy as _np
    rng = _np.random.default_rng(777)
    cases = []
    for _ in range(6):
        cases.append((int(rng.integers(0, 1 << 64, dtype=_np.uint64)),
                      int(rng.integers(0, 1 << 64, dtype=_np.uint64)) | (1 << 63)))
    cases += [(0xdeadbeefcafebabe, 0), (0x8000000000000000, 0),
              (0x2d082b4c5567e0d6, 0xcfe56cf359099649)]
    in1 = np.stack([_w64(x) for x, y in cases])
    in2 = np.stack([_w64(y) for x, y in cases])
    outs = run_plain(path, [in1, in2])[0]
    for regw in (65, 66, 128):
        nok = sum(_getint(outs[i]) == nonrestoring_udiv_w(x, y, 64, regw)
                  for i, (x, y) in enumerate(cases))
        print(f"regw={regw}: {nok}/{len(cases)}")
    # also: restoring with 65-bit unsigned compare?
    def restoring(a, b, width=64):
        r = 0; q = 0
        for i in range(width - 1, -1, -1):
            r = (r << 1) | ((a >> i) & 1)
            if r >= b if b else True:
                q |= 1 << i
                r -= b
        return q
    nok = sum(_getint(outs[i]) == restoring(x, y) for i, (x, y) in enumerate(cases))
    print(f"restoring-true: {nok}/{len(cases)}")
