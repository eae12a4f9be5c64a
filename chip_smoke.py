"""Smoke run of the encrypted-circuit path on one GPU (or a four-GPU mesh).

Usage:
    python chip_smoke.py               # one card, all default phases
    python chip_smoke.py --four-cards  # dp = 4 mesh phase only (>= 4 cards)

Every phase runs in this one process and prints its result on its own
line; any failed phase raises, so the script exits non-zero and prints no
result line.  The last line of standard output is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Default phases:
  1. device   — refuse anything but a GPU; card name and power limit.
  2. compile  — STD128_OPT gate batch at B = 2048 and B = 128: compile
                seconds, memory_analysis(), what the contractions lowered to.
  3. exact    — one STD128_OPT blind-rotation step (8 lanes, one with
                a = 0) and a full TOY bootstrap batch, bit-exact vs the
                NumPy golden model on the same keys.
  4. gates    — STD128_OPT GINX device keys, 10 chained B = 2048 batches,
                every output decrypted; one STD128_OPT AP batch at B = 128.
  5. sha256   — the reference's canonical workload (new-Bristol SHA-256,
                STD128_OPT, verify mode, 4 FIPS 180-4 vectors).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from collections import Counter

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SHA256 = os.path.join(ROOT, "examples", "new_bristol_ckts", "crypto", "sha256.txt")
MULT32 = os.path.join(ROOT, "examples", "old_bristol_ckts", "arith", "mult_32x32.txt")

TRUTH = [
    lambda a, b: a & b, lambda a, b: a | b, lambda a, b: 1 - (a & b),
    lambda a, b: 1 - (a | b), lambda a, b: a ^ b, lambda a, b: 1 - (a ^ b),
]


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_name() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return out.splitlines()[0].strip()


def phase_device(min_count: int = 1) -> str:
    import jax
    import jaxlib

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"no GPU: jax.devices()[0].platform = {devs[0].platform!r}"
        )
    if len(devs) < min_count:
        raise SystemExit(f"need {min_count} GPUs, found {len(devs)}")
    card = card_name()
    print(card, flush=True)
    log("device", f"{len(devs)} x {devs[0].device_kind}; jax {jax.__version__}, "
        f"jaxlib {jaxlib.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    return card


def lowering_summary(hlo: str) -> dict:
    """What the contractions of a compiled program lowered to: library
    calls (cuBLAS), custom fusions (Triton/cuDNN GEMMs), and any dot left
    to XLA's own emitters, keyed "out<-operand" by element type."""
    dots = re.findall(r"= (\w+)\[[^\]]*\]\S* dot\((\w+)\[", hlo)
    return {
        "custom_calls": dict(Counter(re.findall(r'custom_call_target="([^"]+)"', hlo))),
        "custom_fusions": dict(Counter(re.findall(r'"kind":"(__[\w$]+)"', hlo))),
        "dots": dict(Counter(f"{o}<-{i}" for o, i in dots)),
        "gathers": len(re.findall(r" gather\(", hlo)),
    }


def _gate_inputs(sk, params, B, seed):
    import jax.numpy as jnp

    from oece_tpu.fhe import lwe

    rng = np.random.default_rng(seed)
    m1 = rng.integers(0, 2, B)
    m2 = rng.integers(0, 2, B)
    gids = rng.integers(0, 6, B).astype(np.int32)
    c1 = jnp.asarray(lwe.encrypt_bits(sk, m1, rng))
    c2 = jnp.asarray(lwe.encrypt_bits(sk, m2, rng))
    return m1, m2, gids, c1, c2


def compile_gate_batch(dkeys, B: int, tag: str = "compile"):
    """Lower + compile the batched gate bootstrap at batch B; prints compile
    seconds, memory_analysis() and the lowering summary."""
    import jax
    import jax.numpy as jnp

    from oece_tpu.fhe import boot

    p = dkeys.params
    spec_c = jax.ShapeDtypeStruct((B, p.n + 1), jnp.int32)
    spec_g = jax.ShapeDtypeStruct((B,), jnp.int32)
    fn = jax.jit(lambda k, g, a, b: boot.eval_bin_gate_batch(k, g, a, b))
    t0 = time.time()
    compiled = fn.lower(dkeys, spec_g, spec_c, spec_c).compile()
    dt = time.time() - t0
    log(tag, f"{p.name} {dkeys.method.name} B={B}: compiled in {dt:.2f} s; "
        f"memory_analysis: {compiled.memory_analysis()}")
    log(tag, f"B={B} lowering: {json.dumps(lowering_summary(compiled.as_text()))}")
    return compiled, dt


def run_chained(compiled, dkeys, sk, B: int, K: int, seed: int = 1):
    """K chained gate batches (batch i+1 consumes batch i's outputs); every
    output decrypted against the plaintext chain.  -> (s per batch, n_ok)"""
    import jax
    import jax.numpy as jnp

    from oece_tpu.fhe import lwe

    m1, m2, _, c1, c2 = _gate_inputs(sk, dkeys.params, B, seed)
    rng = np.random.default_rng(seed + 1)
    gids = [rng.integers(0, 6, B).astype(np.int32) for _ in range(K)]
    gids_dev = [jnp.asarray(g) for g in gids]
    jax.block_until_ready(compiled(dkeys, gids_dev[0], c1, c2))  # warm-up
    outs = []
    x1, x2 = c1, c2
    t0 = time.time()
    for it in range(K):
        out = compiled(dkeys, gids_dev[it], x1, x2)
        outs.append(out)
        x1, x2 = out, jnp.roll(x1, 1, axis=0)
    jax.block_until_ready(outs)
    dt = (time.time() - t0) / K
    b1, b2 = m1.copy(), m2.copy()
    n_ok = 0
    for it in range(K):
        want = np.array([TRUTH[g](int(a), int(c)) for g, a, c in zip(gids[it], b1, b2)])
        n_ok += int((lwe.decrypt_bits(sk, np.asarray(outs[it])) == want).sum())
        b1, b2 = want, np.roll(b1, 1)
    return dt, n_ok


def phase_compile(dkeys, batches=(2048, 128)):
    return {B: compile_gate_batch(dkeys, B)[0] for B in batches}


def golden_rot_step(p, acc, ai, brk_pos_i, brk_neg_i):
    """One step of golden.blind_rotate_ginx_rot for one lane (a = 0 too)."""
    from oece_tpu.fhe import golden

    N, Q = p.N, p.Q
    if ai % (2 * N) == 0:
        return acc % Q
    d_pos = (golden.negacyclic_monomial_mul(acc, 2 * N - ai, N, Q) - acc) % Q
    d_neg = (golden.negacyclic_monomial_mul(acc, ai, N, Q) - acc) % Q
    return (
        acc
        + golden.external_product(p, d_pos, brk_pos_i)
        + golden.external_product(p, d_neg, brk_neg_i)
    ) % Q


def check_rot_step(p, B: int = 8, seed: int = 51) -> None:
    """One blind-rotation step on the device == golden, bit for bit, on
    random RGSW-shaped key material (lane 0 has a = 0)."""
    import jax
    import jax.numpy as jnp

    from oece_tpu.fhe import boot

    rng = np.random.default_rng(seed)
    Q, N = p.Q, p.N
    R = 2 * p.d_g_used
    brk = rng.integers(0, Q, (2, R, 2, N), dtype=np.int64)  # [part, rows, out, N]
    key = boot.toeplitz_blocks(boot._poly_ext_limbs(brk[None], Q))[0]
    acc = rng.integers(0, Q, (B, 2, N)).astype(np.int64)
    a_col = ((2 * N // p.q) * rng.integers(0, p.q, (B,))).astype(np.int32)
    a_col[0] = 0
    step = jax.jit(lambda a, c, k: boot.ginx_step(a, c, k, p))
    got = np.asarray(step(jnp.asarray(acc.astype(np.int32)), jnp.asarray(a_col),
                          jnp.asarray(key)))
    want = np.stack([
        golden_rot_step(p, acc[b], int(a_col[b]), brk[0], brk[1]) for b in range(B)
    ])
    if not np.array_equal(got, want):
        raise AssertionError(f"{p.name} step differs from golden")


def check_bootstrap_batch(p, B: int = 8, seed: int = 52) -> None:
    """A full gate-bootstrap batch == golden (rot form), same keys."""
    import jax.numpy as jnp

    from oece_tpu.fhe import boot, golden, lwe
    from oece_tpu.fhe.params import BinFHEMethod

    rng = np.random.default_rng(seed)
    sk = golden.lwe_keygen(p, rng)
    bk = golden.bootstrap_keygen(p, sk, rng, BinFHEMethod.GINX)
    dkeys = boot.pack_bootstrap_key(bk)
    gids = (np.arange(B) % 6).astype(np.int32)
    c1 = lwe.encrypt_bits(sk, rng.integers(0, 2, B), rng)
    c2 = lwe.encrypt_bits(sk, rng.integers(0, 2, B), rng)
    got = np.asarray(boot.eval_bin_gate_batch(
        dkeys, jnp.asarray(gids), jnp.asarray(c1), jnp.asarray(c2)))
    for k, gi in enumerate(gids):
        gate = boot.GATE_ORDER[gi]
        prep = golden.gate_prepare(gate, c1[k].astype(np.int64),
                                   c2[k].astype(np.int64), p.q)
        want = golden.bootstrap(p, bk, prep, gate, form="rot")
        if not np.array_equal(got[k], want):
            raise AssertionError(f"{p.name} bootstrap lane {k} differs from golden")


def phase_exact() -> None:
    from oece_tpu.fhe.params import STD128_OPT, TOY

    check_rot_step(STD128_OPT)
    log("exact", f"STD128_OPT blind-rotation step, 8 lanes (one a=0): "
        f"bit-exact vs golden")
    check_bootstrap_batch(TOY)
    log("exact", "TOY bootstrap batch of 8: bit-exact vs golden")


def ginx_keys(seed: int = 0):
    """STD128_OPT GINX device keys (timed)."""
    import jax

    from oece_tpu.fhe import devkeygen
    from oece_tpu.fhe.params import STD128_OPT

    t0 = time.time()
    sk, _z, dkeys = devkeygen.device_keygen(STD128_OPT, seed=seed)
    jax.block_until_ready(dkeys.brk)
    log("keys", f"STD128_OPT GINX device keygen ({dkeys.brk.nbytes} key "
        f"bytes) {time.time() - t0:.2f} s")
    return sk, dkeys


def phase_gates(card: str, compiled, dkeys, sk) -> None:
    """STD128_OPT GINX: 10 chained B = 2048 batches, all outputs correct."""
    B, K = 2048, 10
    dt, n_ok = run_chained(compiled[B], dkeys, sk, B, K)
    log("gates", f"STD128_OPT GINX B={B}: {dt * 1e3:.2f} ms/batch, "
        f"{B / dt:.1f} bootstraps/s, correct {n_ok}/{B * K} [{card}]")
    if n_ok != B * K:
        raise AssertionError(f"gate batch: {n_ok}/{B * K} correct")


def phase_ap(card: str, B: int = 128, seed: int = 0) -> None:
    """One STD128_OPT binary-base AP batch at B = 128, decrypted."""
    import jax

    from oece_tpu.fhe import devkeygen
    from oece_tpu.fhe.params import STD128_OPT

    t0 = time.time()
    sk, _z, dkeys = devkeygen.device_keygen_ap(STD128_OPT, seed=seed)
    jax.block_until_ready(dkeys.brk)
    log("ap", f"STD128_OPT AP device keygen {time.time() - t0:.2f} s "
        f"({dkeys.params.n * dkeys.params.d_r} steps)")
    compiled, _ = compile_gate_batch(dkeys, B, tag="ap")
    dt, n_ok = run_chained(compiled, dkeys, sk, B, 1)
    log("ap", f"STD128_OPT AP B={B}: {dt * 1e3:.2f} ms/batch, correct {n_ok}/{B} [{card}]")
    if n_ok != B:
        raise AssertionError(f"AP batch: {n_ok}/{B} correct")


class CompileTimer:
    """Sums XLA backend compile seconds reported through jax.monitoring."""

    def __init__(self):
        import jax

        self.seconds = 0.0
        self.count = 0

        def listener(event, duration, **kw):
            if "backend_compile" in event:
                self.seconds += duration
                self.count += 1

        jax.monitoring.register_event_duration_secs_listener(listener)


def run_circuit(card: str, tag: str, fname: str, test_fn, mesh=None,
                timer: CompileTimer | None = None, seed: int = 0,
                set_name: str = "STD128_OPT") -> dict:
    """Keygen + two-tier harness run (plaintext, then encrypted with
    per-level verify) at STD128_OPT, 4 loops; requires 4/4 and 0 repairs."""
    import jax

    from oece_tpu.runtime import evaluator
    from oece_tpu.runtime.evaluator import Circuit

    t0 = time.time()
    c = Circuit(set=set_name, method="GINX", seed=seed, mesh=mesh)
    jax.block_until_ready(c.dkeys.brk)
    t_keys = time.time() - t0
    c0 = (timer.seconds, timer.count) if timer else (0.0, 0)
    r = test_fn(fname, num_loops=4, circuit=c, verify=True)
    wall = c.trace.total_s
    n_progs = (evaluator._fused_level_fn.cache_info().currsize
               + evaluator._lin_level_fn.cache_info().currsize)
    stats = jax.devices()[0].memory_stats() or {}
    res = {
        "summary": r.summary(),
        "plain": f"{r.plain_passed}/{r.n_cases}",
        "encrypted": f"{r.enc_passed}/{r.n_cases}",
        "repairs": dict(c.bad_gate_counts),
        "encrypted_wall_s": wall,
        "bootstraps": c._bootstraps_run,
        "keygen_s": t_keys,
        "compile_s": (timer.seconds - c0[0]) if timer else None,
        "compiles": (timer.count - c0[1]) if timer else None,
        "level_programs": n_progs,
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
    }
    log(tag, f"{json.dumps(res)} [{card}]")
    if not (r.passed and r.enc_passed == r.n_cases == 4 and c.bad_gate_counts == {}):
        raise AssertionError(f"{tag}: {r.summary()}, repairs {c.bad_gate_counts}")
    return res


def phase_four_cards(card: str, set_name: str = "STD128_OPT", B: int = 2048,
                     circuit: str = MULT32, test_fn=None) -> None:
    """dp = 4 mesh: a sharded gate batch bit-identical to device 0 alone,
    and a multiplier Clock()ed over the mesh (4/4 correct, 0 repairs)."""
    import jax
    import jax.numpy as jnp

    from oece_tpu.fhe import boot, devkeygen
    from oece_tpu.fhe.params import get_params
    from oece_tpu.harness import testlib
    from oece_tpu.parallel.mesh import (
        make_mesh, make_sharded_gate_fn, shard_bootstrap_keys,
    )

    p = get_params(set_name)
    mesh = make_mesh(4, tp=1)
    sk, _z, dkeys = devkeygen.device_keygen(p, seed=0)
    _, _, gids, c1, c2 = _gate_inputs(sk, p, B, seed=3)
    gids = jnp.asarray(gids)
    ref = np.asarray(jax.jit(boot.eval_bin_gate_batch)(dkeys, gids, c1, c2))
    fn = make_sharded_gate_fn(shard_bootstrap_keys(dkeys, mesh), mesh)
    jax.block_until_ready(fn(gids, c1, c2))
    t0 = time.time()
    got = np.asarray(fn(gids, c1, c2))
    dt = time.time() - t0
    if not np.array_equal(got, ref):
        raise AssertionError("dp=4 batch differs from the one-device batch")
    log("four", f"dp=4 {p.name} B={B} ({B // 4}/device): bit-identical to "
        f"device 0 alone; {dt * 1e3:.2f} ms/batch [{card}]")
    del dkeys, fn
    run_circuit(card, "four", circuit, test_fn or testlib.test_multiplier,
                mesh=mesh, set_name=set_name)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the dp = 4 mesh phase (needs 4 GPUs)")
    args = ap.parse_args(argv)

    card = phase_device(4 if args.four_cards else 1)
    sys.path.insert(0, ROOT)
    from oece_tpu.utils.compcache import enable_compilation_cache

    enable_compilation_cache()
    import jax

    if args.four_cards:
        phase_four_cards(card)
    else:
        from oece_tpu.fhe import boot
        from oece_tpu.harness import testlib

        timer = CompileTimer()
        sk, dkeys = ginx_keys()
        compiled = phase_compile(dkeys)
        phase_exact()
        phase_gates(card, compiled, dkeys, sk)
        del compiled, dkeys
        phase_ap(card)
        run_circuit(card, "sha256", SHA256, testlib.test_sha256, timer=timer)
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind, "count": len(d)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
