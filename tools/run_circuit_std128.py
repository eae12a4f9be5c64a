"""Record a REAL encrypted circuit run at production parameters (VERDICT r2 #2).

Runs one of the TB circuits (sha256, md5, aes_128, ...) through the full
two-tier harness flow — plaintext pass, then encrypted pass with per-level
verify — at STD128_OPT/GINX on the current backend, and commits the
evidence: the encrypted run's per-level trace (utils/trace.py) plus summary
metadata is written to artifacts/<bench>_<set>.json.

This is the reference's canonical workload (test_sha256.cpp:322-341: 4 KAT
vectors, encrypted, verify mode) measured end to end, replacing bench.py's
"projected SHA-256 wall-clock" with a recorded number.

Usage: python tools/run_circuit_std128.py [bench] [--set STD128_OPT]
       [--method GINX] [--loops 4] [--no-verify] [--xor-mode native]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from oece_tpu.utils.compcache import enable_compilation_cache

enable_compilation_cache()

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("bench", nargs="?", default="sha256")
    ap.add_argument("--set", default="STD128_OPT")
    ap.add_argument("--method", default="GINX")
    ap.add_argument("--loops", type=int, default=4)
    ap.add_argument("--no-verify", action="store_true")
    ap.add_argument("--xor-mode", default="native", choices=["native", "compound"])
    ap.add_argument(
        "--repeat", type=int, default=1,
        help="run the harness N times IN-PROCESS and record the last run: "
        "rep 1 pays the XLA compiles, rep N measures steady-state execution",
    )
    args = ap.parse_args()

    from oece_tpu.fhe.params import get_params
    from oece_tpu.harness import testlib as tl
    from oece_tpu.runtime.evaluator import Circuit

    R = tl.DEFAULT_CIRCUITS_DIR
    CASES = {
        "sha256": (f"{R}/new_bristol_ckts/crypto/sha256.txt", tl.test_sha256),
        "md5": (f"{R}/old_bristol_ckts/crypto/md5.txt", tl.test_md5),
        "sha1": (f"{R}/old_bristol_ckts/crypto/sha-1.txt", tl.test_sha1),
        "aes_128": (f"{R}/new_bristol_ckts/crypto/aes_128.txt", tl.test_aes_new),
        "aes": (f"{R}/old_bristol_ckts/crypto/AES-expanded.txt", tl.test_aes),
        "adder_32bit": (f"{R}/old_bristol_ckts/arith/adder_32bit.txt", tl.test_adder),
        "mult_32x32": (f"{R}/old_bristol_ckts/arith/mult_32x32.txt", tl.test_multiplier),
        "des": (f"{R}/old_bristol_ckts/crypto/DES-expanded.txt", tl.test_des),
    }

    get_params(args.set)  # fail fast on an unknown set

    t0 = time.time()
    c = Circuit(set=args.set, method=args.method, seed=0,
                xor_mode=args.xor_mode, verbose=True)
    print(f"# keys ready in {time.time()-t0:.1f}s", file=sys.stderr)

    results = []
    t_start = time.time()
    for fname, test_fn in [CASES[args.bench]]:
        print(f"# running {fname}", file=sys.stderr)
        for rep in range(args.repeat):
            r = test_fn(
                fname,
                num_loops=args.loops,
                circuit=c,
                set=args.set,
                method=args.method,
                verify=not args.no_verify,
                verbose=True,
            )
            print(f"# rep {rep + 1}/{args.repeat}: " + r.summary(),
                  file=sys.stderr)
        print("# " + r.summary(), file=sys.stderr)
        tr = c.trace  # the encrypted pass's trace (last Clock on this circuit)
        widths = [rec.boot_gates for rec in tr.records]
        # provenance (ADVICE r4: a stale artifact must not masquerade as a
        # measurement of the current pipeline)
        try:
            import subprocess

            rev = subprocess.run(
                ["git", "rev-parse", "--short", "HEAD"],
                cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                capture_output=True, text=True, timeout=10,
            ).stdout.strip() or "unknown"
        except Exception:
            rev = "unknown"
        doc = {
            "bench": args.bench,
            "circuit_file": fname,
            "set": args.set,
            "method": args.method,
            "xor_mode": args.xor_mode,
            "loops": args.loops,
            "verify": not args.no_verify,
            "provenance": {
                "git_rev": rev,
                "repeat": args.repeat,
            },
            "harness": {
                "n_cases": r.n_cases,
                "plain_passed": r.plain_passed,
                "enc_passed": r.enc_passed,
                "bad_gates_fixed": r.bad_gates_fixed,
                "bad_gate_levels": {
                    str(lv): d for lv, d in sorted(c.bad_gate_levels.items())
                },
                # OECE_BAD_TRACE=1: exact (level, lane, case, op, wire) of
                # each repair — the gate-resolution evidence the AES-anomaly
                # root-cause needs (NOISE.md §3)
                "bad_gate_lanes": list(getattr(c, "bad_gate_lanes", [])),
                "recover_counts": dict(c.recover_counts),
                "max_phase_err": c.max_phase_err,
                "wall_s": round(r.seconds, 2),
            },
            "encrypted_trace": {
                "summary": tr.summary(),
                "level_width_stats": {
                    "levels": len(widths),
                    "mean_boot_gates": round(float(np.mean(widths)), 2) if widths else 0,
                    "max_boot_gates": int(np.max(widths)) if widths else 0,
                    "pct_levels_lt_32_gates": round(
                        100.0 * float(np.mean(np.array(widths) * args.loops < 32)), 1
                    ) if widths else 0,
                },
                "levels": [
                    {
                        "level": rec.level,
                        "boot_gates": rec.boot_gates,
                        "batch": rec.batch,
                        "wall_s": round(rec.wall_s, 5),
                        "bootstraps": rec.bootstraps,
                    }
                    for rec in tr.records
                ],
            },
        }
        results.append(doc)

    os.makedirs("artifacts", exist_ok=True)
    base = os.path.basename(results[0]["circuit_file"]).rsplit(".", 1)[0]
    # the canonical artifact is the reference-parity 4-vector verify run;
    # variant batch sizes / pure-encrypted runs get their own name so they
    # never clobber it
    suffix = "" if args.loops == 4 else f"_T{args.loops}"
    if args.no_verify:
        suffix += "_pure"
    path = f"artifacts/{base}_{args.set.lower()}{suffix}.json"
    with open(path, "w") as f:
        json.dump(results if len(results) > 1 else results[0], f, indent=1)
    print(f"# total {time.time()-t_start:.1f}s; written {path}")
    top = results[0]
    print(json.dumps({
        "bench": args.bench,
        "enc_passed": f'{top["harness"]["enc_passed"]}/{top["harness"]["n_cases"]}',
        "encrypted_wall_s": top["encrypted_trace"]["summary"]["total_s"],
        "boots_per_sec": top["encrypted_trace"]["summary"]["bootstraps_per_sec"],
        "bad_gates_fixed": top["harness"]["bad_gates_fixed"],
    }))


if __name__ == "__main__":
    main()
