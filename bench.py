"""Headline benchmark: prints ONE JSON line with the headline metric.

Headline (BASELINE.md): gate bootstraps/sec/chip at STD128_OPT (GINX).
Every AND/OR/XOR gate of an encrypted circuit costs exactly one bootstrap
in this framework, so this number divides directly into circuit wall-clocks.

One process, one GPU: device keygen from a fixed seed, then 10 CHAINED
batches of B = 2048 gates (batch i+1's inputs are batch i's outputs, as in
a circuit), every output decrypted against the plaintext-simulated chain.
The value is 0 unless every gate is correct.  Without a GPU the script
exits non-zero before measuring anything.

vs_baseline: the reference has no published numbers (BASELINE.md); the
baseline constant below is our *estimate* of the reference stack (OpenFHE
binfhe v1.0 GINX STD128_OPT) on a 32-core server CPU: ~12 bootstraps/s/core
x 32 threads with perfect OpenMP scaling (circuit.cpp:698-710).  The
"baseline_basis" field marks it as an estimate, not a measurement.

Usage: python bench.py
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

REFERENCE_CPU_BOOTS_PER_SEC = 400.0
BASELINE_BASIS = (
    "estimate: OpenFHE binfhe GINX ~12 boots/s/core x 32 cores "
    "(no published reference numbers)"
)
B = 2048
K = 10  # chained batches


def main() -> None:
    import chip_smoke as cs

    card = cs.phase_device()
    import jax

    from oece_tpu.utils.compcache import enable_compilation_cache

    enable_compilation_cache()
    sk, dkeys = cs.ginx_keys(seed=0)
    compiled, _ = cs.compile_gate_batch(dkeys, B)
    dt, n_ok = cs.run_chained(compiled, dkeys, sk, B, K)
    print(f"# STD128_OPT: {dt * 1e3:.3f} ms / {B}-gate batch (chained x{K}); "
          f"correct {n_ok}/{B * K} [{card}]", file=sys.stderr)
    value = B / dt if n_ok == B * K else 0.0
    d = jax.devices()
    print(json.dumps({
        "metric": "gate_bootstraps_per_sec_per_chip_STD128_OPT_GINX",
        "value": value,
        "unit": "bootstraps/s",
        "vs_baseline": value / REFERENCE_CPU_BOOTS_PER_SEC,
        "baseline_basis": BASELINE_BASIS,
        "device": {"platform": d[0].platform, "kind": d[0].device_kind,
                   "count": len(d), "card": card},
    }))


if __name__ == "__main__":
    main()
