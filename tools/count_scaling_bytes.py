"""Counted level structure and gate-dp traffic of the big circuits.

Two dp axes exist:

  * CASE-dp (throughput mode): each device evaluates its own test-case
    shard of the arena.  Cases never interact and the keys are replicated,
    so the compiled per-level program has no cross-device operands.
  * GATE-dp (latency mode): each device bootstraps a shard of a level's
    gates; the produced wire ciphertexts must be all-gathered so every
    device's (replicated) arena sees them before the next level.  That
    allgather is the only cross-device traffic, and its bytes are exactly
    computable from the level plan: per level, W * T * (n+1) * 4 bytes.

This tool counts, with the same levelizer the evaluator runs: levels,
bootstrap gates, level widths, and the per-level allgather bytes at
STD128_OPT for T test cases.  It measures no time.

Usage: python tools/count_scaling_bytes.py [T=4]
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from oece_tpu.circuits import bristol
from oece_tpu.circuits.netlist import levelize
from oece_tpu.fhe.params import STD128_OPT

R = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")

BENCHES = {
    "sha256": "new_bristol_ckts/crypto/sha256.txt",
    "md5": "old_bristol_ckts/crypto/md5.txt",
    "sha1": "old_bristol_ckts/crypto/sha-1.txt",
    "aes_128": "new_bristol_ckts/crypto/aes_128.txt",
    "mult_32x32": "old_bristol_ckts/arith/mult_32x32.txt",
}


def main():
    T = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    ct_bytes = (STD128_OPT.n + 1) * 4
    out = {"ct_bytes_per_wire": ct_bytes, "T": T, "benches": {}}
    for bench, rel in BENCHES.items():
        nl = bristol.parse_bristol(os.path.join(R, rel))
        plan = levelize(nl)
        s = plan.stats()
        widths = np.array([len(l["boot_op"]) for l in plan.levels])
        bytes_lv = widths * T * ct_bytes
        out["benches"][bench] = {
            "levels": int(s["depth"]),
            "boot_gates": int(s["bootstrap_gates"]),
            "linear_gates": int(sum(len(l["lin_op"]) for l in plan.levels)),
            "max_level_width": int(s["max_level_width"]),
            "mean_level_width": float(widths.mean()),
            "levels_le_32_gates": int((widths <= 32).sum()),
            "allgather_bytes_per_level_mean": float(bytes_lv.mean()),
            "allgather_bytes_per_level_max": int(bytes_lv.max()),
            "allgather_bytes_total": int(bytes_lv.sum()),
        }
        print(json.dumps({bench: out["benches"][bench]}), flush=True)
    return out


if __name__ == "__main__":
    main()
