"""Negacyclic-NTT microbenchmark on the GPU (BASELINE.md item 4).

Measures the batched forward/inverse device NTT (fhe/ntt_dev.py, bit-exact
vs the host reference), chained through the transform, and derives the
NTT-based CMUX step cost at STD128_OPT shapes (R digit-poly forward NTTs +
2 inverse NTTs per gate per step, pointwise work treated as free).  Compare
it with the dense int8 step of the same card (bench.py / chip_smoke.py).
Without a GPU the script exits before measuring.

Usage: python tools/bench_ntt.py [batch=4096] [iters=8]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from oece_tpu.utils.compcache import enable_compilation_cache

enable_compilation_cache()

import jax
import jax.numpy as jnp
import numpy as np

from oece_tpu.fhe import ntt_dev
from oece_tpu.fhe.params import Q27, STD128_OPT


def main():
    import chip_smoke

    card = chip_smoke.phase_device()
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    iters = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    N = 1024
    rng = np.random.default_rng(0)
    a0 = jnp.asarray(rng.integers(0, Q27, (B, N)), jnp.int32)

    fwd = jax.jit(ntt_dev.ntt_forward_dev)
    inv = jax.jit(ntt_dev.ntt_inverse_dev)

    # correctness spot-check on this backend
    chk = np.asarray(inv(fwd(a0[:4])))
    np.testing.assert_array_equal(chk, np.asarray(a0[:4]))

    def timed(fn, x):
        x = fn(x)  # compile + warm
        jax.block_until_ready(x)
        t0 = time.time()
        for _ in range(iters):
            x = fn(x)  # chained: output feeds input (valid domain both ways)
        jax.block_until_ready(x)
        return (time.time() - t0) / iters, x

    t_fwd, _ = timed(fwd, a0)
    t_inv, _ = timed(inv, a0)
    us_fwd = t_fwd / B * 1e6
    us_inv = t_inv / B * 1e6

    # Derived NTT-based GINX step at STD128_OPT (R = 2*d_g_used digit rows):
    # per gate per step, R forward NTTs of the digit polys + 2 inverse NTTs
    # of the output pair (pointwise mult-adds are comparatively free).
    R = 2 * STD128_OPT.d_g_used
    us_step_ntt = R * us_fwd + 2 * us_inv  # per gate

    res = {
        "card": card,
        "device_kind": jax.devices()[0].device_kind,
        "N": N,
        "batch": B,
        "iters": iters,
        "us_per_poly_forward": round(us_fwd, 3),
        "us_per_poly_inverse": round(us_inv, 3),
        "derived_ntt_step_us_per_gate": round(us_step_ntt, 3),
        "note": (
            "NTT transforms are exact int32 (bit-identical to the host "
            "reference); chained executions, fetch barrier.  The derived "
            "step cost charges R fwd + 2 inv NTTs per gate per CMUX step "
            "and treats NTT-domain pointwise work as free (favoring NTT)."
        ),
    }
    print(json.dumps(res))


if __name__ == "__main__":
    main()
