"""Measure the bootstrap noise distribution and failure rate (NOISE.md).

Fully DEVICE-RESIDENT methodology (per-batch host encryption and fetches
would dominate the measurement):

  * the initial ciphertext batch is encrypted on host and uploaded once;
  * every iteration bootstraps the previous iteration's outputs (chained —
    the same input-noise regime a real circuit runs in);
  * gate types are drawn on device (jax.random), the plaintext truth is
    co-evaluated on device, and the centered phase error of every output is
    histogrammed on device with jnp.bincount;
  * only the final q-bin histogram (+ counters) is fetched.

Reports noise sigma, max |e|, and the failure count vs the +-q/8 decision
margin; writes a JSON summary to artifacts/noise_<set>.json.

Usage: python tools/measure_noise.py [STD128_OPT] [n_iters] [batch]
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

from oece_tpu.fhe import boot, lwe
from oece_tpu.fhe.params import PARAM_SETS


def main():
    name = sys.argv[1] if len(sys.argv) > 1 else "STD128_OPT"
    n_iters = int(sys.argv[2]) if len(sys.argv) > 2 else 100
    B = int(sys.argv[3]) if len(sys.argv) > 3 else 1024
    p = PARAM_SETS[name]
    q, n = p.q, p.n
    rng = np.random.default_rng(123)
    from oece_tpu.fhe import devkeygen

    sk, _z, dkeys = devkeygen.device_keygen(p, seed=0)
    layout = "rev2"  # the rotated-difference step form (NOISE.md §3)
    s_dev = jnp.asarray(np.asarray(sk.s, dtype=np.int32))

    # truth table for GATE_ORDER = AND OR NAND NOR XOR XNOR as f(m1, m2)
    def truth_all(m1, m2):
        a, o, x = m1 & m2, m1 | m2, m1 ^ m2
        return jnp.stack([a, o, 1 - a, 1 - o, x, 1 - x], axis=0)  # [6, B]

    @jax.jit
    def run_chunk(dkeys, carry, key):
        # dkeys pass as a jit ARGUMENT: closure capture would bake the
        # device key into the compiled program as a constant.
        def step(carry, key):
            c1, c2, m1, m2, hist, nfail, maxabs = carry
            gids = jax.random.randint(key, (B,), 0, 6, jnp.int32)
            out = boot.eval_bin_gate_batch(dkeys, gids, c1, c2)
            want = jnp.take_along_axis(
                truth_all(m1, m2), gids[None, :], axis=0
            )[0]
            # centered phase error of out vs want (lwe.decrypt_noise
            # semantics: bits encode at bit*q/4, err = center(phase - want*q/4))
            phase = (out[:, n] - jnp.einsum("bi,i->b", out[:, :n], s_dev)) % q
            err = (phase - want * (q // 4)) % q
            err = jnp.where(err > q // 2, err - q, err)
            fail = jnp.abs(err) >= q // 8
            hist = hist + jnp.bincount((err + q // 2) % q, length=q)
            carry = (
                out,
                jnp.roll(c1, 1, axis=0),
                want,
                jnp.roll(m1, 1),
                hist,
                nfail + jnp.sum(fail),
                jnp.maximum(maxabs, jnp.max(jnp.abs(err))),
            )
            return carry, None

        keys = jax.random.split(key, CHUNK)
        return jax.lax.scan(step, carry, keys)[0]

    CHUNK = 10  # batches per device program (scan over CHUNK steps)
    m1 = rng.integers(0, 2, B)
    m2 = rng.integers(0, 2, B)
    c1 = jnp.asarray(lwe.encrypt_bits(sk, m1, rng))
    c2 = jnp.asarray(lwe.encrypt_bits(sk, m2, rng))
    carry = (
        c1, c2, jnp.asarray(m1, jnp.int32), jnp.asarray(m2, jnp.int32),
        jnp.zeros((q,), jnp.int32), jnp.zeros((), jnp.int32),
        jnp.zeros((), jnp.int32),
    )
    # upload barrier (keys + inputs) so timings are honest
    for leaf in jax.tree_util.tree_leaves((dkeys, carry)):
        if hasattr(leaf, "ravel"):
            np.asarray(leaf.ravel()[0:1])

    t0 = time.time()
    n_tot = 0
    hist = None
    for it in range(0, n_iters, CHUNK):
        carry = run_chunk(dkeys, carry, jax.random.PRNGKey(1000 + it))
        n_tot += CHUNK * B
        if it + CHUNK >= n_iters or (it // CHUNK) % 10 == 9:
            hist = np.asarray(carry[4])  # fetch = barrier
            n_fail = int(np.asarray(carry[5]))
            max_abs = int(np.asarray(carry[6]))
            dt = time.time() - t0
            print(
                f"# {n_tot} bootstraps, {n_fail} failures, max|e| {max_abs} "
                f"({dt:.0f}s, {n_tot/dt:.0f} boots/s)",
                flush=True,
            )

    centers = np.arange(q) - q // 2
    mean = float((hist * centers).sum() / n_tot)
    std = float(np.sqrt((hist * (centers - mean) ** 2).sum() / n_tot))
    margin = q // 8
    res = {
        "set": name,
        "method": "GINX",
        "layout": layout,
        "d_g_eff": p.d_g_eff,
        "backend": jax.default_backend(),
        "bootstraps": n_tot,
        "failures": n_fail,
        "failure_rate": n_fail / n_tot,
        "noise_mean": mean,
        "noise_std": std,
        "noise_max_abs": max_abs,
        "margin_q8": margin,
        "margin_sigmas": margin / std if std else None,
        "input_regime": "chained (outputs feed next gates, the circuit regime)",
        "hist_nonzero": {int(c): int(h) for c, h in zip(centers, hist) if h},
    }
    os.makedirs("artifacts", exist_ok=True)
    path = f"artifacts/noise_{name}_{layout}.json"
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({k: v for k, v in res.items() if k != "hist_nonzero"}))
    print(f"# written {path}")


if __name__ == "__main__":
    main()
