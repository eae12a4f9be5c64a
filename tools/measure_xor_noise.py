"""Targeted measurement of the native-XOR failure regime (VERDICT r4 #5).

Round 4's encrypted AES-128 run repaired 15 gates — all XOR — while the
mixed-gate noise runs (tools/measure_noise.py, 3x102,400 bootstraps) saw
zero failures.  NOISE.md §3 attributed this to "correlated XOR trees", but
static analysis (this tool's --scan mode) shows NO gate in any corpus
circuit has operands sharing a linear (NOT/EQW) root — bootstrap outputs
carry fresh noise, so that correlation mechanism cannot exist in these
circuits.  This tool measures the regime directly instead of modeling it:

  * per-gate-type CHAINED bootstrap loops (XOR-only, AND-only, ...) at
    production parameters on the accelerator — the output failure rate per type;
  * the INPUT-side margin: the centered phase error of the prepared
    linear combination w1*c1 + w2*c2 that the blind rotation actually
    decides on, histogrammed on device.  XOR preps 2(c1-c2): noise 2*sqrt2
    larger than AND's c1+c2, but its decision window [q/4, 3q/4) is also
    twice AND's — the measured margin-in-sigmas settles whether native
    XOR is actually weaker.

Usage: python tools/measure_xor_noise.py [STD128_OPT] [n_iters] [batch]
       python tools/measure_xor_noise.py --scan      # static root scan
Writes artifacts/xor_noise_<set>.json.
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

GATE_NAMES = ["AND", "OR", "NAND", "NOR", "XOR", "XNOR"]


def scan_corpus():
    """Static shared-linear-root scan over the corpus (the 'correlated
    operands' mechanism): root(w) follows NOT/EQW chains; a 2-input gate
    with root(in0) == root(in1) is a plaintext CONSTANT (or a copy) whose
    operands carry correlated noise.  Result on this corpus: none exist."""
    from oece_tpu.circuits import bristol
    from oece_tpu.circuits.netlist import BOOTSTRAP_OPS, Op

    BOOT = set(int(o) for o in BOOTSTRAP_OPS)
    R = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
    files = []
    for sub in ("old_bristol_ckts", "new_bristol_ckts"):
        for dirp, _dirs, fns in os.walk(os.path.join(R, sub)):
            files += [os.path.join(dirp, fn) for fn in fns if fn.endswith(".txt")]
    total = 0
    for f in sorted(files):
        try:
            nl = bristol.parse_bristol(f)
        except Exception:
            continue
        root = np.arange(nl.n_wires, dtype=np.int64)
        shared = 0
        for k in range(nl.n_gates):
            o = int(nl.op[k])
            a, b, w = int(nl.in0[k]), int(nl.in1[k]), int(nl.out[k])
            if o in (int(Op.NOT), int(Op.EQW)):
                root[w] = root[a]
            elif o in BOOT:
                shared += root[a] == root[b]
                root[w] = w
            else:
                root[w] = w
        total += shared
        if shared:
            print(f"{os.path.basename(f)}: {shared} shared-root gates")
    print(f"# corpus total shared-linear-root 2-input gates: {total}")
    return total


def main():
    if "--scan" in sys.argv:
        scan_corpus()
        return
    name = sys.argv[1] if len(sys.argv) > 1 else "STD128_OPT"
    n_iters = int(sys.argv[2]) if len(sys.argv) > 2 else 100
    B = int(sys.argv[3]) if len(sys.argv) > 3 else 2048
    p = PARAM_SETS[name]
    q, n = p.q, p.n
    rng = np.random.default_rng(321)
    from oece_tpu.fhe import devkeygen

    sk, _z, dkeys = devkeygen.device_keygen(p, seed=0)
    layout = "rev2"  # the rotated-difference step form (NOISE.md §3)
    s_dev = jnp.asarray(np.asarray(sk.s, dtype=np.int32))

    TRUTH = [
        lambda a, b: a & b, lambda a, b: a | b, lambda a, b: 1 - (a & b),
        lambda a, b: 1 - (a | b), lambda a, b: a ^ b, lambda a, b: 1 - (a ^ b),
    ]
    # per-gate decision window on the PREP phase (golden.GATE_WINDOW):
    # nearest distance from any valid prep point to the window boundary
    PREP_MARGIN = {  # q units
        "AND": q // 8, "OR": q // 8, "NAND": q // 8, "NOR": q // 8,
        "XOR": q // 4, "XNOR": q // 4,
    }

    import functools

    @functools.partial(jax.jit, static_argnums=(1,))
    def run_chunk(dkeys, gate_id, carry, key):
        def step(carry, _key):
            c1, c2, m1, m2, ohist, phist, nfail, maxo, maxp = carry
            gids = jnp.full((B,), gate_id, jnp.int32)
            prep = boot.prepare_gates(c1, c2, gids, q)
            # input-side margin: centered error of the prep phase vs the
            # KNOWN expected prep value w1*m1 + w2*m2 (in q/4 units) — the
            # full-range error the blind rotation's window decides on
            pphase = (
                prep[:, n] - jnp.einsum("bi,i->b", prep[:, :n], s_dev)
            ) % q
            w = jnp.take(jnp.asarray(boot.PREP_WEIGHTS), gids, axis=0)
            expq = (w[:, 0] * m1 + w[:, 1] * m2) % 4
            perr = (pphase - expq * (q // 4) + q // 2) % q - q // 2
            out = boot.bootstrap_batch(prep, gids, dkeys)
            want = TRUTH[int(gate_id)](m1, m2)
            phase = (out[:, n] - jnp.einsum("bi,i->b", out[:, :n], s_dev)) % q
            err = (phase - want * (q // 4)) % q
            err = jnp.where(err > q // 2, err - q, err)
            fail = jnp.abs(err) >= q // 8
            ohist = ohist + jnp.bincount((err + q // 2) % q, length=q)
            phist = phist + jnp.bincount((perr + q // 2) % q, length=q)
            carry = (
                out, jnp.roll(c1, 1, axis=0), want, jnp.roll(m1, 1),
                ohist, phist, nfail + jnp.sum(fail),
                jnp.maximum(maxo, jnp.max(jnp.abs(err))),
                jnp.maximum(maxp, jnp.max(jnp.abs(perr))),
            )
            return carry, None

        keys = jax.random.split(key, CHUNK)
        return jax.lax.scan(step, carry, keys)[0]

    CHUNK = 10
    results = {}
    for gate_id, gname in [(4, "XOR"), (0, "AND"), (5, "XNOR"), (1, "OR")]:
        m1 = rng.integers(0, 2, B)
        m2 = rng.integers(0, 2, B)
        c1 = jnp.asarray(lwe.encrypt_bits(sk, m1, rng))
        c2 = jnp.asarray(lwe.encrypt_bits(sk, m2, rng))
        carry = (
            c1, c2, jnp.asarray(m1, jnp.int32), jnp.asarray(m2, jnp.int32),
            jnp.zeros((q,), jnp.int32), jnp.zeros((q,), jnp.int32),
            jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32),
            jnp.zeros((), jnp.int32),
        )
        t0 = time.time()
        n_tot = 0
        for it in range(0, n_iters, CHUNK):
            carry = run_chunk(dkeys, gate_id, carry, jax.random.PRNGKey(it))
            n_tot += CHUNK * B
        ohist = np.asarray(carry[4])
        phist = np.asarray(carry[5])
        n_fail = int(np.asarray(carry[6]))
        max_o = int(np.asarray(carry[7]))
        max_p = int(np.asarray(carry[8]))
        dt = time.time() - t0
        centers = np.arange(q) - q // 2
        o_std = float(np.sqrt((ohist * centers**2).sum() / max(n_tot, 1)))
        p_std = float(np.sqrt((phist * centers**2).sum() / max(n_tot, 1)))
        margin = PREP_MARGIN[gname]
        results[gname] = {
            "bootstraps": n_tot,
            "failures": n_fail,
            "failure_rate": n_fail / n_tot,
            "out_noise_std": round(o_std, 2),
            "out_noise_max_abs": max_o,
            "prep_margin_q": margin,
            "prep_err_std": round(p_std, 2),
            "prep_err_max_abs": max_p,
            "prep_margin_sigmas": round(margin / p_std, 2) if p_std else None,
            "boots_per_sec": round(n_tot / dt, 1),
            "out_hist_nonzero": {
                int(c): int(h) for c, h in zip(centers, ohist) if h
            },
            "prep_hist_nonzero": {
                int(c): int(h) for c, h in zip(centers, phist) if h
            },
        }
        print(
            f"# {gname}: {n_tot} boots, {n_fail} failures, out sigma {o_std:.2f} "
            f"(max {max_o}), prep sigma {p_std:.2f} (max {max_p}, margin "
            f"{margin} = {margin/p_std if p_std else 0:.1f} sigma) [{dt:.0f}s]",
            flush=True,
        )

    res = {
        "set": name, "layout": layout, "backend": jax.default_backend(),
        "batch": B, "chained": True, "per_gate": results,
        "note": (
            "per-gate-type chained bootstrap loops; prep_err is the "
            "input-side phase error the blind rotation decides on "
            "(vs the gate's own window margin)"
        ),
    }
    os.makedirs("artifacts", exist_ok=True)
    path = f"artifacts/xor_noise_{name}.json"
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({
        g: {k: v for k, v in r.items() if not k.endswith("hist_nonzero")}
        for g, r in results.items()
    }))
    print(f"# written {path}")


if __name__ == "__main__":
    main()
