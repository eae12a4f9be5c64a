"""dp/tp sharding-overhead measurement on the virtual 8-device mesh
(VERDICT r3 #9 / BASELINE.md goal 3).

What CAN be measured on virtual CPU devices: the collective structure of
the compiled programs and that every sharding reproduces the unsharded
ciphertexts bit for bit.  What CANNOT: speedup — the 8 "devices" share one
CPU socket, so the walls say nothing about several GPUs (chip_smoke.py
--four-cards measures the dp path on real cards).

Writes artifacts/scaling_virtual.json.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax

jax.config.update("jax_platforms", "cpu")

import dataclasses

import jax.numpy as jnp
import numpy as np

from oece_tpu.fhe import boot, golden, lwe
from oece_tpu.fhe.params import STD128_OPT, BinFHEMethod
from oece_tpu.parallel import mesh as mesh_mod


def _time(fn, *args, reps=3):
    out = fn(*args)
    np.asarray(jax.tree_util.tree_leaves(out)[0])  # barrier
    t0 = time.time()
    for _ in range(reps):
        out = fn(*args)
    np.asarray(jax.tree_util.tree_leaves(out)[0])
    return (time.time() - t0) / reps


def main():
    # STD128_OPT-shaped (N=1024, q=1024, d_g_eff=2) at reduced n so the CPU
    # jnp path stays affordable; the sharding structure is n-independent.
    p = dataclasses.replace(STD128_OPT, name="STD128_OPT_SCAL", n=8)
    rng = np.random.default_rng(0)
    sk = golden.lwe_keygen(p, rng)
    bk = golden.bootstrap_keygen(p, sk, rng, BinFHEMethod.GINX)
    dkeys = boot.pack_bootstrap_key(bk)

    B = 32  # global batch, divisible by every dp size
    bits = rng.integers(0, 2, B)
    c1 = jnp.asarray(lwe.encrypt_bits(sk, bits, rng))
    c2 = jnp.asarray(lwe.encrypt_bits(sk, 1 - bits, rng))
    gids = jnp.asarray(np.zeros(B, np.int32))

    base_fn = jax.jit(boot.eval_bin_gate_batch)
    t_base = _time(lambda g, a, b: base_fn(dkeys, g, a, b), gids, c1, c2)
    rows = [{
        "config": "unsharded (1 virtual device)",
        "wall_s_per_batch": round(t_base, 4),
        "overhead_vs_unsharded": 0.0,
    }]
    ref_out = np.asarray(base_fn(dkeys, gids, c1, c2))

    def count_collectives(fn, *args):
        txt = jax.jit(fn).lower(*args).compile().as_text()
        return {
            op: txt.count(op)
            for op in ("all-reduce", "all-gather", "collective-permute",
                       "reduce-scatter", "all-to-all")
            if txt.count(op)
        }

    for dp, tp in ((2, 1), (4, 1), (8, 1), (4, 2)):
        mesh = mesh_mod.make_mesh(dp * tp, tp=tp)
        dk_m = mesh_mod.shard_bootstrap_keys(dkeys, mesh)
        fn = mesh_mod.make_sharded_gate_fn(dk_m, mesh)
        t = _time(fn, gids, c1, c2)
        assert np.array_equal(np.asarray(fn(gids, c1, c2)), ref_out)
        rows.append({
            "config": f"dp={dp} tp={tp}",
            "wall_s_per_batch": round(t, 4),
            "wall_ratio_vs_unsharded": round(t / t_base, 3),
            "collectives_in_hlo": count_collectives(
                lambda g, a, b: fn(g, a, b), gids, c1, c2
            ),
        })
        print(rows[-1], flush=True)

    # device-keygen keys: collective structure of the dp-only path
    from oece_tpu.fhe import devkeygen

    _sk2, _z2, dk_dev = devkeygen.device_keygen(p, seed=0)
    mesh8 = mesh_mod.make_mesh(8, tp=1)
    dk_dev = mesh_mod.shard_bootstrap_keys(dk_dev, mesh8)
    fn_dev = mesh_mod.make_sharded_gate_fn(dk_dev, mesh8)
    rows.append({
        "config": "dp=8 tp=1, device keygen",
        "wall_s_per_batch": None,
        "collectives_in_hlo": count_collectives(
            lambda g, a, b: fn_dev(g, a, b), gids, c1, c2
        ),
    })
    print(rows[-1], flush=True)

    doc = {
        "shape": "STD128_OPT-shaped (N=1024, q=1024, d_g_eff=2), reduced n=8",
        "global_batch": B,
        "backend": "cpu x 8 virtual devices (one socket!)",
        "honesty": (
            "The 8 'devices' share one CPU socket and XLA:CPU mostly "
            "serializes their programs, so wall_ratio does NOT measure "
            "multi-device speedup.  What it does expose: the per-step "
            "dense key build is batch-independent, so per-device work "
            "barely shrinks with dp on this backend.  The "
            "collectives_in_hlo column is the structural evidence a CPU "
            "run CAN give: golden-key rows show 2 all-reduces even at "
            "tp=1 (the size-1-axis psums of the blind-rotate and "
            "key-switch contractions, no-op traffic); the device-keygen dp "
            "row's count is the program's cross-device traffic."
        ),
        "rows": rows,
    }
    os.makedirs("artifacts", exist_ok=True)
    with open("artifacts/scaling_virtual.json", "w") as f:
        json.dump(doc, f, indent=1)
    print(json.dumps({"rows": rows}))
    print("# written artifacts/scaling_virtual.json")


if __name__ == "__main__":
    main()
