"""Two-process jax.distributed dryrun (VERDICT r3 #9).

This dryrun proves the DISTRIBUTED CODE PATH without several hosts: two OS
processes, each owning 4 virtual CPU devices, join a jax.distributed
coordination service and evaluate one dp-sharded encrypted gate batch as a
single 8-device SPMD program.  Each process holds only its addressable
shards; every process decrypts and checks its local gates.

This is the same Mesh/NamedSharding/shard_map code the single-process
virtual mesh and several GPU hosts would run — jax inserts the
collectives from the shardings, so nothing in oece_tpu changes
between 1 process and N (SURVEY §2.7's distribution design).

Usage:  python tools/dryrun_multihost.py            # parent: spawns 2 procs
        OECE_MH_RANK=k python tools/dryrun_multihost.py  # child (internal)
"""

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_PROC = 2
LOCAL_DEVICES = 4
PORT = int(os.environ.get("OECE_MH_PORT", "37931"))


def child(rank: int) -> None:
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={LOCAL_DEVICES}"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"localhost:{PORT}",
        num_processes=N_PROC,
        process_id=rank,
    )
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from oece_tpu.fhe import boot, golden, lwe
    from oece_tpu.fhe.params import MICRO, BinFHEMethod
    from oece_tpu.parallel import mesh as mesh_mod

    n_global = N_PROC * LOCAL_DEVICES
    assert len(jax.devices()) == n_global, len(jax.devices())
    mesh = mesh_mod.make_mesh(n_global, tp=1)

    # deterministic keys: every process derives the same key material
    rng = np.random.default_rng(0)
    p = MICRO
    sk = golden.lwe_keygen(p, rng)
    bk = golden.bootstrap_keygen(p, sk, rng, BinFHEMethod.GINX)
    dkeys = boot.pack_bootstrap_key(bk)
    dkeys = mesh_mod.shard_bootstrap_keys(dkeys, mesh)  # replicated/tp=1

    B = 4 * n_global
    bits1 = rng.integers(0, 2, B)
    bits2 = rng.integers(0, 2, B)
    gids_np = rng.integers(0, 6, B).astype(np.int32)
    c1_np = lwe.encrypt_bits(sk, bits1, rng)
    c2_np = lwe.encrypt_bits(sk, bits2, rng)

    dp_sh = NamedSharding(mesh, P("dp"))
    dp_sh2 = NamedSharding(mesh, P("dp", None))
    gids = jax.device_put(jnp.asarray(gids_np), dp_sh)
    c1 = jax.device_put(jnp.asarray(c1_np), dp_sh2)
    c2 = jax.device_put(jnp.asarray(c2_np), dp_sh2)

    fn = mesh_mod.make_sharded_gate_fn(dkeys, mesh)
    out = fn(gids, c1, c2)

    truth = [
        lambda a, b: a & b, lambda a, b: a | b, lambda a, b: 1 - (a & b),
        lambda a, b: 1 - (a | b), lambda a, b: a ^ b, lambda a, b: 1 - (a ^ b),
    ]
    want_all = np.array(
        [truth[g](int(a), int(b)) for g, a, b in zip(gids_np, bits1, bits2)]
    )
    n_checked = 0
    for shard in out.addressable_shards:
        lo = shard.index[0].start or 0
        got = lwe.decrypt_bits(sk, np.asarray(shard.data))
        np.testing.assert_array_equal(got, want_all[lo : lo + got.shape[0]])
        n_checked += got.shape[0]
    print(
        f"[rank {rank}] OK: {n_checked}/{B} local gates verified on "
        f"{LOCAL_DEVICES} local / {n_global} global devices",
        flush=True,
    )
    jax.distributed.shutdown()


def main() -> None:
    rank = os.environ.get("OECE_MH_RANK")
    if rank is not None:
        child(int(rank))
        return
    procs = []
    for r in range(N_PROC):
        env = dict(os.environ, OECE_MH_RANK=str(r))
        env.pop("JAX_PLATFORMS", None)
        procs.append(
            subprocess.Popen(
                [sys.executable, os.path.abspath(__file__)],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
        )
    ok = True
    for r, pr in enumerate(procs):
        out, _ = pr.communicate(timeout=600)
        sys.stdout.write(out)
        ok &= pr.returncode == 0 and "OK:" in out
    print("dryrun_multihost:", "PASS" if ok else "FAIL")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
