"""Device-mesh parallelism for batched gate bootstrapping.

The reference's only parallelism is intra-level OpenMP gate tasks
(circuit.cpp:698-710); there is no distributed backend (SURVEY.md §2.7).
Here the same independence structure maps onto a JAX device mesh:

  * ``dp`` (data parallel): the gate batch of a level is sharded across
    devices — bootstraps are embarrassingly parallel, keys replicated.
  * ``tp`` (tensor parallel, GINX): the blind-rotation contraction (RGSW
    rows axis of the key) and the key-switch contraction are sharded, with
    a per-step ``psum`` over the tp axis.

Implemented with ``shard_map`` so the collectives are explicit; the same
code runs on a virtual multi-device CPU mesh (tests) and on several GPUs.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..fhe import boot
from ..fhe.params import BinFHEMethod


def make_mesh(n_devices: Optional[int] = None, tp: int = 1) -> Mesh:
    """Build a (dp, tp) mesh over the first n_devices devices."""
    devs = jax.devices()[: n_devices or len(jax.devices())]
    n = len(devs)
    assert n % tp == 0, (n, tp)
    arr = np.array(devs).reshape(n // tp, tp)
    return Mesh(arr, ("dp", "tp"))


def _tp_sharded(keys: boot.DeviceBootKeys) -> bool:
    """Only GINX keys shard their contraction (AP is dp-only)."""
    return keys.method == BinFHEMethod.GINX


def _key_specs(keys: boot.DeviceBootKeys):
    """PartitionSpecs of (brk, ap_kext, ksk, tv_table)."""
    if _tp_sharded(keys):
        return (
            P(None, None, None, None, "tp", None),  # brk RGSW rows axis
            P(),
            P("tp", None, None),  # ksk contraction axis
            P(),
        )
    return (P(), P(), P(), P())


def _check_tp(keys: boot.DeviceBootKeys, mesh: Mesh) -> None:
    if int(mesh.shape.get("tp", 1)) > 1:
        assert _tp_sharded(keys), "AP shards dp-only; build the mesh with tp=1"


def shard_bootstrap_keys(keys: boot.DeviceBootKeys, mesh: Mesh) -> boot.DeviceBootKeys:
    """Place keys on the mesh: replicated over ``dp``; GINX keys
    additionally shard their RGSW rows / key-switch contraction over
    ``tp``."""
    _check_tp(keys, mesh)
    leaves = (keys.brk, keys.ap_kext, keys.ksk, keys.tv_table)
    placed = [
        None if x is None else jax.device_put(x, NamedSharding(mesh, spec))
        for x, spec in zip(leaves, _key_specs(keys))
    ]
    brk, ap_kext, ksk, tv = placed
    return boot.DeviceBootKeys(
        params=keys.params, method=keys.method, brk=brk, ap_kext=ap_kext,
        ksk=ksk, tv_table=tv,
    )


def make_sharded_gate_fn(keys: boot.DeviceBootKeys, mesh: Mesh):
    """Return a jitted fn(gids, c1, c2) evaluating gates sharded over the
    mesh.  The batch must be divisible by the dp size."""
    _check_tp(keys, mesh)
    tp_axis = "tp" if _tp_sharded(keys) else None

    def local_fn(lkeys, gids, c1, c2):
        # always reduce over tp when sharded (a size-1 psum is a no-op and
        # keeps the scan carry's varying-axes type consistent)
        return boot.eval_bin_gate_batch(lkeys, gids, c1, c2, tp_axis=tp_axis)

    leaves = (keys.brk, keys.ap_kext, keys.ksk, keys.tv_table)
    brk, ap_kext, ksk, tv = (
        None if x is None else spec for x, spec in zip(leaves, _key_specs(keys))
    )
    key_spec = boot.DeviceBootKeys(
        params=keys.params, method=keys.method, brk=brk, ap_kext=ap_kext,
        ksk=ksk, tv_table=tv,
    )
    smapped = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(key_spec, P("dp"), P("dp", None), P("dp", None)),
        out_specs=P("dp", None),
    )
    jfn = jax.jit(smapped)  # keys are jit arguments, never constants

    def fn(gids, c1, c2):
        return jfn(keys, gids, c1, c2)

    return fn


def eval_bin_gate_sharded(
    keys: boot.DeviceBootKeys,
    gids: jnp.ndarray,
    c1: jnp.ndarray,
    c2: jnp.ndarray,
    mesh: Mesh,
):
    """One-shot convenience wrapper (builds the sharded fn each call)."""
    return make_sharded_gate_fn(keys, mesh)(gids, c1, c2)
