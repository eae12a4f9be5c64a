"""Device-mesh parallelism on the virtual 8-device CPU mesh.

Validates that the dp x tp sharded gate evaluation (shard_map + per-step
psum collectives) produces byte-identical ciphertexts to the single-device
path — the sharding must not change any integer result.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from oece_tpu.fhe import boot, golden as g, lwe
from oece_tpu.fhe.params import MICRO, BinFHEMethod
from oece_tpu.parallel.mesh import make_mesh, make_sharded_gate_fn


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(21)
    sk = g.lwe_keygen(MICRO, rng)
    bk = g.bootstrap_keygen(MICRO, sk, rng, BinFHEMethod.GINX)
    dkeys = boot.pack_bootstrap_key(bk)
    return sk, dkeys


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_sharded_matches_single_device(setup, tp, eight_devices):
    sk, dkeys = setup
    rng = np.random.default_rng(5)
    n_dev = 8
    mesh = make_mesh(n_dev, tp=tp)
    B = 2 * (n_dev // tp)
    m1 = rng.integers(0, 2, B)
    m2 = rng.integers(0, 2, B)
    c1 = jnp.asarray(lwe.encrypt_bits(sk, m1, rng))
    c2 = jnp.asarray(lwe.encrypt_bits(sk, m2, rng))
    gids = jnp.asarray(rng.integers(0, 6, B).astype(np.int32))

    ref = np.asarray(boot.eval_bin_gate_batch(dkeys, gids, c1, c2))
    fn = make_sharded_gate_fn(dkeys, mesh)
    got = np.asarray(fn(gids, c1, c2))
    assert np.array_equal(got, ref), "sharded result must be bit-identical"
