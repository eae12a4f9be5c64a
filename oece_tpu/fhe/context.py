"""BinFHEContext: drop-in API parity with OpenFHE's binfhe surface.

The reference programs use exactly this interface (SURVEY.md §2.8):
``GenerateBinFHEContext(set, method)`` (circuit.cpp:88), ``KeyGen``
(circuit.cpp:90), ``BTKeyGen`` (circuit.cpp:91), ``Encrypt``
(circuit.cpp:506), ``Decrypt`` (circuit.cpp:800), ``EvalBinGate``
(gate.cpp:133,171), ``EvalNOT`` (gate.cpp:112).

Single-ciphertext calls are conveniences over the batched core; use the
``*_batch`` methods (or the runtime evaluator) to actually fill a GPU.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from . import boot, golden, lwe
from .params import BinFHEMethod, BinGate, BinFHEParams, get_params


class BinFHEContext:
    """OpenFHE-style context object owning parameters and (after keygen)
    device-packed bootstrap keys."""

    def __init__(self) -> None:
        self.params: Optional[BinFHEParams] = None
        self.method: BinFHEMethod = BinFHEMethod.GINX
        self._rng = np.random.default_rng()
        self.bk: Optional[golden.BootstrapKey] = None
        self.dkeys: Optional[boot.DeviceBootKeys] = None

    # -- context/keys -------------------------------------------------------
    def GenerateBinFHEContext(
        self,
        set: str | BinFHEParams = "STD128_OPT",
        method: str | BinFHEMethod = "GINX",
        seed: Optional[int] = None,
    ) -> "BinFHEContext":
        self.params = get_params(set) if isinstance(set, str) else set
        self.method = (
            method if isinstance(method, BinFHEMethod) else BinFHEMethod[str(method).upper()]
        )
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        from ..utils.compcache import enable_compilation_cache

        enable_compilation_cache()
        return self

    def KeyGen(self) -> golden.LWESecretKey:
        assert self.params is not None, "GenerateBinFHEContext first"
        return golden.lwe_keygen(self.params, self._rng)

    def BTKeyGen(self, sk: golden.LWESecretKey) -> None:
        self.bk = golden.bootstrap_keygen(self.params, sk, self._rng, self.method)
        self.dkeys = boot.pack_bootstrap_key(self.bk)

    # -- encryption boundary ------------------------------------------------
    def Encrypt(self, sk: golden.LWESecretKey, m: int) -> np.ndarray:
        return lwe.encrypt_bits(sk, np.array([int(m)]), self._rng)[0]

    def Decrypt(self, sk: golden.LWESecretKey, ct: np.ndarray) -> int:
        return int(lwe.decrypt_bits(sk, np.asarray(ct)[None, :])[0])

    def EncryptBatch(self, sk: golden.LWESecretKey, bits: Sequence[int]) -> np.ndarray:
        return lwe.encrypt_bits(sk, np.asarray(bits), self._rng)

    def DecryptBatch(self, sk: golden.LWESecretKey, cts: np.ndarray) -> np.ndarray:
        return lwe.decrypt_bits(sk, np.asarray(cts))

    # -- gates --------------------------------------------------------------
    def EvalNOT(self, ct: np.ndarray) -> np.ndarray:
        return np.asarray(lwe.eval_not_batch(np.asarray(ct)[None, :], self.params.q))[0]

    def EvalBinGate(
        self, gate: str | BinGate, ct1: np.ndarray, ct2: np.ndarray
    ) -> np.ndarray:
        out = self.EvalBinGateBatch(gate, np.asarray(ct1)[None, :], np.asarray(ct2)[None, :])
        return np.asarray(out)[0]

    def EvalBinGateBatch(
        self,
        gate: str | BinGate | Sequence[BinGate],
        ct1: np.ndarray,
        ct2: np.ndarray,
    ) -> np.ndarray:
        import jax.numpy as jnp

        assert self.dkeys is not None, "BTKeyGen first"
        B = np.asarray(ct1).shape[0]
        if isinstance(gate, (str, BinGate)):
            g = BinGate[gate] if isinstance(gate, str) else gate
            gids = np.full((B,), boot.GATE_INDEX[g], dtype=np.int32)
        else:
            gids = np.array([boot.GATE_INDEX[x] for x in gate], dtype=np.int32)
        return boot.eval_bin_gate_batch(
            self.dkeys, jnp.asarray(gids), jnp.asarray(ct1), jnp.asarray(ct2)
        )
