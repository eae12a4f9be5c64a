"""The circuit evaluator: reference ``Circuit`` API on a levelized engine.

API parity (reference src/circuit.h:54-72): ``ReadFile``, ``Reset``,
``SetInput``, ``Clock``, ``setPlaintext``, ``setEncrypted``, ``setVerify``,
``dumpNetList``, ``dumpGates``, ``dumpGateCount``, plus ``GetOutput``.

Engine redesign (batched, SURVEY.md §7.6): the reference's event-driven
wire/queue scheduler (_CircuitManager circuit.cpp:575-683) and per-gate OpenMP
tasks (_ExecuteGates circuit.cpp:685-817) are replaced by a *static* ASAP
level schedule (circuits/netlist.py): per level, all bootstrappable gates —
across every test case in the batch — run as ONE fused device program
(fhe/boot.py), and linear gates (NOT/EQW/const) run as vectorized arena ops.

Modes (circuit.cpp:819-842 parity):
  * plaintext : boolean arena only (the fast functional check).
  * encrypted : LWE ciphertext arena, batched bootstraps.
  * verify    : both; after each level, bootstrap outputs are decrypted,
    compared against the plaintext arena, counted, and repaired — the
    per-gate decrypt-compare-fix loop of gate.cpp:153-160 done per level.
"""

from __future__ import annotations

import functools
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..circuits import asm as asm_mod
from ..circuits import bristol as bristol_mod
from ..circuits.netlist import (
    BOOTSTRAP_OPS,
    LevelPlan,
    Netlist,
    Op,
    assign_ct_slots,
    levelize,
)
from ..fhe import boot, golden, lwe
from ..fhe.params import BinFHEMethod, BinGate, get_params
from ..utils.trace import LevelRecord, Trace

_OP_TO_GATE = {
    Op.AND: BinGate.AND,
    Op.OR: BinGate.OR,
    Op.NAND: BinGate.NAND,
    Op.NOR: BinGate.NOR,
    Op.XOR: BinGate.XOR,
    Op.XNOR: BinGate.XNOR,
}

# plaintext truth functions, vectorized
_PLAIN_FN = {
    int(Op.AND): lambda a, b: a & b,
    int(Op.OR): lambda a, b: a | b,
    int(Op.NAND): lambda a, b: 1 - (a & b),
    int(Op.NOR): lambda a, b: 1 - (a | b),
    int(Op.XOR): lambda a, b: a ^ b,
    int(Op.XNOR): lambda a, b: 1 - (a ^ b),
}


_N_OPS = max(int(o) for o in Op) + 1  # device bad-gate accumulator size


def _round_up_pow2(x: int, lo: int = 32) -> int:
    """Padded batch size: grows as 32*2^k (bounded compile-shape count) and
    is always a multiple of lcm(32, lo) so a dp mesh of ANY size — 6, 24, …
    — shards the batch evenly (ADVICE r2)."""
    import math

    unit = 32 * lo // math.gcd(32, lo)
    v = unit
    while v < x:
        v *= 2
    return v


class Circuit:
    """Parity class for the reference's Circuit (circuit.h:54-116).

    The constructor generates the crypto context and keys, mirroring
    circuit.cpp:45-98 (GenerateBinFHEContext + KeyGen + BTKeyGen).  Pass
    ``generate_keys=False`` for plaintext-only work to skip the expensive
    BTKeyGen.
    """

    def __init__(
        self,
        set: str = "STD128_OPT",
        method: str | BinFHEMethod = "GINX",
        seed: Optional[int] = None,
        generate_keys: bool = True,
        xor_mode: str = "native",
        verbose: bool = False,
        mesh=None,
    ):
        self.params = get_params(set) if isinstance(set, str) else set
        self.method = (
            method if isinstance(method, BinFHEMethod) else BinFHEMethod[str(method).upper()]
        )
        assert xor_mode in ("native", "compound")
        # 'compound' reproduces the reference's 3-bootstrap XOR rewrite
        # OR(AND(a,!b),AND(!a,b)) (gate.cpp:194-203); 'native' uses the
        # 1-bootstrap 2(c1-c2) XOR.
        self.xor_mode = xor_mode
        self.verbose = verbose
        if set == "TOY" or getattr(self.params, "name", "") in ("TOY", "MICRO"):
            print(f"WARNING: {self.params.name} parameters have NO security")
        from ..utils.compcache import enable_compilation_cache

        enable_compilation_cache()

        self._rng = np.random.default_rng(seed)
        self._seed_explicit = seed is not None
        self.sk: Optional[golden.LWESecretKey] = None
        self.bk: Optional[golden.BootstrapKey] = None
        self.dkeys: Optional[boot.DeviceBootKeys] = None
        # Device-mesh parallelism (the reference's whole-runtime OpenMP gate
        # parallelism, circuit.cpp:698-710, mapped to a dp[×tp] JAX mesh):
        # every level's gate×case batch is sharded over ``dp``; for GINX a
        # ``tp`` axis additionally shards the crypto contractions
        # (parallel/mesh.py).
        self.mesh = mesh
        self._sharded_gate_fn = None
        if generate_keys:
            t0 = time.time()
            self._keygen(mesh)
            if mesh is not None:
                self.setMesh(mesh)
            if verbose:
                print(f"# key generation: {time.time() - t0:.1f}s")

        self.netlist: Optional[Netlist] = None
        self.plan: Optional[LevelPlan] = None
        self.plaintext_flag = True
        self.encrypted_flag = False
        self.verify_flag = False
        self.recover_flag = False
        self._recover_explicit = False
        self.recover_threshold = self.params.q // 16

        self._plain_arena: Optional[np.ndarray] = None  # int8 [T, n_wires+1]
        self._ct_arena = None  # jnp int32 [n_ct_slots+1, T, n+1] (slot-indexed)
        self._batch = 1
        self.circuit_output: List[np.ndarray] = []
        self.gate_counts: Dict[str, int] = {}
        self.bad_gate_counts: Dict[str, int] = {}
        self.recover_counts: Dict[str, int] = {}
        self.max_phase_err = 0
        self._rec_dev = None
        self.manager_time = 0.0
        self.exec_time = 0.0
        self._done = False

    def _on_accel(self) -> bool:
        import jax

        return jax.default_backend() not in ("cpu",)

    def _hbm_gb(self) -> float:
        """Device memory in GB, as the runtime reports it."""
        import jax

        stats = jax.devices()[0].memory_stats() or {}
        if not stats.get("bytes_limit"):
            raise RuntimeError(
                f"{jax.devices()[0].device_kind} reports no memory limit"
            )
        return stats["bytes_limit"] / 2**30

    def _key_gb(self) -> float:
        """Bytes of device-resident bootstrap key material, in GB."""
        if self.dkeys is None:
            return 0.0
        import jax

        leaves = jax.tree_util.tree_leaves(self.dkeys)
        return sum(
            getattr(x, "size", 0) * getattr(x, "dtype", np.int8).itemsize
            for x in leaves
        ) / 2**30

    def _s_dev(self):
        """Device copy of the LWE secret (2 KB, uploaded once)."""
        if getattr(self, "_s_dev_arr", None) is None:
            import jax.numpy as jnp

            self._s_dev_arr = jnp.asarray(np.asarray(self.sk.s, dtype=np.int32))
        return self._s_dev_arr

    def _next_key(self):
        """Fresh jax PRNG key for device-side encryption randomness.

        Seeded from OS entropy unless the user pinned Circuit(seed=...)
        (same security rule as devkeygen._seed_words)."""
        import jax

        if getattr(self, "_jax_key", None) is None:
            if self._seed_explicit:
                root = jax.random.PRNGKey(int(self._rng.integers(0, 2**31)))
            else:
                import os as _os

                words = np.frombuffer(_os.urandom(32), dtype=np.uint32)
                root = jax.random.PRNGKey(0)
                for w in words:
                    root = jax.random.fold_in(root, int(w))
            self._jax_key = root
        self._jax_key, sub = jax.random.split(self._jax_key)
        return sub

    def _keygen(self, mesh) -> None:
        """BTKeyGen (circuit.cpp:91).  GINX and binary-base AP keys are
        generated on device from a seed — the multi-GB packed key never
        crosses the host/device boundary (fhe/devkeygen.py).  With no
        explicit seed the key derives from 256 bits of OS entropy
        (devkeygen._seed_words); an explicit Circuit(seed=k) stays
        deterministic for tests/benchmarks.  Generic-base AP (B_r > 2) has
        no device keygen and packs golden host keys."""
        from ..fhe import devkeygen

        if self.method == BinFHEMethod.AP and self.params.B_r != 2:
            self.sk = golden.lwe_keygen(self.params, self._rng)
            self.bk = golden.bootstrap_keygen(
                self.params, self.sk, self._rng, self.method
            )
            self.dkeys = boot.pack_bootstrap_key(self.bk)
            return
        kg_seed = (
            np.asarray(self._rng.integers(0, 2**32, size=8), dtype=np.uint32)
            if self._seed_explicit
            else None
        )
        keygen = (
            devkeygen.device_keygen_ap
            if self.method == BinFHEMethod.AP
            else devkeygen.device_keygen
        )
        self.sk, _z, self.dkeys = keygen(self.params, seed=kg_seed)

    # -- file loading (ReadFile parity, circuit.cpp:102-366) ----------------
    def ReadFile(self, fname: str) -> None:
        if fname.endswith(".out"):
            self.netlist = asm_mod.parse_asm(fname)
        else:
            self.netlist = bristol_mod.parse_bristol(fname)
        t0 = time.time()
        self.plan = levelize(self.netlist)
        self._make_slots()
        if self.verbose:
            s = self.plan.stats()
            print(
                f"# levelized {self.netlist.name}: depth {s['depth']}, "
                f"{s['bootstrap_gates']} bootstrap gates, "
                f"max width {s['max_level_width']}, "
                f"{self._n_ct_slots}/{self.netlist.n_wires} ct slots "
                f"({time.time() - t0:.2f}s)"
            )
        self.Reset()

    def LoadNetlist(self, nl: Netlist) -> None:
        """Direct IR entry (no file), e.g. from circuits.gen builders."""
        self.netlist = nl
        self.plan = levelize(nl)
        self._make_slots()
        self.Reset()

    def _make_slots(self) -> None:
        """Ciphertext-arena slot map (netlist.assign_ct_slots): the device
        arena is indexed by liveness-reused SLOT, not wire id — the peak
        live set is a small fraction of n_wires, which is what makes large
        case batches fit HBM next to the resident keys (VERDICT r4 #4).
        The plaintext arena stays wire-indexed (host RAM is cheap and
        verify mode reads it by wire).  OECE_WIRE_SLOTS=0 restores the
        identity map."""
        import os as _os

        if _os.environ.get("OECE_WIRE_SLOTS", "1") == "1":
            self._slot, self._n_ct_slots = assign_ct_slots(
                self.netlist, self.plan
            )
        else:
            self._slot = np.arange(self.netlist.n_wires, dtype=np.int64)
            self._n_ct_slots = self.netlist.n_wires

    # -- parallelism ---------------------------------------------------------
    def setMesh(self, mesh) -> None:
        """Attach a jax.sharding.Mesh: every level's bootstrap batch is
        sharded over its ``dp`` axis (keys replicated over dp, and the GINX
        contraction sharded over tp — parallel/mesh.py)."""
        from ..parallel import mesh as mesh_mod

        self.mesh = mesh
        if self.dkeys is not None and mesh is not None:
            self.dkeys = mesh_mod.shard_bootstrap_keys(self.dkeys, mesh)
            self._sharded_gate_fn = mesh_mod.make_sharded_gate_fn(self.dkeys, mesh)

    def _dp(self) -> int:
        return 1 if self.mesh is None else int(self.mesh.shape.get("dp", 1))

    def _gate_batch(self, gids, c1, c2):
        if self._sharded_gate_fn is not None:
            return self._sharded_gate_fn(gids, c1, c2)
        # keys pass as jit arguments: a closure would bake the multi-GB key
        # into the compiled program as a constant
        return _jit_gate_batch(self.dkeys, gids, c1, c2)

    # -- mode setters (circuit.cpp:819-842 parity) --------------------------
    def setPlaintext(self, flag: bool) -> None:
        self.plaintext_flag = bool(flag)

    def setEncrypted(self, flag: bool) -> None:
        self.encrypted_flag = bool(flag)

    def setVerify(self, flag: bool) -> None:
        """verify forces both modes on (circuit.cpp:833-840)."""
        self.verify_flag = bool(flag)
        if flag:
            self.plaintext_flag = True
            self.encrypted_flag = True

    def setRecovery(self, flag: bool, threshold: Optional[int] = None) -> None:
        """PURE-ENCRYPTED-MODE failure recovery (VERDICT r3 #7).

        The reference's analogue is the AND-gate try/catch that decrypts
        both inputs with the secret key, re-encrypts them fresh, and retries
        (gate.cpp:131-152) — a secret-key-using repair that runs WITHOUT the
        plaintext model.  Here the same trust model is used proactively:
        after each level, every bootstrap output's PHASE MARGIN is measured
        on device (decrypt with the resident secret, center the phase error
        against the decoded bit); outputs whose |error| exceeds ``threshold``
        (default q/16 — halfway to the q/8 decision boundary) are
        re-encrypted fresh from their decoded bit.  Per-op suspect counts
        and the worst observed margin accumulate on device and surface in
        ``recover_counts`` / ``max_phase_err`` — bad-gate statistics that do
        not require verify mode.

        The INPUT side (fused level path): before each level's
        bootstraps, the PREP phase (w1*c1 + w2*c2 — the value the blind
        rotation actually decides on) is margin-checked against the gate's
        own decision window (q/8 for AND-family, q/4 for XOR/XNOR, halved
        as the threshold) and drifting preps are re-encrypted fresh from
        their decoded lattice point — the batched, proactive form of the
        reference's decrypt/re-encrypt/retry (gate.cpp:131-152).  This is
        the mechanism that catches the measured native-XOR failure mode
        (NOISE.md §3): an input-side flip produces a HEALTHY-looking
        output ciphertext of the wrong bit, invisible to any output-side
        check.  Recovery is AUTO-ENABLED for pure-encrypted (non-verify)
        Clock() runs unless explicitly disabled (setRecovery(False) or
        OECE_AUTO_RECOVER=0).

        Limitation (shared with the reference): an already-flipped value
        (|error| past the window boundary) decodes wrong and is repaired
        to the WRONG value; no mechanism can detect that without the
        plaintext model.  The thresholds catch the
        drifting-but-not-yet-flipped population, which is the only
        recoverable one.
        """
        self.recover_flag = bool(flag)
        self._recover_explicit = True
        if flag:
            self.encrypted_flag = True
        self.recover_threshold = (
            int(threshold) if threshold is not None else self.params.q // 16
        )

    # -- Reset (circuit.cpp:368-419 parity) ---------------------------------
    def Reset(self) -> None:
        self._plain_arena = None
        self._ct_arena = None
        self.circuit_output = []
        self.gate_counts = {}
        self.bad_gate_counts = {}
        self.manager_time = 0.0
        self.exec_time = 0.0
        self._done = False
        self._bad_lv_dev = None  # device [depth+1, ops] per-level repairs
        self._bad_mask_dev = None  # device [depth+1, Wmax, T] per-LANE repairs
        self._cur_level = 0
        self.bad_gate_levels = {}  # level -> {op: count} (verify mode)
        # OECE_BAD_TRACE=1: exact (level, lane, case, op, wire) of every
        # verify repair — the localization the AES-anomaly hunt needs
        # (NOISE.md §3: 15 flips at "one structural position per round"
        # could previously be placed only to a LEVEL, not a gate).
        self.bad_gate_lanes: List[dict] = []
        # sequential state (DFF extension): values latched on wire dff_q,
        # cleared to 0 at Reset, carried across Clock() cycles.
        self._state_plain: Optional[np.ndarray] = None  # [T, n_dff]
        self._state_ct = None  # jnp [n_dff, T, n+1]
        self.trace: Optional[Trace] = None
        self._bootstraps_run = 0
        self._bad_dev = None  # device per-op bad-gate accumulator (verify)
        # encrypted-mode recovery stats (setRecovery): per-op re-encryption
        # counts ("HARD" = provable failures: phase outside every valid
        # decode window) and the worst phase margin seen this Clock().
        self.recover_counts: Dict[str, int] = {}
        self.max_phase_err = 0
        self._rec_dev = None  # device (counts [2, _N_OPS], max_err) accum

    # -- SetInput (circuit.cpp:455-530 parity) ------------------------------
    def SetInput(self, inputs: Sequence[np.ndarray], verbose: bool = False) -> None:
        """inputs: one bit array per declared input word, each [bits] or
        [T, bits] (T = test-case batch, an extension)."""
        assert self.netlist is not None, "ReadFile first"
        nl = self.netlist
        words = [np.atleast_2d(np.asarray(wd, dtype=np.int64)) for wd in inputs]
        assert len(words) == len(nl.inputs), (
            f"circuit declares {len(nl.inputs)} input words, got {len(words)}"
        )
        T = words[0].shape[0]
        self._batch = T
        # plaintext arena: wire-indexed (+1 dummy slot for padded gates);
        # ciphertext arena: liveness-reused SLOT-indexed (_make_slots)
        n_wire_slots = nl.n_wires + 1
        n_slots = self._n_ct_slots + 1
        if self.plaintext_flag:
            self._plain_arena = np.zeros((T, n_wire_slots), dtype=np.int8)
            for wd, wires in zip(words, nl.inputs):
                assert wd.shape == (T, len(wires)), (wd.shape, len(wires))
                self._plain_arena[:, wires] = wd
        if self.plaintext_flag and nl.n_dff:
            if self._state_plain is None:
                self._state_plain = np.zeros((T, nl.n_dff), dtype=np.int8)
            self._plain_arena[:, nl.dff_q] = self._state_plain
        if self.encrypted_flag:
            import jax.numpy as jnp

            assert self.sk is not None, "no keys"
            p = self.params
            arena_gb = n_slots * T * (p.n + 1) * 4 / 2**30
            if self._on_accel() and arena_gb * 2 + self._key_gb() > (
                0.9 * self._hbm_gb()
            ):
                # Donation transiently doubles the arena (old + new alias
                # windows), so the budget check is keys + 2x arena vs the
                # actual device memory (ADVICE r4: was a hard-coded 3 GB
                # threshold assuming a 16 GB chip).  Warn before the opaque
                # RESOURCE_EXHAUSTED.
                print(
                    f"WARNING: ciphertext arena {arena_gb:.1f} GB "
                    f"({n_slots} slots x {T} cases) + {self._key_gb():.1f} GB "
                    f"resident keys vs ~{self._hbm_gb():.0f} GB device "
                    f"memory; this can exhaust HBM — reduce the case batch "
                    f"(num_loops) or split the run",
                    flush=True,
                )
            if self._on_accel():
                # DEVICE-side arena + encryption: only the plaintext bits
                # cross the host/device boundary, never the
                # [n_slots, T, n+1] arena or the input ciphertexts.

                arena = jnp.zeros((n_slots, T, p.n + 1), jnp.int32)
                for wd, wires in zip(words, nl.inputs):
                    cts = lwe.encrypt_bits_dev(
                        self._s_dev(),
                        jnp.asarray(wd.reshape(-1), jnp.int32),
                        self._next_key(),
                        p,
                    )
                    cts = jnp.transpose(
                        cts.reshape(T, len(wires), p.n + 1), (1, 0, 2)
                    )
                    arena = arena.at[jnp.asarray(self._slot[wires])].set(cts)
                if nl.n_dff and self._state_ct is not None:
                    arena = arena.at[jnp.asarray(self._slot[nl.dff_q])].set(
                        self._state_ct
                    )
                self._ct_arena = arena
            else:
                arena = np.zeros((n_slots, T, p.n + 1), dtype=np.int32)
                for wd, wires in zip(words, nl.inputs):
                    cts = lwe.encrypt_bits(self.sk, wd.reshape(-1), self._rng)
                    arena[self._slot[wires]] = cts.reshape(
                        T, len(wires), p.n + 1
                    ).transpose(1, 0, 2)
                if nl.n_dff and self._state_ct is not None:
                    arena[self._slot[nl.dff_q]] = np.asarray(self._state_ct)
                # else: zero ciphertexts are valid noiseless encryptions of 0,
                # the correct initial flip-flop state.
                self._ct_arena = jnp.asarray(arena)

    # -- the engine ---------------------------------------------------------
    def Clock(
        self,
        verbose: bool = False,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 0,
    ) -> None:
        """Evaluate the whole circuit (the reference's Clock loop,
        circuit.cpp:532-573, with the level schedule replacing the queues).

        checkpoint_path/_every enable mid-circuit checkpointing (an aux
        subsystem the reference lacks — it only caches the compiled ``.out``
        artifact, README.md:29-30): state is saved every N levels and a
        matching Clock() call resumes from the last saved level.
        """
        assert self.plan is not None, "ReadFile first"
        if self._done:
            raise RuntimeError("Circuit already evaluated; call Reset (circuit.cpp:538-541)")
        t_start = time.time()
        exec0 = self.exec_time
        import os as _os

        if (
            self.encrypted_flag
            and not self.verify_flag
            and not self._recover_explicit
            and _os.environ.get("OECE_AUTO_RECOVER", "1") == "1"
        ):
            # pure-encrypted runs are margin-protected BY DEFAULT (the
            # reference's always-on try/catch repair, gate.cpp:131-152;
            # see setRecovery — VERDICT r4 #5 "make pure-encrypted runs
            # safe by default")
            self.recover_flag = True
        mode = (
            "verify"
            if self.verify_flag
            else "encrypted" if self.encrypted_flag else "plaintext"
        )
        self.trace = Trace(circuit=self.netlist.name, mode=mode)
        self.trace.begin()
        if self.verify_flag and self._bad_lv_dev is None:
            import jax.numpy as jnp

            # device [depth+1, ops] accumulator: localizes verify repairs
            # by level (fetched ONCE at Clock end; the r4 AES run's "15
            # repaired XOR" had no way to say WHERE they happened)
            self._bad_lv_dev = jnp.zeros(
                (self.plan.depth + 1, _N_OPS), jnp.int32
            )
        import os as _os_bt

        if (
            self.verify_flag
            and self._bad_mask_dev is None
            and _os_bt.environ.get("OECE_BAD_TRACE", "0") == "1"
        ):
            import jax.numpy as jnp

            # lane-resolution repair trace: int8 cube covering every level's
            # padded dispatch lanes (a few MB even for sha256; fetched once)
            T = self._batch
            CW = max(32, 2048 // max(T, 1))
            wmax = 32
            for level in self.plan.levels:
                W = len(level["boot_op"])
                if W == 0:
                    continue
                last0 = (max(W - 1, 0) // CW) * CW
                wp = 32
                while wp < min(CW, W - last0):
                    wp *= 2
                wmax = max(wmax, last0 + wp)
            self._bad_mask_dev = jnp.zeros(
                (self.plan.depth + 1, wmax, self._batch), jnp.int8
            )
        start_lv = 0
        if checkpoint_path is not None:
            from . import checkpoint as ckpt_mod

            start_lv = ckpt_mod.maybe_resume(self, checkpoint_path)
        for lv, level in enumerate(self.plan.levels):
            if lv < start_lv:
                continue
            t0 = time.time()
            self._cur_level = lv
            b0 = self._bootstraps_run
            self._run_level(level)
            dt = time.time() - t0
            self.exec_time += dt
            self.trace.add(
                LevelRecord(
                    level=lv,
                    boot_gates=len(level["boot_op"]),
                    linear_gates=len(level["lin_op"]),
                    batch=self._batch,
                    wall_s=dt,
                    bootstraps=self._bootstraps_run - b0,
                )
            )
            if (
                checkpoint_path is not None
                and checkpoint_every > 0
                and (lv + 1) % checkpoint_every == 0
                and lv + 1 < self.plan.depth
            ):
                from . import checkpoint as ckpt_mod

                ckpt_mod.save(self, checkpoint_path, lv + 1)
            if (self.verbose or verbose) and self.plan.depth > 1:
                print(
                    f"\rProcessing level {lv + 1} of {self.plan.depth}",
                    end="" if lv + 1 < self.plan.depth else "\n",
                    flush=True,
                )
        if checkpoint_path is not None:
            # a checkpoint is crash-recovery state for THIS evaluation; once
            # it completes, a stale file must not hijack the next Clock()
            # (sequential circuits re-Clock with the same fingerprint).
            import os as _os

            if _os.path.exists(checkpoint_path):
                _os.remove(checkpoint_path)
        self._flush_bad_dev()
        self._flush_rec_dev()
        self._collect_outputs()
        nl = self.netlist
        if nl.n_dff:  # latch D -> state; circuit stays clockable (sequential)
            if self.plaintext_flag:
                self._state_plain = self._plain_arena[:, nl.dff_d].copy()
            if self.encrypted_flag:
                self._state_ct = self._ct_arena[self._slot[nl.dff_d]]
        self.trace.end()
        total = time.time() - t_start
        self.manager_time += total - (self.exec_time - exec0)
        self._done = nl.n_dff == 0
        if self.verbose or verbose:
            eff = 100.0 * (self.exec_time - exec0) / total if total > 0 else 0.0
            print(f"### Total time {total * 1e3:.1f} msec, efficiency {eff:.1f}%")

    def _run_level(self, level: dict) -> None:
        self._run_level_boot(level)
        self._run_level_linear(level)

    def _run_level_boot(self, level: dict) -> None:
        ops = level["boot_op"]
        W = len(ops)
        if W == 0:
            return
        in0, in1, outw = level["boot_in0"], level["boot_in1"], level["boot_out"]
        # gate-count accounting (circuit.cpp:722-749 parity)
        for o in ops:
            name = Op(int(o)).name
            self.gate_counts[name] = self.gate_counts.get(name, 0) + self._batch

        if self.plaintext_flag:
            pa = self._plain_arena
            a = pa[:, in0].astype(np.int64)
            b = pa[:, in1].astype(np.int64)
            res = np.empty_like(a)
            for o in np.unique(ops):
                m = ops == o
                res[:, m] = _PLAIN_FN[int(o)](a[:, m], b[:, m])
            pa[:, outw] = res

        if self.encrypted_flag:
            self._run_level_boot_encrypted(ops, in0, in1, outw)

    def _use_level_jit(self) -> bool:
        """One fused jitted device program per level chunk (gather ->
        bootstrap -> verify-fix -> scatter), with index arrays padded to a
        bounded set of bucket shapes.

        This is the accelerator path: the eager per-level glue below has
        per-level-unique array shapes, and each unique shape is a fresh XLA
        compile — a 5,000-level circuit would spend most of its time
        compiling trivial gathers.  The fused path compiles O(log max_width)
        programs total and dispatches ONCE per level chunk.
        """
        import os as _os

        v = _os.environ.get("OECE_LEVEL_JIT")
        if v is not None:
            return v == "1"
        return self._on_accel() and self._sharded_gate_fn is None

    def _run_level_boot_encrypted(self, ops, in0, in1, outw) -> None:
        import jax.numpy as jnp

        T = self._batch
        W = len(ops)
        if self.xor_mode == "compound":
            # reference parity: XOR/XNOR -> OR(AND(a,!b),AND(!a,b)) with 3
            # bootstraps (gate.cpp:194-203).  Implemented as sub-levels.
            xm = np.isin(ops, (int(Op.XOR), int(Op.XNOR)))
            if np.any(xm):
                self._run_compound_xor(ops[xm], in0[xm], in1[xm], outw[xm])
                ops, in0, in1, outw = ops[~xm], in0[~xm], in1[~xm], outw[~xm]
                W = len(ops)
                if W == 0:
                    return
        gate_ids = np.array(
            [boot.GATE_INDEX[_OP_TO_GATE[Op(int(o))]] for o in ops], dtype=np.int32
        )
        if self._use_level_jit():
            self._run_level_boot_fused(ops, gate_ids, in0, in1, outw)
            return
        B = W * T
        Bpad = _round_up_pow2(B, lo=self._dp())
        arena = self._ct_arena
        c1 = arena[self._slot[in0]].reshape(B, -1)
        c2 = arena[self._slot[in1]].reshape(B, -1)
        gids = jnp.asarray(np.repeat(gate_ids, T))
        if Bpad != B:
            pad = Bpad - B
            c1 = jnp.concatenate([c1, jnp.zeros((pad, c1.shape[1]), c1.dtype)])
            c2 = jnp.concatenate([c2, jnp.zeros((pad, c2.shape[1]), c2.dtype)])
            gids = jnp.concatenate([gids, jnp.zeros((pad,), gids.dtype)])
        out = self._gate_batch(gids, c1, c2)[:B]
        self._bootstraps_run += B
        out = out.reshape(W, T, -1)

        if self.verify_flag:
            out = self._verify_fix(ops, outw, out)
        elif self.recover_flag:
            out = self._recover_fix(ops, out)
        self._ct_arena = arena.at[self._slot[outw]].set(out)

    def _recover_fix(self, ops, out):
        """setRecovery eager path: OUTPUT margin-measure + re-encrypt
        suspects (host/sharded backends; the fused level path additionally
        repairs drifting PREPS input-side — see _fused_level_fn)."""
        import jax.numpy as jnp

        q = self.params.q
        W, T = out.shape[0], self._batch
        cts = np.asarray(out).reshape(W * T, -1)
        # same decode-window/centering semantics as the fused level path
        bitn_d, err_d = lwe.phase_margin_dev(
            np.asarray(self.sk.s, dtype=np.int64), cts, q
        )
        bitn = np.asarray(bitn_d).astype(np.int64)
        aerr = np.abs(np.asarray(err_d)).reshape(W, T)
        self.max_phase_err = max(
            self.max_phase_err, int(aerr.max()) if aerr.size else 0
        )
        suspect = aerr >= self.recover_threshold
        nhard = int((aerr >= q // 8).sum())
        if nhard:
            self.recover_counts["HARD"] = (
                self.recover_counts.get("HARD", 0) + nhard
            )
        if np.any(suspect):
            for o in np.unique(ops):
                cnt = int(suspect[ops == o].sum())
                if cnt:
                    name = Op(int(o)).name
                    self.recover_counts[name] = (
                        self.recover_counts.get(name, 0) + cnt
                    )
            fixed = lwe.encrypt_bits(self.sk, bitn, self._rng).reshape(W, T, -1)
            out = jnp.where(
                jnp.asarray(suspect)[:, :, None], jnp.asarray(fixed), out
            )
        return out

    def _run_level_boot_fused(self, ops, gate_ids, in0, in1, outw) -> None:
        """Accelerator path: evaluate a level's bootstrap gates as ONE fused jitted
        program per chunk — gather operands from the arena, bootstrap,
        verify-fix (decrypt/compare/repair on device), scatter results —
        with all index arrays padded to pow2 buckets so the whole circuit
        compiles O(log max_width) programs (see _use_level_jit).

        Padding protocol: index arrays pad with the dummy wire slot
        (index n_wires); padded lanes read whatever the dummy slot holds,
        their bootstrap results are scattered back onto the dummy slot, and
        verify masks them out — dummy content is don't-care by construction.
        """
        import jax.numpy as jnp

        T = self._batch
        p = self.params
        dummy = self._ct_arena.shape[0] - 1  # the padded-gate slot
        W = len(ops)
        # gates per chunk: dispatch batches of up to B = 2048 bootstraps
        # (PERF.md: gate-batch rates at B = 128 and 2048)
        CW = max(32, 2048 // max(T, 1))
        for k0 in range(0, W, CW):
            w = min(CW, W - k0)
            Wpad = 32
            while Wpad < w:
                Wpad *= 2
            sl = slice(k0, k0 + w)
            # device index arrays are SLOT-mapped; `want` below stays
            # wire-indexed (the plaintext arena is per-wire)
            i0 = np.full(Wpad, dummy, np.int32)
            i0[:w] = self._slot[in0[sl]]
            i1 = np.full(Wpad, dummy, np.int32)
            i1[:w] = self._slot[in1[sl]]
            ow = np.full(Wpad, dummy, np.int32)
            ow[:w] = self._slot[outw[sl]]
            gg = np.zeros(Wpad, np.int32)
            gg[:w] = gate_ids[sl]
            ov = np.zeros(Wpad, np.int32)
            ov[:w] = ops[sl]
            recover = self.recover_flag and not self.verify_flag
            if self.verify_flag:
                want = np.zeros((Wpad, T), np.int32)
                want[:w] = self._plain_arena[:, outw[sl]].T
                key = self._next_key()
                if self._bad_dev is None:
                    self._bad_dev = jnp.zeros((_N_OPS,), jnp.int32)
                bad = self._bad_dev
                bad_lv = self._bad_lv_dev
            else:
                # the jitted fn ignores `want` outside verify: ship a
                # 4-byte placeholder, not a (Wpad, T) zeros upload per chunk
                want = np.zeros((1, 1), np.int32)
                key = self._next_key() if recover else self._zero_key()
                bad = jnp.zeros((_N_OPS,), jnp.int32)
                bad_lv = jnp.zeros((1, _N_OPS), jnp.int32)
            if recover and self._rec_dev is None:
                self._rec_dev = (
                    jnp.zeros((3, _N_OPS), jnp.int32), jnp.zeros((), jnp.int32)
                )
            rc, rm = self._rec_dev if self._rec_dev is not None else (
                jnp.zeros((3, _N_OPS), jnp.int32), jnp.zeros((), jnp.int32)
            )
            trace_bad = self.verify_flag and self._bad_mask_dev is not None
            fn = _fused_level_fn(
                T, Wpad, self.verify_flag, p.n, p.q, recover,
                self.recover_threshold, trace_bad,
            )
            if trace_bad:
                (
                    self._ct_arena, bad, bad_lv, rc, rm, self._bad_mask_dev,
                ) = fn(
                    self.dkeys, self._s_dev(), self._ct_arena,
                    jnp.asarray(i0), jnp.asarray(i1), jnp.asarray(ow),
                    jnp.asarray(gg), jnp.asarray(ov), jnp.asarray(want),
                    key, bad, bad_lv, jnp.int32(self._cur_level), rc, rm,
                    self._bad_mask_dev, jnp.int32(k0),
                )
            else:
                self._ct_arena, bad, bad_lv, rc, rm = fn(
                    self.dkeys, self._s_dev(), self._ct_arena,
                    jnp.asarray(i0), jnp.asarray(i1), jnp.asarray(ow),
                    jnp.asarray(gg), jnp.asarray(ov), jnp.asarray(want), key,
                    bad, bad_lv, jnp.int32(self._cur_level), rc, rm,
                )
            if self.verify_flag:
                self._bad_dev = bad
                self._bad_lv_dev = bad_lv
            if recover:
                self._rec_dev = (rc, rm)
            self._bootstraps_run += w * T

    def _zero_key(self):
        import jax

        if getattr(self, "_zero_key_arr", None) is None:
            self._zero_key_arr = jax.random.PRNGKey(0)
        return self._zero_key_arr

    def _run_compound_xor(self, ops, in0, in1, outw) -> None:
        """3-bootstrap XOR rewrite, vectorized: t1=AND(a,!b), t2=AND(!a,b),
        out=OR(t1,t2); XNOR adds a final NOT (linear)."""
        import jax.numpy as jnp

        T = self._batch
        arena = self._ct_arena
        q = self.params.q
        W = len(ops)
        B = W * T
        a = arena[self._slot[in0]].reshape(B, -1)
        b = arena[self._slot[in1]].reshape(B, -1)
        na = lwe.eval_not_batch(a, q)
        nb = lwe.eval_not_batch(b, q)
        and_id = boot.GATE_INDEX[BinGate.AND]
        or_id = boot.GATE_INDEX[BinGate.OR]
        both_c1 = jnp.concatenate([a, na])
        both_c2 = jnp.concatenate([nb, b])
        Bp = _round_up_pow2(2 * B, lo=self._dp())
        gids = jnp.full((Bp,), and_id, dtype=jnp.int32)
        if Bp != 2 * B:
            both_c1 = jnp.concatenate(
                [both_c1, jnp.zeros((Bp - 2 * B, both_c1.shape[1]), both_c1.dtype)]
            )
            both_c2 = jnp.concatenate(
                [both_c2, jnp.zeros((Bp - 2 * B, both_c2.shape[1]), both_c2.dtype)]
            )
        ands = self._gate_batch(gids, both_c1, both_c2)[: 2 * B]
        t1, t2 = ands[:B], ands[B:]
        Bp = _round_up_pow2(B, lo=self._dp())
        gids = jnp.full((Bp,), or_id, dtype=jnp.int32)
        if Bp != B:
            t1 = jnp.concatenate([t1, jnp.zeros((Bp - B, t1.shape[1]), t1.dtype)])
            t2 = jnp.concatenate([t2, jnp.zeros((Bp - B, t2.shape[1]), t2.dtype)])
        out = self._gate_batch(gids, t1, t2)[:B]
        self._bootstraps_run += 3 * B
        # XNOR: final linear NOT
        xnor_m = np.repeat(ops == int(Op.XNOR), T)
        if np.any(xnor_m):
            out_not = lwe.eval_not_batch(out, q)
            out = jnp.where(jnp.asarray(xnor_m)[:, None], out_not, out)
        out = out.reshape(W, T, -1)
        if self.verify_flag:
            out = self._verify_fix(ops, outw, out)
        elif self.recover_flag:
            out = self._recover_fix(ops, out)
        self._ct_arena = arena.at[self._slot[outw]].set(out)
        for o in ops:  # extra bootstrap accounting for the rewrite
            self.gate_counts["XOR_BOOTSTRAPS"] = (
                self.gate_counts.get("XOR_BOOTSTRAPS", 0) + 3 * self._batch
            )

    def _verify_fix(self, ops, outw, out):
        """Per-level decrypt-compare-fix (gate.cpp:153-160 parity).

        On an accelerator the whole check runs ON DEVICE (decrypt, compare,
        re-encrypt repairs) with per-op bad counts accumulated in a device
        vector and fetched once at Clock() end — a per-level host fetch
        would serialize the level pipeline.  The reference's per-gate "Bad X fixing" lines consequently print at the
        end of the evaluation in this mode (CPU backend keeps the per-level
        prints)."""
        import jax.numpy as jnp

        T = self._batch
        W = len(ops)
        want_np = self._plain_arena[:, outw].T.astype(np.int32)  # [W, T]
        if self._on_accel():
            p = self.params
            want = jnp.asarray(want_np)
            got = lwe.decrypt_bits_dev(self._s_dev(), out, p.q)  # [W, T]
            bad = got != want
            fixed = lwe.encrypt_bits_dev(
                self._s_dev(), want.reshape(-1), self._next_key(), p
            ).reshape(W, T, -1)
            out = jnp.where(bad[:, :, None], fixed, out)
            if self._bad_dev is None:
                self._bad_dev = jnp.zeros((_N_OPS,), jnp.int32)
            per_op = bad.sum(axis=1).astype(jnp.int32)
            self._bad_dev = self._bad_dev.at[
                jnp.asarray(ops.astype(np.int32))
            ].add(per_op)
            if self._bad_lv_dev is not None:
                self._bad_lv_dev = self._bad_lv_dev.at[
                    self._cur_level, jnp.asarray(ops.astype(np.int32))
                ].add(per_op)
            if self._bad_mask_dev is not None:
                # lanes index this dispatch's gate order (= the level's boot
                # order on the native path; the compound-XOR subset order on
                # the xor_mode="compound" rewrite path)
                self._bad_mask_dev = self._bad_mask_dev.at[
                    self._cur_level, :W
                ].max(bad.astype(jnp.int8))
            return out
        got = lwe.decrypt_bits(self.sk, np.asarray(out).reshape(W * T, -1)).reshape(W, T)
        bad = got != want_np
        if np.any(bad) and self._bad_mask_dev is not None:
            # host backend: record lanes directly (no device cube round-trip)
            for lane, case in zip(*np.nonzero(bad)):
                self.bad_gate_lanes.append({
                    "level": self._cur_level, "lane": int(lane),
                    "case": int(case), "op": Op(int(ops[lane])).name,
                    "wire": int(outw[lane]),
                })
        if np.any(bad):
            nbad = int(bad.sum())
            for o in np.unique(ops):
                name = Op(int(o)).name
                cnt = int(bad[ops == o].sum()) if ops.ndim else nbad
                self.bad_gate_counts[name] = self.bad_gate_counts.get(name, 0) + cnt
                if cnt:
                    self.bad_gate_levels.setdefault(self._cur_level, {})[
                        name
                    ] = self.bad_gate_levels.get(self._cur_level, {}).get(
                        name, 0
                    ) + cnt
                print(f"Bad {name} fixing")
            fixed = lwe.encrypt_bits(self.sk, want_np.reshape(-1), self._rng).reshape(
                W, T, -1
            )
            out = jnp.where(jnp.asarray(bad)[:, :, None], jnp.asarray(fixed), out)
        return out

    def _flush_bad_dev(self) -> None:
        """Fetch the device bad-gate accumulators (one tiny transfer)."""
        if getattr(self, "_bad_mask_dev", None) is not None:
            cube = np.asarray(self._bad_mask_dev)
            self._bad_mask_dev = None
            for lv, lane, case in zip(*np.nonzero(cube)):
                lv, lane, case = int(lv), int(lane), int(case)
                rec = {"level": lv, "lane": lane, "case": case}
                level = self.plan.levels[lv] if lv < len(self.plan.levels) else None
                if level is not None and lane < len(level["boot_op"]):
                    rec["op"] = Op(int(level["boot_op"][lane])).name
                    rec["wire"] = int(level["boot_out"][lane])
                self.bad_gate_lanes.append(rec)
            if self.bad_gate_lanes:
                print(f"bad gate lanes: {self.bad_gate_lanes}")
        if getattr(self, "_bad_lv_dev", None) is not None:
            lv_counts = np.asarray(self._bad_lv_dev)
            self._bad_lv_dev = None
            for lv, o in zip(*np.nonzero(lv_counts)):
                name = Op(int(o)).name
                d = self.bad_gate_levels.setdefault(int(lv), {})
                d[name] = d.get(name, 0) + int(lv_counts[lv, o])
            if self.bad_gate_levels:
                print(f"bad gates by level: {self.bad_gate_levels}")
        if getattr(self, "_bad_dev", None) is None:
            return
        counts = np.asarray(self._bad_dev)
        self._bad_dev = None
        for o in np.nonzero(counts)[0]:
            name = Op(int(o)).name
            self.bad_gate_counts[name] = self.bad_gate_counts.get(name, 0) + int(
                counts[o]
            )
            print(f"Bad {name} fixing (x{int(counts[o])})")

    def _flush_rec_dev(self) -> None:
        """Fetch the device recovery accumulators (one tiny transfer)."""
        if getattr(self, "_rec_dev", None) is None:
            return
        cnts, mx = self._rec_dev
        cnts = np.asarray(cnts)
        self.max_phase_err = max(self.max_phase_err, int(np.asarray(mx)))
        self._rec_dev = None
        for o in np.nonzero(cnts[0])[0]:
            name = Op(int(o)).name
            self.recover_counts[name] = self.recover_counts.get(name, 0) + int(
                cnts[0, o]
            )
        nhard = int(cnts[1].sum())
        if nhard:
            self.recover_counts["HARD"] = (
                self.recover_counts.get("HARD", 0) + nhard
            )
        if cnts.shape[0] > 2:  # input-side prep repairs (round 5)
            for o in np.nonzero(cnts[2])[0]:
                name = f"IN_{Op(int(o)).name}"
                self.recover_counts[name] = self.recover_counts.get(
                    name, 0
                ) + int(cnts[2, o])
        if self.recover_counts:
            print(f"recovery: re-encrypted {self.recover_counts}")

    def _run_level_linear(self, level: dict) -> None:
        ops, in0, outw = level["lin_op"], level["lin_in0"], level["lin_out"]
        if len(ops) == 0:
            return
        q = self.params.q
        for o in np.unique(ops):
            name = Op(int(o)).name
            cnt = int((ops == o).sum())
            self.gate_counts[name] = self.gate_counts.get(name, 0) + cnt * self._batch
        # linear chains may feed each other within the level (rank order is
        # preserved by the levelizer), so apply sequential passes per rank by
        # processing in stored order but with vectorized segments per op run.
        if self.plaintext_flag:
            pa = self._plain_arena
            for o, i, w in zip(ops, in0, outw):
                oo = int(o)
                if oo == int(Op.NOT):
                    pa[:, w] = 1 - pa[:, i]
                elif oo == int(Op.EQW):
                    pa[:, w] = pa[:, i]
                elif oo == int(Op.EQ0):
                    pa[:, w] = 0
                else:
                    pa[:, w] = 1
        if self.encrypted_flag:
            import jax.numpy as jnp

            use_jit = self._use_level_jit()
            dummy = self._ct_arena.shape[0] - 1
            arena = self._ct_arena
            # segment into runs of the same op that don't read their own
            # outputs; rank ordering guarantees correctness of sequential runs
            k = 0
            G = len(ops)
            while k < G:
                o = int(ops[k])
                j = k + 1
                while j < G and int(ops[j]) == o:
                    j += 1
                idx_in = self._slot[in0[k:j]]
                idx_out = self._slot[outw[k:j]]
                if use_jit:
                    # fixed-bucket jitted segment (see _use_level_jit):
                    # pad indices with the dummy slot, ONE dispatch
                    L = 32
                    while L < j - k:
                        L *= 2
                    ii = np.full(L, dummy, np.int32)
                    ii[: j - k] = idx_in
                    oo = np.full(L, dummy, np.int32)
                    oo[: j - k] = idx_out
                    kind = (
                        "not" if o == int(Op.NOT)
                        else "eqw" if o == int(Op.EQW)
                        else "const"
                    )
                    bit = 1 if o == int(Op.EQ1) else 0
                    fn = _lin_level_fn(
                        kind, L, self._batch, self.params.n, q, bit
                    )
                    arena = fn(arena, jnp.asarray(ii), jnp.asarray(oo))
                    k = j
                    continue
                if o == int(Op.NOT):
                    vals = lwe.eval_not_batch(arena[idx_in], q)
                elif o == int(Op.EQW):
                    vals = arena[idx_in]
                else:
                    bit = 1 if o == int(Op.EQ1) else 0
                    # built on device (no host->device arena traffic)
                    vals = (
                        jnp.zeros(
                            (len(idx_in), self._batch, self.params.n + 1),
                            jnp.int32,
                        )
                        .at[..., -1]
                        .set(bit * (q // 4))
                    )
                arena = arena.at[idx_out].set(vals)
                k = j
            self._ct_arena = arena

    # -- outputs ------------------------------------------------------------
    def _collect_outputs(self) -> None:
        nl = self.netlist
        outs = []
        if self.encrypted_flag:
            for wires in nl.outputs:
                if self._on_accel():
                    # decrypt ON DEVICE, fetch only the bits (KBs, not the
                    # [bits, T, n+1] ciphertexts)
                    bits = np.asarray(
                        lwe.decrypt_bits_dev(
                            self._s_dev(),
                            self._ct_arena[self._slot[wires]],
                            self.params.q,
                        )
                    ).astype(np.int32)
                else:
                    cts = np.asarray(
                        self._ct_arena[self._slot[wires]]
                    )  # [bits, T, n+1]
                    bits = lwe.decrypt_bits(
                        self.sk, cts.reshape(-1, cts.shape[-1])
                    ).reshape(len(wires), self._batch)
                outs.append(bits.T)  # [T, bits]
                if self.verify_flag:
                    want = self._plain_arena[:, wires]
                    bad = int((bits.T != want).sum())
                    if bad:
                        self.bad_gate_counts["OUTPUT"] = (
                            self.bad_gate_counts.get("OUTPUT", 0) + bad
                        )
                        print(f"Bad OUTPUT {bad}")
        elif self.plaintext_flag:
            for wires in nl.outputs:
                outs.append(self._plain_arena[:, wires].astype(np.int32))
        self.circuit_output = outs

    def GetOutput(self) -> List[np.ndarray]:
        """Output bit arrays, one [T, bits] per output word."""
        return self.circuit_output

    # -- dumps (circuit.cpp:844-873 parity) ---------------------------------
    def dumpNetList(self) -> None:
        """Full per-wire fanout listing (circuit.cpp:844-854 parity: one
        line per wire, the wire's name followed by the gates it feeds).
        Wires are integer ids here; gates are named ``g<k>`` by file order,
        mirroring the reference's generated gate names."""
        nl = self.netlist
        print("Netlist ")
        print(f"# {nl.name}: {nl.n_wires} wires, {nl.n_gates} gates, "
              f"inputs {nl.input_bits} bits, outputs {nl.output_bits} bits")
        fan: Dict[int, List[int]] = {}
        for k in range(nl.n_gates):
            fan.setdefault(int(nl.in0[k]), []).append(k)
            if nl.in1[k] != nl.in0[k]:
                fan.setdefault(int(nl.in1[k]), []).append(k)
        for w in sorted(fan):
            print(f"w{w} " + " ".join(f"g{k}" for k in fan[w]))

    def dumpGates(self) -> None:
        nl = self.netlist
        for k in range(nl.n_gates):
            print(
                f"  {Op(int(nl.op[k])).name} w{int(nl.in0[k])}, w{int(nl.in1[k])}"
                f" -> w{int(nl.out[k])}"
            )

    def dumpGateCount(self) -> None:
        for name, cnt in sorted(self.gate_counts.items()):
            print(f"  {name}: {cnt}")
        if self.bad_gate_counts:
            print(f"  bad gates fixed: {self.bad_gate_counts}")




@functools.lru_cache(maxsize=1)
def _gate_batch_jit():
    import jax

    return jax.jit(boot.eval_bin_gate_batch)


def _jit_gate_batch(dkeys, gids, c1, c2):
    return _gate_batch_jit()(dkeys, gids, c1, c2)


@functools.lru_cache(maxsize=None)
def _fused_level_fn(
    T: int, Wpad: int, verify: bool, n: int, q: int,
    recover: bool = False, thresh: int = 0, trace_bad: bool = False,
):
    """Jitted fused level program (see Circuit._run_level_boot_fused).

    fn(dkeys, s_dev, arena, in0, in1, outw, gids, opsv, want, key,
       bad_acc, bad_lv, lv, rec_cnts, rec_max)
      -> (arena', bad_acc', bad_lv', rec_cnts', rec_max')

    arena is DONATED (the [n_slots, T, n+1] ciphertext arena updates in
    place on device — no per-level copy).  ``bad_lv`` is a device
    [depth+1, ops] accumulator localizing verify repairs by level ``lv``
    (a placeholder [1, ops] outside verify).  ``recover`` applies the
    margin-based re-encryption of setRecovery (pure encrypted mode)."""
    import jax
    import jax.numpy as jnp

    def fn(dkeys, s_dev, arena, in0, in1, outw, gids, opsv, want, key,
           bad_acc, bad_lv, lv, rec_cnts, rec_max,
           bad_mask=None, k0=None):
        c1 = arena[in0].reshape(Wpad * T, n + 1)
        c2 = arena[in1].reshape(Wpad * T, n + 1)
        g = jnp.repeat(gids, T)
        valid = (outw < arena.shape[0] - 1)[:, None]  # mask padded lanes
        prep = boot.prepare_gates(c1, c2, g, q)
        if recover:
            # INPUT-side margin repair (setRecovery round-5 extension):
            # the prep phase is what the blind rotation decides on, and an
            # out-of-window prep yields a healthy-LOOKING ciphertext of
            # the wrong bit — undetectable on the output side.  Snap each
            # drifting prep to its nearest lattice point (multiples of
            # q/4) and re-encrypt it fresh (gate.cpp:131-152, batched).
            key, key_in = jax.random.split(key)
            pphase = (
                prep[:, n] - jnp.einsum("bi,i->b", prep[:, :n], s_dev)
            ) % q
            quarters = ((pphase + q // 8) // (q // 4)) % 4
            err_in = (pphase + q // 8) % (q // 4) - q // 8
            # per-gate decision margin on the prep: XOR/XNOR windows are
            # q/4 wide to each side, AND-family q/8; threshold = half
            is_xor = (g == 4) | (g == 5)
            thr = jnp.where(is_xor, q // 8, q // 16)
            suspect_in = (jnp.abs(err_in) >= thr) & jnp.repeat(
                valid[:, 0], T
            )
            fixed_in = lwe.encrypt_bits_dev(s_dev, quarters, key_in, dkeys.params)
            prep = jnp.where(suspect_in[:, None], fixed_in, prep)
            rec_cnts = rec_cnts.at[2, jnp.repeat(opsv, T)].add(
                suspect_in.astype(jnp.int32)
            )
        out = boot.bootstrap_batch(prep, g, dkeys).reshape(Wpad, T, n + 1)
        if verify:
            got = lwe.decrypt_bits_dev(s_dev, out, q)  # [Wpad, T]
            bad = (got != want) & valid
            fixed = lwe.encrypt_bits_dev(
                s_dev, want.reshape(-1), key, dkeys.params
            ).reshape(Wpad, T, n + 1)
            out = jnp.where(bad[:, :, None], fixed, out)
            per_op = bad.sum(axis=1).astype(jnp.int32)
            bad_acc = bad_acc.at[opsv].add(per_op)
            bad_lv = bad_lv.at[lv, opsv].add(per_op)
            if trace_bad:
                rows = k0 + jnp.arange(Wpad)[:, None]
                cols = jnp.arange(T)[None, :]
                bad_mask = bad_mask.at[lv, rows, cols].max(
                    bad.astype(jnp.int8)
                )
        elif recover:
            bitn, err = lwe.phase_margin_dev(s_dev, out, q)
            aerr = jnp.abs(err)
            suspect = (aerr >= thresh) & valid
            hard = (aerr >= q // 8) & valid
            fixed = lwe.encrypt_bits_dev(
                s_dev, bitn.reshape(-1), key, dkeys.params
            ).reshape(Wpad, T, n + 1)
            out = jnp.where(suspect[:, :, None], fixed, out)
            rec_cnts = rec_cnts.at[0, opsv].add(
                suspect.sum(axis=1).astype(jnp.int32)
            )
            rec_cnts = rec_cnts.at[1, opsv].add(
                hard.sum(axis=1).astype(jnp.int32)
            )
            rec_max = jnp.maximum(
                rec_max, jnp.max(jnp.where(valid, aerr, 0)).astype(jnp.int32)
            )
        arena = arena.at[outw].set(out)
        if trace_bad:
            return arena, bad_acc, bad_lv, rec_cnts, rec_max, bad_mask
        return arena, bad_acc, bad_lv, rec_cnts, rec_max

    if trace_bad:
        return jax.jit(fn, donate_argnums=(2, 15))
    return jax.jit(fn, donate_argnums=(2,))


@functools.lru_cache(maxsize=None)
def _lin_level_fn(kind: str, L: int, T: int, n: int, q: int, bit: int = 0):
    """Jitted linear-gate segment (NOT / EQW / EQ-const) with donated arena;
    index arrays pad with the dummy slot like _fused_level_fn."""
    import jax
    import jax.numpy as jnp

    def fn(arena, idx_in, idx_out):
        if kind == "not":
            vals = lwe.eval_not_batch(arena[idx_in], q)
        elif kind == "eqw":
            vals = arena[idx_in]
        else:  # const
            vals = (
                jnp.zeros((L, T, n + 1), jnp.int32)
                .at[..., -1]
                .set(bit * (q // 4))
            )
        return arena.at[idx_out].set(vals)

    return jax.jit(fn, donate_argnums=(0,))
