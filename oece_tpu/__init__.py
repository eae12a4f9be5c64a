"""oece_tpu — an encrypted boolean-circuit evaluator in JAX.

A from-scratch JAX re-design of the capabilities of
``openfheorg/openfhe-boolean-circuit-evaluator``, including the full FHEW/TFHE cryptographic layer that the
reference outsources to OpenFHE's ``binfhe`` module.

Subpackages
-----------
fhe      : the cryptographic layer (LWE/RLWE/RGSW, GINX/AP bootstrapping,
           negacyclic NTT, key/mod switching) as batched JAX programs
           plus an exact NumPy golden model.
circuits : Bristol-format parsers, analyzer/assembler (compiler), levelizer,
           and a circuit-generator DSL.
runtime  : the levelized batched circuit evaluator (plaintext / encrypted /
           verify modes) with API parity to the reference's ``Circuit``.
parallel : device-mesh sharding of gate batches and keys (dp/tp).
harness  : golden-model test harnesses and TB_* CLI entry points.
utils    : bit-twiddling and CLI helpers mirroring the reference's utils.
"""

__version__ = "0.1.0"
