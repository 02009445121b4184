"""node-fhe-accelerate-tpu, PyTorch/CUDA port.

The JAX package ``node_fhe_accelerate_tpu`` is the reference; this package
reproduces, bit for bit in PyTorch:

* its TFHE programmable bootstrap, with the blind-rotate CMux step, the
  whole ladder and the negacyclic NTTs running as hand-written CUDA kernels
  for Hopper (``csrc/cmux_step.cu``, ``ladder_*.cu``, ``ntt.cu``);
* its engine's default ``ext_backend="auto"``, which races the int8
  backends once per batch shape on the card (``utils/dispatch.py``);
* its RLWE (BFV) ballot stack: parameter sets and security validation
  (``core/params.py``, ``security.py``), the ring ``core/poly.py`` (K6-K8
  on the card), keys, encryption with the exact t/q-rescaled multiply
  (``core/keys.py``, ``encrypt.py``, ``bfv_mul.py``), threshold decryption
  and proofs of correct encryption (``core/threshold.py``,
  ``verifiable.py``), and the polynomial codec with its native LZ4
  (``core/serializer.py``, ``native/``);
* the same stack over a whole RNS moduli chain (``core/rns.py``) and
  leveled CKKS (``core/ckks.py``), with the public entry of the JAX package:
  ``api/engine.py`` ``FHEEngine``, ``api/context.py`` ``FHEContext``,
  ``api/ckks_context.py`` ``CkksContext``, the tally stream, audit trail
  and fraud detection (``api/tally.py``, ``audit.py``, ``fraud.py``),
  chunked and streamed ciphertext processing (``core/streaming.py``,
  ``streams.py``) and speculative multi-LUT bootstrapping
  (``core/speculative.py``);
* its ZK field and curve path: the BN254/BLS12-381 digit-plane fields
  (``zk/field.py``, ``field2.py``), G1 with the Pippenger MSM
  (``zk/curve.py``), Poseidon and the transcript (``zk/hashes.py``) and
  Bulletproofs range proofs (``zk/bulletproofs.py``), with every field
  product a Montgomery-multiply kernel (``csrc/digits.cu``);
* the rest of its ZK stack and the election built on it: the Fr NTT
  (``zk/fr_ntt.py``), the BN254/BLS12-381 pairings (``zk/pairing.py``,
  ``pairing_bls.py``), G2 (``zk/curve_g2.py``), KZG/FRI
  (``zk/commitments.py``), Groth16 and its circuits (``zk/groth16.py``,
  ``circuits.py``), PLONK (``zk/plonk.py``), and ``api/zk.py``
  ``ZKProofManager``, ``api/voting.py`` ``VotingSystem``, ``api/verify.py``
  ``PublicVerifier`` with the verification CLI (``cli.py``).

Module names mirror the JAX package so each function's counterpart is found
at the same path.

Torus values and scalar limbs (uint32 in the reference) are held in
``int32`` tensors with the same bits: add, sub and mul wrap identically, and
``ops/u32.py`` supplies the logical shift and unsigned compare that int32
lacks.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
there is no silent CPU fallback (``device.resolve_device``).
"""
from .device import resolve_device
from .core.bootstrap import (
    TfheParams, TfheEngine, LweCiphertext, GlweCiphertext, BootstrapKey,
    TFHE_BOOT_128, TFHE_BOOT_128_L2, TFHE_BOOT_128_K4, TFHE_BOOT_128_K4T,
)
from .core.params import ParameterSet, FHEScheme, SecurityLevel, PRESETS
from .core.poly import PolyRing
from .core.keys import KeyManager
from .core.encrypt import Ciphertext, EncryptionEngine
from .zk.field import (Field, bls12_381_fq, bls12_381_fr, bn254_fq,
                       bn254_fr)
from .zk.field2 import Field2, bls12_381_fq2, bn254_fq2
from .zk.curve import Curve, bls12_381_g1, bn254_g1
from .zk.hashes import PoseidonHash, Transcript
from .zk.bulletproofs import (BulletproofsGens, BulletproofsProver,
                              BulletproofsVerifier)

__all__ = [
    "resolve_device", "TfheParams", "TfheEngine", "LweCiphertext",
    "GlweCiphertext", "BootstrapKey", "TFHE_BOOT_128", "TFHE_BOOT_128_L2",
    "TFHE_BOOT_128_K4", "TFHE_BOOT_128_K4T",
    "ParameterSet", "FHEScheme", "SecurityLevel", "PRESETS", "PolyRing",
    "KeyManager", "Ciphertext", "EncryptionEngine",
    "Field", "bn254_fq", "bn254_fr", "bls12_381_fq", "bls12_381_fr",
    "Field2", "bn254_fq2", "bls12_381_fq2", "Curve", "bn254_g1",
    "bls12_381_g1", "PoseidonHash", "Transcript", "BulletproofsGens",
    "BulletproofsProver", "BulletproofsVerifier",
]
