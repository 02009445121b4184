"""FHEEngine, the whole public API surface (counterpart of
node_fhe_accelerate_tpu/api/engine.py).

Every method is backed by the port's engines: BFV-style RLWE over one
modulus (core/encrypt.py) or over the whole RNS chain when the parameter
set carries more than one modulus (core/rns.py), torus-2^32 TFHE
(core/bootstrap.py, ``ext_backend="auto"``: the backends race once per
batch shape at the first bootstrap) for bootstrapping, Shamir threshold
decryption (core/threshold.py) and the binary serializer
(core/serializer.py).  Randomness comes from one ``torch.Generator`` on the
engine's device, seeded from ``rng_seed``.

Names are snake_case; a camelCase alias table at the bottom keeps the
reference's method names.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core import threshold as th
from ..core.bootstrap import (BootstrapKey, LweCiphertext, TfheEngine,
                              TfheParams)
from ..core.encrypt import Ciphertext, EncryptionEngine, Plaintext
from ..core.keys import (KeyManager, PublicKey, RelinKey, SecretKey,
                         SecretKeyDistribution)
from ..core.params import ParameterSet, create_parameter_set
from ..core.security import SecurityValidator
from ..core.serializer import (CompressionType, Magic,
                               deserialize_polynomial, serialize_polynomial)
from ..device import resolve_device

__all__ = ["FHEEngine", "create_fhe_engine", "HardwareCapabilities"]


@dataclass
class HardwareCapabilities:
    """The devices the port can run on (the reference's detect_hardware),
    read from torch.cuda."""
    platform: str
    device_count: int
    device_kind: str
    has_tpu: bool

    @classmethod
    def detect(cls) -> "HardwareCapabilities":
        if torch.cuda.is_available():
            return cls(platform="gpu",
                       device_count=torch.cuda.device_count(),
                       device_kind=torch.cuda.get_device_name(0),
                       has_tpu=False)
        return cls(platform="cpu", device_count=1, device_kind="cpu",
                   has_tpu=False)


class FHEEngine:
    """Full-surface engine over one parameter set."""

    def __init__(self, params: ParameterSet,
                 tfhe_params: TfheParams | None = None, rng_seed: int = 0,
                 device=None):
        self.params = params
        self.device = resolve_device(device)
        if len(params.moduli) > 1:
            # a multi-modulus chain computes over the whole chain
            from ..core.rns import RnsEncryptionEngine
            self.engine = RnsEncryptionEngine(params, device=self.device)
        else:
            self.engine = EncryptionEngine(params, device=self.device)
        self.ring = self.engine.ring
        self.keys = KeyManager(params, self.ring)
        self.tfhe = TfheEngine(tfhe_params or TfheParams(),
                               device=self.device)
        self.gen = torch.Generator(device=self.device).manual_seed(rng_seed)
        self._next_key_id = 1

    # -- key generation ---------------------------------------------------
    def generate_secret_key(self, distribution=SecretKeyDistribution.TERNARY
                            ) -> SecretKey:
        kid = self._next_key_id
        self._next_key_id += 1
        return self.keys.generate_secret_key(self.gen, distribution,
                                             key_id=kid)

    def generate_public_key(self, sk: SecretKey) -> PublicKey:
        return self.keys.generate_public_key(self.gen, sk)

    def generate_eval_key(self, sk: SecretKey, base_log=0, level=0
                          ) -> RelinKey:
        return self.keys.generate_relin_key(self.gen, sk, base_log, level)

    def generate_bootstrap_key(self):
        """TFHE bootstrap keys live in the torus engine; returns
        (lwe_sk, glwe_sk, bsk)."""
        lwe_sk = self.tfhe.lwe_keygen(self.gen)
        glwe_sk = self.tfhe.glwe_keygen(self.gen)
        bsk = self.tfhe.generate_bootstrap_key(self.gen, lwe_sk, glwe_sk)
        return lwe_sk, glwe_sk, bsk

    def generate_threshold_keys(self, threshold: int, total_shares: int
                                ) -> th.ThresholdKeys:
        return th.generate_threshold_keys(self.gen, self.ring, threshold,
                                          total_shares)

    # -- encryption -------------------------------------------------------
    def encrypt_value(self, value: int, pk: PublicKey) -> Ciphertext:
        return self.engine.encrypt(self.gen, value, pk)

    def encrypt_packed(self, values, pk: PublicKey) -> Ciphertext:
        return self.engine.encrypt(self.gen, values, pk)

    def encrypt(self, pt: Plaintext, pk: PublicKey) -> Ciphertext:
        return self.engine.encrypt(self.gen, pt.values, pk)

    def batch_encrypt(self, pts: list, pk: PublicKey,
                      progress=None) -> list:
        """`progress(i, total, stage)` fires per ciphertext — the
        ProgressCallback contract of the reference's long ops
        (src/index.ts:74-79), same signature as PublicVerifier's."""
        out = []
        for i, p in enumerate(pts):
            out.append(self.encrypt(p, pk))
            if progress:
                progress(i + 1, len(pts), "encrypting")
        return out

    # -- decryption ----------------------------------------------------------
    def decrypt_value(self, ct: Ciphertext, sk: SecretKey) -> int:
        vals, _ = self.engine.decrypt(ct, sk)
        return int(vals[0])

    def decrypt_packed(self, ct: Ciphertext, sk: SecretKey,
                       num_values: int) -> np.ndarray:
        vals, _ = self.engine.decrypt(ct, sk, num_values)
        return vals

    def decrypt(self, ct: Ciphertext, sk: SecretKey):
        """Returns (Plaintext, noise_budget)."""
        vals, budget = self.engine.decrypt(ct, sk)
        return Plaintext(values=vals, modulus=self.engine.t), budget

    # -- homomorphic ops -----------------------------------------------------
    def add(self, a, b):
        return self.engine.add(a, b)

    def add_plain(self, ct, pt: Plaintext):
        return self.engine.add_plain(ct, pt.values)

    def add_scalar(self, ct, value: int):
        return self.engine.add_plain(ct, value)

    def subtract(self, a, b):
        return self.engine.sub(a, b)

    def negate(self, ct):
        return self.engine.negate(ct)

    def batch_add(self, cts: list, progress=None):
        if progress is None:
            return self.engine.batch_add(cts)
        total = len(cts)
        acc = cts[0]
        for i, ct in enumerate(cts[1:], start=2):
            acc = self.engine.add(acc, ct)
            progress(i, total, "tallying")
        return acc

    def multiply(self, a, b):
        return self.engine.multiply(a, b)

    def multiply_relin(self, a, b, ek: RelinKey):
        return self.engine.multiply_relin(a, b, ek)

    def multiply_plain(self, ct, pt: Plaintext):
        return self.engine.multiply_plain(ct, pt.values)

    def multiply_scalar(self, ct, scalar: int):
        return self.engine.multiply_scalar(ct, scalar)

    def relinearize(self, ct, ek: RelinKey):
        return self.engine.relinearize(ct, ek)

    def square(self, ct):
        return self.engine.square(ct)

    def square_relin(self, ct, ek: RelinKey):
        return self.engine.relinearize(self.engine.square(ct), ek)

    # -- bootstrapping (torus engine) ---------------------------------------
    def bootstrap(self, lwe: LweCiphertext, bsk: BootstrapKey):
        return self.tfhe.bootstrap(lwe, bsk)

    def programmable_bootstrap(self, lwe: LweCiphertext, bsk: BootstrapKey,
                               lut_fn):
        return self.tfhe.programmable_bootstrap(lwe, bsk,
                                                self.tfhe.make_lut(lut_fn))

    def bootstrap_many_lut(self, lwe: LweCiphertext, bsk: BootstrapKey,
                           lut_fns):
        """K functions of one encrypted input with a single blind rotate
        (leading output axis = LUT index); see TfheEngine.bootstrap_many_lut."""
        return self.tfhe.bootstrap_many_lut(lwe, bsk, lut_fns)

    # -- threshold decryption ------------------------------------------------
    def partial_decrypt(self, ct: Ciphertext, share: th.SecretKeyShare
                        ) -> th.PartialDecryption:
        return th.partial_decrypt(self.ring, ct.c1, share)

    def combine_partial_decryptions(self, ct: Ciphertext, partials: list,
                                    threshold: int):
        phase = th.combine_partial_decryptions(self.ring, ct.c0, partials,
                                               threshold)
        vals = self.engine.decode(phase)
        return Plaintext(values=vals, modulus=self.engine.t)

    # -- noise budget --------------------------------------------------------
    def get_noise_budget(self, ct: Ciphertext, sk: SecretKey) -> float:
        return self.engine.noise_budget(self.engine.phase(ct, sk))

    def estimate_noise_budget(self, ct: Ciphertext) -> float:
        return ct.noise_budget

    # -- serialization -------------------------------------------------------
    @property
    def _ser_modulus(self) -> int:
        # Header modulus field is u64; for RNS chains record the first prime
        # (the ring layout is implied by the engine's parameter set).
        return self.params.moduli[0]

    def serialize_secret_key(self, sk: SecretKey,
                             compression=CompressionType.NONE) -> bytes:
        return serialize_polynomial(
            np.asarray(self.ring.to_np(sk.poly)).reshape(-1),
            Magic.SECRET_KEY, key_id=sk.key_id,
            modulus=self._ser_modulus, compression=compression)

    def deserialize_secret_key(self, raw: bytes) -> SecretKey:
        hdr, coeffs = deserialize_polynomial(raw, Magic.SECRET_KEY)
        return SecretKey(poly=self.ring.from_np(coeffs), key_id=hdr.key_id)

    def serialize_public_key(self, pk: PublicKey,
                             compression=CompressionType.NONE) -> bytes:
        data = np.stack([np.asarray(self.ring.to_np(pk.a)).reshape(-1),
                         np.asarray(self.ring.to_np(pk.b)).reshape(-1)])
        return serialize_polynomial(data.reshape(-1), Magic.PUBLIC_KEY,
                                    key_id=pk.key_id,
                                    modulus=self._ser_modulus,
                                    compression=compression)

    def deserialize_public_key(self, raw: bytes) -> PublicKey:
        hdr, coeffs = deserialize_polynomial(raw, Magic.PUBLIC_KEY)
        flat = np.asarray(coeffs).reshape(2, -1)
        return PublicKey(a=self.ring.from_np(flat[0]),
                         b=self.ring.from_np(flat[1]), key_id=hdr.key_id)

    def serialize_ciphertext(self, ct: Ciphertext,
                             compression=CompressionType.NONE) -> bytes:
        parts = [np.asarray(self.ring.to_np(ct.c0)).reshape(-1),
                 np.asarray(self.ring.to_np(ct.c1)).reshape(-1)]
        if ct.is_degree_2:
            parts.append(np.asarray(self.ring.to_np(ct.c2)).reshape(-1))
        data = np.stack(parts)
        return serialize_polynomial(data.reshape(-1), Magic.BALLOT,
                                    key_id=ct.key_id,
                                    modulus=self._ser_modulus,
                                    compression=compression)

    def deserialize_ciphertext(self, raw: bytes) -> Ciphertext:
        hdr, coeffs = deserialize_polynomial(raw, Magic.BALLOT)
        nc = self.ring.n * getattr(self.ring, "K", 1)
        flat = np.asarray(coeffs).reshape(-1, nc)
        c2 = self.ring.from_np(flat[2]) if flat.shape[0] == 3 else None
        return Ciphertext(c0=self.ring.from_np(flat[0]),
                          c1=self.ring.from_np(flat[1]), c2=c2,
                          noise_budget=self.engine.initial_noise_budget,
                          key_id=hdr.key_id)

    # -- misc ----------------------------------------------------------------
    def create_plaintext(self, value: int) -> Plaintext:
        return Plaintext.scalar(value, self.engine.t)

    def create_packed_plaintext(self, values) -> Plaintext:
        return Plaintext(values=np.asarray(values, dtype=np.uint64),
                         modulus=self.engine.t)

    def get_zero_ciphertext(self, pk: PublicKey) -> Ciphertext:
        return self.encrypt_value(0, pk)

    def get_params(self) -> ParameterSet:
        return self.params

    def get_hardware_capabilities(self) -> HardwareCapabilities:
        return HardwareCapabilities.detect()

    def get_slot_count(self) -> int:
        return self.params.poly_degree

    def validate_security(self):
        return SecurityValidator().validate(self.params)

    def dispose(self):
        pass


def create_fhe_engine(params: ParameterSet | str, **kw) -> FHEEngine:
    """createFHEEngine (fhe-engine.ts:464); ``kw`` goes to FHEEngine
    (``tfhe_params``, ``rng_seed``, ``device``)."""
    if isinstance(params, str):
        params = create_parameter_set(params)
    return FHEEngine(params, **kw)


# camelCase alias table: the reference's TS method names
# (src/api/fhe-engine.ts:33-78) resolve on FHEEngine instances for parity
# checks / ported callers.
_CAMEL_ALIASES = {
    "generateSecretKey": "generate_secret_key",
    "generatePublicKey": "generate_public_key",
    "generateEvalKey": "generate_eval_key",
    "generateBootstrapKey": "generate_bootstrap_key",
    "generateThresholdKeys": "generate_threshold_keys",
    "encryptValue": "encrypt_value",
    "encryptPacked": "encrypt_packed",
    "batchEncrypt": "batch_encrypt",
    "decryptValue": "decrypt_value",
    "decryptPacked": "decrypt_packed",
    "addPlain": "add_plain",
    "addScalar": "add_scalar",
    "batchAdd": "batch_add",
    "multiplyRelin": "multiply_relin",
    "multiplyPlain": "multiply_plain",
    "multiplyScalar": "multiply_scalar",
    "squareRelin": "square_relin",
    "programmableBootstrap": "programmable_bootstrap",
    "bootstrapManyLut": "bootstrap_many_lut",
    "partialDecrypt": "partial_decrypt",
    "combinePartialDecryptions": "combine_partial_decryptions",
    "getNoiseBudget": "get_noise_budget",
    "estimateNoiseBudget": "estimate_noise_budget",
    "serializeSecretKey": "serialize_secret_key",
    "deserializeSecretKey": "deserialize_secret_key",
    "serializePublicKey": "serialize_public_key",
    "deserializePublicKey": "deserialize_public_key",
    "serializeCiphertext": "serialize_ciphertext",
    "deserializeCiphertext": "deserialize_ciphertext",
    "createPlaintext": "create_plaintext",
    "createPackedPlaintext": "create_packed_plaintext",
    "getZeroCiphertext": "get_zero_ciphertext",
    "getParams": "get_params",
    "getHardwareCapabilities": "get_hardware_capabilities",
    "getSlotCount": "get_slot_count",
    "validateSecurity": "validate_security",
}

for _camel, _snake in _CAMEL_ALIASES.items():
    setattr(FHEEngine, _camel, getattr(FHEEngine, _snake))
