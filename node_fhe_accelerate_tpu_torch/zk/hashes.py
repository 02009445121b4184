"""ZK hashes: Poseidon (BN254 Fr), Blake2s, Fiat-Shamir transcript, Merkle
(counterpart of node_fhe_accelerate_tpu/zk/hashes.py).

* Poseidon t=3, rate=2, 8 full + 57 partial rounds, alpha=5 S-box, with the
  reference's LCG-seeded round constants and Cauchy MDS, reproduced exactly
  so hashes and proof transcripts are byte-compatible.  Its field products
  are ``Field.mul``: K10 on the card.
* Blake2s via hashlib (host-side), and the transcript protocol
  (length-prefixed labels, challenge forking).
* Poseidon Merkle tree build/path/verify, batched level by level.
"""
from __future__ import annotations

import hashlib
import struct

import numpy as np
import torch

from ..ops import digits as dg
from .field import Field, bn254_fr

__all__ = ["PoseidonHash", "Blake2sHash", "Transcript", "MerkleTree"]


class PoseidonHash:
    """Poseidon over BN254 Fr."""

    def __init__(self, field: Field | None = None, t: int = 3,
                 full_rounds: int = 8, partial_rounds: int = 57,
                 device=None):
        self.f = field or bn254_fr(device)
        self.t = t
        self.rate = t - 1
        self.full_rounds = full_rounds
        self.partial_rounds = partial_rounds
        self._gen_constants()

    # -- constants (reproduced exactly) --------------------------------------
    def _gen_constants(self):
        q = self.f.q
        total = (self.full_rounds + self.partial_rounds) * self.t
        seed = 0x506F736569646F6E  # "Poseidon"
        consts = []
        for _ in range(total):
            seed = (seed * 6364136223846793005 + 1442695040888963407) \
                % (1 << 64)
            limbs = [
                seed,
                seed ^ (seed >> 17),
                seed ^ ((seed << 23) % (1 << 64)),
                (seed >> 32) ^ seed,
            ]
            while True:
                elem = sum(l << (64 * i) for i, l in enumerate(limbs))
                if elem < q:
                    break
                limbs[3] >>= 1
            consts.append(elem)
        rounds = self.full_rounds + self.partial_rounds
        # integer forms kept for the R1CS gadget
        self.round_constants_int = [
            consts[r * self.t:(r + 1) * self.t] for r in range(rounds)]
        # (rounds, t) field elements in Montgomery digit form
        self.round_constants = self.f.encode(
            np.array(consts, dtype=object).reshape(rounds, self.t))
        # Cauchy MDS: M[i][j] = 1 / (i + t + j + 1)
        mds = [[pow(i + self.t + j + 1, -1, q) for j in range(self.t)]
               for i in range(self.t)]
        self.mds_int = mds
        self.mds = self.f.encode(np.array(mds, dtype=object))

    # -- permutation ---------------------------------------------------------
    def _sbox(self, x):
        x2 = self.f.square(x)
        x4 = self.f.square(x2)
        return self.f.mul(x4, x)

    def _mds_multiply(self, state):
        """state: (..., t, D) -> M @ state with field muls."""
        f = self.f
        outs = []
        for i in range(self.t):
            acc = None
            for j in range(self.t):
                term = f.mul(self.mds[i, j], state[..., j, :])
                acc = term if acc is None else f.add(acc, term)
            outs.append(acc)
        return torch.stack(outs, dim=-2)

    def permutation(self, state):
        """Full Poseidon permutation on (..., t, D) digit state."""
        f = self.f
        fr_half = self.full_rounds // 2
        rc = self.round_constants
        for r in range(self.full_rounds + self.partial_rounds):
            state = f.add(state, rc[r])
            if fr_half <= r < fr_half + self.partial_rounds:
                s0 = self._sbox(state[..., 0, :])
                state = torch.cat([s0[..., None, :], state[..., 1:, :]],
                                  dim=-2)
            else:
                state = self._sbox(state)
            state = self._mds_multiply(state)
        return state

    # -- hashing -------------------------------------------------------------
    def _empty_state(self, batch=()):
        return torch.zeros(tuple(batch) + (self.t, self.f.n_limbs),
                           dtype=torch.int32, device=self.f.device)

    def hash(self, x):
        """Single element (..., D) -> (..., D)."""
        state = self._empty_state(x.shape[:-1])
        state[..., 0, :] = x
        return self.permutation(state)[..., 0, :]

    def hash2(self, left, right):
        """Two elements -> one (Merkle node)."""
        state = self._empty_state(left.shape[:-1])
        state[..., 0, :] = left
        state[..., 1, :] = right
        return self.permutation(state)[..., 0, :]

    def hash_many(self, inputs):
        """Sponge over (n, D) inputs."""
        n = inputs.shape[0]
        if n == 0:
            return self.f.zero
        if n == 1:
            return self.hash(inputs[0])
        if n == 2:
            return self.hash2(inputs[0], inputs[1])
        state = self._empty_state()
        i = 0
        while i < n:
            for r in range(self.rate):
                if i < n:
                    state[r, :] = self.f.add(state[r, :], inputs[i])
                    i += 1
            state = self.permutation(state)
        return state[0, :]

    def hash_ints(self, values) -> int:
        out = self.hash_many(self.f.encode(list(values)))
        return int(self.f.decode(out))


class Blake2sHash:
    """Blake2s-256 via hashlib; host-side."""

    @staticmethod
    def hash(data: bytes) -> bytes:
        return hashlib.blake2s(data).digest()

    @staticmethod
    def to_field_element(data: bytes, q: int) -> int:
        return int.from_bytes(data, "little") % q


class Transcript:
    """Fiat-Shamir transcript (length-prefixed labels, challenge forking),
    byte-identical to the JAX package's."""

    def __init__(self, label: str, _state: bytes | None = None):
        self._buf = _state if _state is not None else b""
        if _state is None:
            self.append_message("domain-sep", label.encode())

    def _update(self, data: bytes):
        self._buf += data

    def append_message(self, label: str, data: bytes):
        lb = label.encode()
        self._update(struct.pack("<I", len(lb)) + lb)
        self._update(struct.pack("<I", len(data)) + data)

    def append_u64(self, label: str, value: int):
        self.append_message(label, struct.pack("<Q", value))

    def append_field_element(self, label: str, value: int, width: int = 32):
        self.append_message(label, int(value).to_bytes(width, "little"))

    def append_point(self, label: str, point_affine, width: int = 32):
        """point_affine: (x, y, is_infinity)."""
        x, y, inf = point_affine
        if inf:
            self.append_message(label, b"\xff")
        else:
            self.append_message(
                label,
                int(x).to_bytes(width, "little")
                + int(y).to_bytes(width, "little"))

    def challenge_bytes(self, label: str) -> bytes:
        self.append_message("challenge", label.encode())
        challenge = hashlib.blake2s(self._buf).digest()
        self._update(challenge)
        return challenge

    def challenge_field_element(self, label: str, q: int) -> int:
        c = Blake2sHash.to_field_element(self.challenge_bytes(label), q)
        return c if c != 0 else 1  # avoid degenerate zero challenges

    def fork(self, label: str) -> "Transcript":
        t = Transcript("", _state=self._buf)
        t.append_message("fork", label.encode())
        return t


class MerkleTree:
    """Poseidon Merkle tree with batched per-level hashing."""

    def __init__(self, poseidon: PoseidonHash, leaves):
        """leaves: (n, D) digit array (n padded to a power of two with
        zeros)."""
        self.p = poseidon
        n = leaves.shape[0]
        size = 1 << max(1, (n - 1).bit_length())
        if size != n:
            pad = leaves.new_zeros((size - n, leaves.shape[1]))
            leaves = torch.cat([leaves, pad])
        self.levels = [leaves]
        cur = leaves
        while cur.shape[0] > 1:
            cur = self.p.hash2(cur[0::2], cur[1::2])
            self.levels.append(cur)

    @property
    def root(self):
        return self.levels[-1][0]

    def path(self, index: int):
        """Sibling list bottom-up."""
        sibs = []
        idx = index
        for lvl in self.levels[:-1]:
            sibs.append(lvl[idx ^ 1])
            idx >>= 1
        return sibs

    def verify(self, leaf, index: int, path, root) -> bool:
        cur = leaf
        idx = index
        for sib in path:
            if idx & 1:
                cur = self.p.hash2(sib, cur)
            else:
                cur = self.p.hash2(cur, sib)
            idx >>= 1
        return bool(dg.eq_digits(cur, root))
