"""In-circuit gadgets: Poseidon permutation, Merkle membership, and the
voter EligibilityCircuit (counterpart of
node_fhe_accelerate_tpu/zk/circuits.py).

Semantics:

    leaf      = Poseidon.hash2(voter_id, voter_id)
    nullifier = Poseidon.hash2(voter_id, voter_secret)
    public inputs = [merkle_root, nullifier]

and the in-circuit Poseidon reproduces zk/hashes.py, so circuit outputs
agree with the host hash used by the Merkle tree / registry.

R1CS economics: linear combinations are free (they ride inside constraint
coefficient dicts); only S-boxes materialize wires -- x^5 costs 3 mul
constraints.  One Poseidon permutation = (8 full * 3 + 57 partial) S-boxes
* 3 = 243 constraints; a depth-D membership proof plus nullifier is
(D + 2) permutations + 2 constraints per level for the path selectors.

Witness generation replays the same gadget program with concrete values
(each constraint defines exactly one fresh wire), so the builder records a
straight-line program alongside the constraints.  The circuit's Poseidon
hashes (leaves, nullifiers) run on the Poseidon field's device.
"""
from __future__ import annotations

from dataclasses import dataclass

from .field import BN254_FR as R
from .groth16 import CircuitBuilder, R1CS
from .hashes import PoseidonHash

__all__ = ["GadgetBuilder", "poseidon_hash2_gadget", "EligibilityCircuit"]


def _lc_scale(lc: dict, k: int) -> dict:
    k %= R
    if not k:
        return {}
    return {w: co * k % R for w, co in lc.items()}


def _lc_add(*lcs) -> dict:
    out: dict = {}
    for lc in lcs:
        for w, co in lc.items():
            v = (out.get(w, 0) + co) % R
            if v:
                out[w] = v
            else:
                out.pop(w, None)
    return out


def _lc_sub(a: dict, b: dict) -> dict:
    return _lc_add(a, _lc_scale(b, R - 1))


class GadgetBuilder(CircuitBuilder):
    """CircuitBuilder that works over linear combinations and records a
    straight-line witness program."""

    def __init__(self):
        super().__init__()
        self._program: list = []   # (out_wire, lc_a, lc_b)

    def input_wire(self, public: bool = False) -> int:
        return self.public_input() if public else self.private_input()

    def mul_lc(self, la: dict, lb: dict) -> int:
        """Fresh wire z with constraint <la, w> * <lb, w> = z."""
        z = self.private_input()
        self._constraints.append((dict(la), dict(lb), {z: 1}))
        self._program.append((z, dict(la), dict(lb)))
        return z

    def assert_lc_equal(self, la: dict, lb: dict):
        self._constraints.append((dict(la), {0: 1}, dict(lb)))

    def assert_boolean(self, wire: int):
        self._constraints.append(({wire: 1}, {wire: 1, 0: R - 1}, {}))

    def compute_assignment(self, inputs: dict) -> dict:
        """inputs: {wire: int} for all input wires -> full assignment dict
        by replaying the recorded program (constraint wires are defined in
        order, each by one mul)."""
        vals = {0: 1}
        vals.update({w: v % R for w, v in inputs.items()})

        def ev(lc):
            return sum(co * vals[w] for w, co in lc.items()) % R

        for z, la, lb in self._program:
            vals[z] = ev(la) * ev(lb) % R
        return vals


def _sbox5(b: GadgetBuilder, lc: dict) -> dict:
    x2 = b.mul_lc(lc, lc)
    x4 = b.mul_lc({x2: 1}, {x2: 1})
    x5 = b.mul_lc({x4: 1}, lc)
    return {x5: 1}


def poseidon_permutation_gadget(b: GadgetBuilder, state: list,
                                p: PoseidonHash) -> list:
    """state: [lc, lc, lc] -> permuted [lc, lc, lc], mirroring
    PoseidonHash.permutation (full/partial/full schedule)."""
    t = p.t
    fr_half = p.full_rounds // 2
    rounds = p.full_rounds + p.partial_rounds

    def add_rc(st, rc):
        return [_lc_add(st[i], {0: rc[i] % R}) for i in range(t)]

    def mds(st):
        return [_lc_add(*[_lc_scale(st[j], p.mds_int[i][j])
                          for j in range(t)]) for i in range(t)]

    for r in range(rounds):
        state = add_rc(state, p.round_constants_int[r])
        if r < fr_half or r >= fr_half + p.partial_rounds:
            state = [_sbox5(b, s) for s in state]
        else:
            state = [_sbox5(b, state[0])] + state[1:]
        state = mds(state)
    return state


def poseidon_hash2_gadget(b: GadgetBuilder, left: dict, right: dict,
                          p: PoseidonHash) -> dict:
    """hash2(left, right) = permutation([left, right, 0])[0]."""
    return poseidon_permutation_gadget(b, [left, right, {}], p)[0]


def merkle_verify_gadget(b: GadgetBuilder, leaf: dict, path_wires: list,
                         bit_wires: list, root_lc: dict, p: PoseidonHash):
    """Walk the authentication path: bit=0 -> current is the left child.
    Each level: 1 select mul + 1 hash2."""
    cur = leaf
    for s_wire, b_wire in zip(path_wires, bit_wires):
        b.assert_boolean(b_wire)
        sib = {s_wire: 1}
        # left = cur + bit*(sib - cur);  right = sib + cur - left
        t = b.mul_lc({b_wire: 1}, _lc_sub(sib, cur))
        left = _lc_add(cur, {t: 1})
        right = _lc_sub(_lc_add(sib, cur), left)
        cur = poseidon_hash2_gadget(b, left, right, p)
    b.assert_lc_equal(cur, root_lc)


@dataclass
class EligibilityWitness:
    assignment: dict
    public_inputs: list       # [merkle_root, nullifier]


class EligibilityCircuit:
    """Membership + nullifier circuit (groth16.h:342-406).

    Wires: public [merkle_root, nullifier]; private [voter_id,
    voter_secret, path siblings, path bits]."""

    def __init__(self, tree_depth: int, poseidon: PoseidonHash | None = None,
                 device=None):
        self.depth = tree_depth
        self.poseidon = poseidon or PoseidonHash(device=device)
        b = GadgetBuilder()
        self.root_wire = b.input_wire(public=True)
        self.nullifier_wire = b.input_wire(public=True)
        self.voter_id_wire = b.input_wire()
        self.voter_secret_wire = b.input_wire()
        self.path_wires = [b.input_wire() for _ in range(tree_depth)]
        self.bit_wires = [b.input_wire() for _ in range(tree_depth)]

        vid = {self.voter_id_wire: 1}
        leaf = poseidon_hash2_gadget(b, vid, vid, self.poseidon)
        merkle_verify_gadget(b, leaf, self.path_wires, self.bit_wires,
                             {self.root_wire: 1}, self.poseidon)
        null = poseidon_hash2_gadget(
            b, vid, {self.voter_secret_wire: 1}, self.poseidon)
        b.assert_lc_equal(null, {self.nullifier_wire: 1})
        self.builder = b
        self.r1cs: R1CS = b.build()
        # wire ids survive build()'s reorder via the remap it applies
        self._remap = {old: new for new, old in enumerate(
            [0] + b._public + [v for v in range(1, b._num_vars)
                               if v not in b._public])}

    # -- host-side helpers ---------------------------------------------------
    def hash2_int(self, l: int, r: int) -> int:
        f = self.poseidon.f
        out = self.poseidon.hash2(f.encode([l])[0], f.encode([r])[0])
        return int(f.decode(out[None, :])[0])

    def leaf(self, voter_id: int) -> int:
        return self.hash2_int(voter_id, voter_id)

    def leaves(self, voter_ids: list) -> list:
        """``leaf`` of every id in one batched hash (the same values)."""
        f = self.poseidon.f
        x = f.encode([int(v) for v in voter_ids])
        return [int(v) for v in f.decode(self.poseidon.hash2(x, x))]

    def nullifier(self, voter_id: int, voter_secret: int) -> int:
        return self.hash2_int(voter_id, voter_secret)

    def generate_witness(self, voter_id: int, voter_secret: int,
                         merkle_path: list, path_bits: list,
                         merkle_root: int) -> EligibilityWitness:
        """Raises ValueError (via the prover's constraint check) only at
        prove time; here just replays the program."""
        nullifier = self.nullifier(voter_id, voter_secret)
        inputs = {self.root_wire: merkle_root,
                  self.nullifier_wire: nullifier,
                  self.voter_id_wire: voter_id,
                  self.voter_secret_wire: voter_secret}
        for w, sib in zip(self.path_wires, merkle_path):
            inputs[w] = sib
        for w, bit in zip(self.bit_wires, path_bits):
            inputs[w] = int(bit)
        raw = self.builder.compute_assignment(inputs)
        assignment = {self._remap[w]: v for w, v in raw.items() if w != 0}
        return EligibilityWitness(
            assignment=assignment,
            public_inputs=[merkle_root % R, nullifier % R])
