"""Carry keys, ciphertexts and ZK state between the JAX package and the
port as numpy arrays (uint32 torus values and limb planes <-> int32 tensors
with the same bits; int32 digit planes and points as they are).

The caller turns JAX arrays into numpy with ``np.asarray``; nothing here
imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.bootstrap import BootstrapKey, LweCiphertext, TfheParams
from .device import resolve_device, tensor_to_u32, u32_to_tensor

__all__ = ["bsk_from_numpy", "bsk_to_numpy", "lwe_from_numpy",
           "lwe_to_numpy", "digits_from_numpy", "digits_to_numpy",
           "points_from_numpy", "points_to_numpy",
           "bulletproofs_gens_from_numpy", "poly_from_numpy",
           "poly_to_numpy", "secret_key_from_numpy",
           "public_key_from_numpy", "relin_key_from_numpy",
           "ciphertext_from_numpy", "ciphertext_to_numpy",
           "threshold_keys_from_numpy", "rns_poly_from_numpy",
           "rns_poly_to_numpy", "rns_relin_key_from_numpy",
           "rns_relin_key_to_numpy", "ckks_ciphertext_from_numpy",
           "ckks_ciphertext_to_numpy", "r1cs_from_jax",
           "groth16_setup_from_jax", "groth16_proof_from_jax",
           "kzg_setup_from_jax", "plonk_setup_from_jax",
           "plonk_proof_from_jax"]


def _i8_tensor(arr, dev):
    if arr is None:
        return None
    a = np.ascontiguousarray(np.asarray(arr, dtype=np.int8))
    if not a.flags.writeable:       # e.g. a view of a JAX array
        a = a.copy()
    return torch.from_numpy(a).to(dev)


def _u32_nested(x, dev):
    """uint32 arrays nested in tuples (the JAX limb-plane forms) -> the
    same nesting of int32 tensors."""
    if x is None:
        return None
    if isinstance(x, (tuple, list)):
        return tuple(_u32_nested(v, dev) for v in x)
    return u32_to_tensor(x, dev)


def _np_nested(x):
    if isinstance(x, tuple):
        return tuple(_np_nested(v) for v in x)
    if x.dtype == torch.int8:
        return x.detach().cpu().numpy()
    return tensor_to_u32(x)


def bsk_from_numpy(ggsw_i8, ksk_a, ksk_b, params: TfheParams,
                   device=None, ggsw_tiles=None, ggsw_slabs=None,
                   ggsw_ext=None, ggsw_crt=None) -> BootstrapKey:
    """GGSW forms and uint32 KSK arrays -> the port's BootstrapKey.

    ``ggsw_i8``: int8 digit planes (or None for a key of another form);
    ``ggsw_ext``: the (lo, hi) uint32 P_EXT planes of an "ntt" key;
    ``ggsw_crt``: ((lo1, hi1), (lo2, hi2)) of a "crt" key; the prepared
    ``ggsw_tiles`` / ``ggsw_slabs`` of a JAX key carry across field by
    field where given."""
    dev = resolve_device(device)
    return BootstrapKey(ggsw_i8=_i8_tensor(ggsw_i8, dev),
                        ggsw_ext=_u32_nested(ggsw_ext, dev),
                        ggsw_crt=_u32_nested(ggsw_crt, dev),
                        ksk_a=u32_to_tensor(ksk_a, dev),
                        ksk_b=u32_to_tensor(ksk_b, dev), params=params,
                        ggsw_tiles=_i8_tensor(ggsw_tiles, dev),
                        ggsw_slabs=_i8_tensor(ggsw_slabs, dev))


def bsk_to_numpy(bsk: BootstrapKey):
    """BootstrapKey -> (ggsw, ksk_a uint32, ksk_b uint32), ggsw being the
    GGSW form the key carries, with the JAX key's nesting: int8 planes
    (``ggsw_i8``), else (lo, hi) uint32 (``ggsw_ext``), else
    ((lo1, hi1), (lo2, hi2)) (``ggsw_crt``)."""
    ggsw = next((g for g in (bsk.ggsw_i8, bsk.ggsw_ext, bsk.ggsw_crt)
                 if g is not None), None)
    if ggsw is None:
        raise ValueError("the key carries no GGSW form")
    return (_np_nested(ggsw), tensor_to_u32(bsk.ksk_a),
            tensor_to_u32(bsk.ksk_b))


def lwe_from_numpy(a, b, device=None) -> LweCiphertext:
    """uint32 (a, b) arrays -> LweCiphertext of int32 tensors."""
    dev = resolve_device(device)
    return LweCiphertext(a=u32_to_tensor(a, dev), b=u32_to_tensor(b, dev))


def lwe_to_numpy(ct: LweCiphertext):
    """LweCiphertext -> (a, b) uint32 arrays."""
    return tensor_to_u32(ct.a), tensor_to_u32(ct.b)


# ---------------------------------------------------------------------------
# ZK state: digit planes, points, Bulletproofs generators
# ---------------------------------------------------------------------------


def digits_from_numpy(arr, device=None) -> torch.Tensor:
    """int32 digit planes (a numpy array, e.g. of a JAX field element or
    point coordinate) -> an int32 tensor on ``device``."""
    a = np.ascontiguousarray(np.asarray(arr, dtype=np.int32))
    if not a.flags.writeable:       # e.g. a view of a JAX array
        a = a.copy()
    return torch.from_numpy(a).to(resolve_device(device))


def digits_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Digit-plane tensor -> int32 numpy array."""
    if t.dtype != torch.int32:
        raise TypeError(f"expected an int32 tensor, got {t.dtype}")
    return t.detach().cpu().contiguous().numpy()


def points_from_numpy(curve, pts) -> tuple:
    """(X, Y, Z) int32 digit arrays of a JAX point set -> the same points on
    ``curve``'s device."""
    if len(pts) != 3:
        raise ValueError("a point is three coordinate planes (X, Y, Z)")
    return tuple(digits_from_numpy(c, curve.device) for c in pts)


def points_to_numpy(pts) -> tuple:
    """Port points -> (X, Y, Z) int32 numpy arrays."""
    return tuple(digits_to_numpy(c) for c in pts)


def bulletproofs_gens_from_numpy(curve, G, H, U, g_vec, h_vec, n: int):
    """The numpy (X, Y, Z) arrays of a JAX ``BulletproofsGens`` -> the
    port's ``BulletproofsGens`` on ``curve``'s device."""
    from .zk.bulletproofs import BulletproofsGens
    return BulletproofsGens(
        curve=curve, G=points_from_numpy(curve, G),
        H=points_from_numpy(curve, H), U=points_from_numpy(curve, U),
        g_vec=points_from_numpy(curve, g_vec),
        h_vec=points_from_numpy(curve, h_vec), n=n)


# ---------------------------------------------------------------------------
# RLWE (BFV) state: limb-plane polynomials, keys, ciphertexts, shares
# ---------------------------------------------------------------------------


def poly_from_numpy(planes, device=None) -> tuple:
    """A JAX limb-plane polynomial, (lo, hi) uint32 arrays (..., N), -> the
    port's (lo, hi) int32 tensors on ``device``."""
    lo, hi = planes
    dev = resolve_device(device)
    return u32_to_tensor(lo, dev), u32_to_tensor(hi, dev)


def poly_to_numpy(planes) -> tuple:
    """Port limb planes -> (lo, hi) uint32 arrays."""
    return tensor_to_u32(planes[0]), tensor_to_u32(planes[1])


def secret_key_from_numpy(poly, key_id: int = 0, device=None):
    from .core.keys import SecretKey
    return SecretKey(poly=poly_from_numpy(poly, device), key_id=key_id)


def public_key_from_numpy(a, b, key_id: int = 0, device=None):
    from .core.keys import PublicKey
    return PublicKey(a=poly_from_numpy(a, device),
                     b=poly_from_numpy(b, device), key_id=key_id)


def relin_key_from_numpy(a_list, b_list, decomp_base_log: int,
                         decomp_level: int, key_id: int = 0, device=None):
    from .core.keys import RelinKey
    return RelinKey(a=[poly_from_numpy(x, device) for x in a_list],
                    b=[poly_from_numpy(x, device) for x in b_list],
                    decomp_base_log=decomp_base_log,
                    decomp_level=decomp_level, key_id=key_id)


def ciphertext_from_numpy(c0, c1, c2=None, noise_budget: float = 0.0,
                          key_id: int = 0, is_ntt: bool = False,
                          device=None):
    """The planes of a JAX ``Ciphertext`` (c2 None for degree 1) -> the
    port's ``Ciphertext``."""
    from .core.encrypt import Ciphertext
    return Ciphertext(c0=poly_from_numpy(c0, device),
                      c1=poly_from_numpy(c1, device),
                      c2=None if c2 is None else poly_from_numpy(c2, device),
                      noise_budget=noise_budget, key_id=key_id,
                      is_ntt=is_ntt)


def ciphertext_to_numpy(ct) -> tuple:
    """Port ``Ciphertext`` -> (c0, c1, c2) uint32 plane pairs (c2 None for
    degree 1)."""
    return (poly_to_numpy(ct.c0), poly_to_numpy(ct.c1),
            None if ct.c2 is None else poly_to_numpy(ct.c2))


def threshold_keys_from_numpy(threshold: int, total_shares: int, shares,
                              master_poly, device=None):
    """``shares``: (share_id, (lo, hi)) pairs of a JAX ``ThresholdKeys``;
    ``master_poly``: its master secret's planes."""
    from .core.keys import SecretKey
    from .core.threshold import SecretKeyShare, ThresholdKeys
    return ThresholdKeys(
        threshold=threshold, total_shares=total_shares,
        shares=[SecretKeyShare(share_id=i,
                               share_poly=poly_from_numpy(p, device))
                for i, p in shares],
        master_sk=SecretKey(poly=poly_from_numpy(master_poly, device)))


# ---------------------------------------------------------------------------
# RNS and CKKS state: residue tuples, the RNS relin key, CKKS ciphertexts
# ---------------------------------------------------------------------------


def rns_poly_from_numpy(residues, device=None) -> tuple:
    """A JAX residue tuple, one (lo, hi) uint32 pair per prime, -> the
    port's residue tuple on ``device``."""
    return tuple(poly_from_numpy(r, device) for r in residues)


def rns_poly_to_numpy(poly) -> tuple:
    """Port residue tuple -> one (lo, hi) uint32 pair per prime."""
    return tuple(poly_to_numpy(r) for r in poly)


def rns_relin_key_from_numpy(a, b, key_id: str = "rns-relin",
                             device=None):
    """The residue tuples of a JAX ``RnsRelinKey`` (a[j], b[j] per gadget
    component) -> the port's ``RnsRelinKey``."""
    from .core.rns import RnsRelinKey
    return RnsRelinKey(a=[rns_poly_from_numpy(x, device) for x in a],
                       b=[rns_poly_from_numpy(x, device) for x in b],
                       key_id=key_id)


def rns_relin_key_to_numpy(rlk) -> tuple:
    """Port ``RnsRelinKey`` -> (a, b) lists of residue tuples of uint32
    pairs."""
    return ([rns_poly_to_numpy(x) for x in rlk.a],
            [rns_poly_to_numpy(x) for x in rlk.b])


def ckks_ciphertext_from_numpy(c0, c1, c2=None, level: int = 0,
                               scale=1, key_id: str = "ckks", device=None):
    """The residue tuples of a JAX ``CkksCiphertext`` (c2 None for degree
    1), its level and its scale (a ``Fraction``, kept exact) -> the port's
    ``CkksCiphertext``."""
    from fractions import Fraction

    from .core.ckks import CkksCiphertext
    return CkksCiphertext(
        c0=rns_poly_from_numpy(c0, device), c1=rns_poly_from_numpy(c1, device),
        c2=None if c2 is None else rns_poly_from_numpy(c2, device),
        level=level, scale=Fraction(scale), key_id=key_id)


def ckks_ciphertext_to_numpy(ct) -> tuple:
    """Port ``CkksCiphertext`` -> (c0, c1, c2, level, scale): residue tuples
    of uint32 pairs (c2 None for degree 1), the level and the exact
    scale."""
    return (rns_poly_to_numpy(ct.c0), rns_poly_to_numpy(ct.c1),
            None if ct.c2 is None else rns_poly_to_numpy(ct.c2), ct.level,
            ct.scale)


# ---------------------------------------------------------------------------
# SNARK state: Groth16, KZG and PLONK setups and proofs.  Each takes the JAX
# package's object and reads it by attribute (points as numpy arrays of
# their digit planes, FQ2 values by their coefficients); nothing here
# imports the JAX package.
# ---------------------------------------------------------------------------


def _points(pts, dev):
    """(X, Y, Z) digit arrays (any array type numpy reads) -> tensors on
    ``dev``; None stays None."""
    if pts is None:
        return None
    return tuple(digits_from_numpy(c, dev) for c in pts)


def _fq2_pair(host_mod, p):
    """An affine (FQ2, FQ2) pair of the JAX pairing tower -> the port's
    tower ``host_mod``; None (infinity) stays None."""
    if p is None:
        return None
    return tuple(host_mod.FQ2([int(c) for c in x.coeffs]) for x in p)


def r1cs_from_jax(r1cs):
    """A JAX ``R1CS`` -> the port's (the constraint dicts copied)."""
    from .zk.groth16 import R1CS
    return R1CS(num_vars=int(r1cs.num_vars), num_public=int(r1cs.num_public),
                constraints=[tuple({int(k): int(v) for k, v in part.items()}
                                   for part in con)
                             for con in r1cs.constraints])


def groth16_setup_from_jax(setup, device=None):
    """A JAX ``Groth16Setup`` -> the port's on ``device``: the G1 query
    points, the G2 affine pairs, and the device-encoded G2 query where the
    JAX setup carries one (``_b_query_g2_dev``).  The compiled circuit is
    rebuilt from the R1CS by the first prover that needs it."""
    from .zk import pairing as pr
    from .zk.groth16 import Groth16Setup
    dev = resolve_device(device)
    out = Groth16Setup(
        r1cs=r1cs_from_jax(setup.r1cs),
        alpha_g1=_points(setup.alpha_g1, dev),
        beta_g1=_points(setup.beta_g1, dev),
        delta_g1=_points(setup.delta_g1, dev),
        a_query=_points(setup.a_query, dev),
        b_query_g1=_points(setup.b_query_g1, dev),
        l_query=_points(setup.l_query, dev),
        h_query=_points(setup.h_query, dev),
        beta_g2=_fq2_pair(pr, setup.beta_g2),
        delta_g2=_fq2_pair(pr, setup.delta_g2),
        gamma_g2=_fq2_pair(pr, setup.gamma_g2),
        b_query_g2=[_fq2_pair(pr, p) for p in setup.b_query_g2],
        ic=_points(setup.ic, dev))
    b_dev = getattr(setup, "_b_query_g2_dev", None)
    if b_dev is not None:
        out._b_query_g2_dev = {str(dev): _points(b_dev, dev)}
    return out


def groth16_proof_from_jax(proof):
    """A JAX ``Groth16Proof`` -> the port's (ints and FQ2 pairs)."""
    from .zk import pairing as pr
    from .zk.groth16 import Groth16Proof

    def g1(p):
        return None if p is None else (int(p[0]), int(p[1]))

    return Groth16Proof(a=g1(proof.a), b=_fq2_pair(pr, proof.b),
                        c=g1(proof.c))


def kzg_setup_from_jax(setup, device=None):
    """A JAX ``KZGSetup`` -> the port's on ``device``: the same curve
    (BN254 or BLS12-381 G1, by its order), the SRS points, tau and the G2
    pair of the matching pairing tower."""
    from .zk import pairing as pr
    from .zk import pairing_bls as prb
    from .zk.commitments import KZGSetup
    from .zk.curve import bls12_381_g1, bn254_g1
    dev = resolve_device(device)
    order = int(setup.curve.order)
    curve, pm = ((bn254_g1(dev), pr) if order == pr.R
                 else (bls12_381_g1(dev), prb))
    if curve.order != order:
        raise ValueError("no port curve of this order")
    return KZGSetup(curve=curve, powers=_points(setup.powers, dev),
                    max_degree=int(setup.max_degree),
                    tau=None if setup.tau is None else int(setup.tau),
                    h2=_fq2_pair(pm, setup.h2),
                    tau_h2=_fq2_pair(pm, setup.tau_h2))


def plonk_setup_from_jax(setup, device=None):
    """A JAX ``PlonkSetup`` -> the port's on ``device`` (the circuit's
    gates, the KZG setup, the polynomials and their commitments, the
    coefficient planes)."""
    from .zk.plonk import Gate, PlonkCircuit, PlonkSetup
    dev = resolve_device(device)
    src = setup.circuit
    circuit = PlonkCircuit()
    circuit.gates = [Gate(*(int(getattr(g, k)) for k in
                            ("ql", "qr", "qo", "qm", "qc", "a", "b", "c")))
                     for g in src.gates]
    circuit._num_vars = int(src._num_vars)
    circuit.public_gates = [int(r) for r in src.public_gates]

    def ints(xs):
        return None if xs is None else [int(x) for x in xs]

    def planes(a):
        return None if a is None else digits_from_numpy(a, dev)

    return PlonkSetup(
        circuit=circuit, n=int(setup.n),
        kzg=kzg_setup_from_jax(setup.kzg, dev),
        selector_polys={k: ints(v) for k, v in setup.selector_polys.items()},
        selector_commits={k: _points(v, dev)
                          for k, v in setup.selector_commits.items()},
        sigma_polys=[ints(p) for p in setup.sigma_polys],
        sigma_commits=[_points(p, dev) for p in setup.sigma_commits],
        domain=ints(setup.domain),
        sigma_tags=None if setup.sigma_tags is None
        else [ints(t) for t in setup.sigma_tags],
        sel_planes=planes(setup.sel_planes),
        sig_planes=planes(setup.sig_planes),
        l1_poly=ints(setup.l1_poly), l1_plane=planes(setup.l1_plane))


def plonk_proof_from_jax(proof):
    """A JAX ``PlonkProof`` -> the port's (affine triples and ints)."""
    from .zk.plonk import PlonkProof
    return PlonkProof(
        commits={k: (int(v[0]), int(v[1]), bool(v[2]))
                 for k, v in proof.commits.items()},
        evals={k: int(v) for k, v in proof.evals.items()})
