"""Sharded programmable bootstrapping: the batch axis over the mesh
(counterpart of node_fhe_accelerate_tpu/parallel/pbs.py).

The blind rotate is a scan over the LWE mask with a per-step contraction
(core/bootstrap.py); its batch axis is embarrassingly parallel.  So the
multi-device bootstrap splits the ciphertext batch over the "data" axis and
replicates the bootstrap key (read-only, shared by every step): no
collective runs inside the rotation.  Each position bootstraps its slice
through ``TfheEngine.bootstrap_with_test_poly`` on its device, and so
through the engine's backend (K1 for "pallas", K4 for "pallas_fused", K5
for "mxu_fused" on the card).

The key is copied once per *distinct* device, not once per position: four
positions on one card share one key (``prepare_bsk``'s K-major slabs alone
take 8.26 GB at TFHE_BOOT_128_K4).  An engine with
``ext_backend="auto"`` is reused on its own device, so its race runs once
per (device, shard shape); name a backend to skip the race.
"""
from __future__ import annotations

from ..core.bootstrap import BootstrapKey, LweCiphertext, TfheEngine
from .mesh import (Mesh, Replicated, Sharded, canonical_device, replicate,
                   shard, to_device)

__all__ = ["shard_lwe_batch", "replicate_bsk", "sharded_bootstrap_fn"]


def shard_lwe_batch(lwe: LweCiphertext, mesh: Mesh,
                    axis: str = "data") -> LweCiphertext:
    """A batched LWE ciphertext with its leading batch axis split over
    ``axis``: ``a`` and ``b`` become ``Sharded``."""
    return LweCiphertext(a=shard(lwe.a, mesh, 0, axis),
                         b=shard(lwe.b, mesh, 0, axis))


def replicate_bsk(bsk: BootstrapKey, mesh: Mesh) -> Replicated:
    """The bootstrap key on every distinct device of the mesh, one copy a
    device (the key's own device keeps its tensors)."""
    return replicate(bsk, mesh)


def _requested_backend(eng: TfheEngine) -> str:
    """The ``ext_backend`` an engine was made with ("auto" when it races)."""
    return "auto" if eng.dispatcher is not None else eng.backend


def sharded_bootstrap_fn(eng: TfheEngine, mesh: Mesh, axis: str = "data"):
    """(lwe, bsk, test_poly) -> lwe' with the batch split over ``axis``.

    Inputs are placed with ``shard_lwe_batch`` / ``replicate_bsk`` (whole
    tensors are placed on the way in); the output stays split, one slice a
    position on its device (``mesh.gather`` joins it).  The positions on
    ``eng``'s device run ``eng`` itself; another device gets one engine of
    the same parameters and backend."""
    engines = {str(canonical_device(eng.device)): eng}

    def engine_on(dev) -> TfheEngine:
        key = str(dev)
        if key not in engines:
            engines[key] = TfheEngine(eng.p, _requested_backend(eng),
                                      device=dev)
        return engines[key]

    def fn(lwe: LweCiphertext, bsk, test_poly) -> LweCiphertext:
        if not isinstance(lwe.a, Sharded):
            lwe = shard_lwe_batch(lwe, mesh, axis)
        if not isinstance(bsk, Replicated):
            bsk = replicate_bsk(bsk, mesh)
        outs = []
        for a, b, dev in zip(lwe.a.shards, lwe.b.shards,
                             mesh.axis_devices(axis)):
            outs.append(engine_on(dev).bootstrap_with_test_poly(
                LweCiphertext(a=a, b=b), bsk.on(dev),
                to_device(test_poly, dev)))
        batch = lwe.b.global_shape[0]
        return LweCiphertext(
            a=Sharded([o.a for o in outs], mesh, 0,
                      (batch, outs[0].a.shape[-1]), axis),
            b=Sharded([o.b for o in outs], mesh, 0, (batch,), axis))

    fn.engines = engines
    return fn
