"""node-fhe-accelerate-tpu, PyTorch/CUDA port.

The JAX package ``node_fhe_accelerate_tpu`` is the reference; this package
reproduces its TFHE programmable bootstrap bit for bit in PyTorch, with the
blind-rotate CMux step running as a hand-written CUDA kernel for Hopper
(``csrc/cmux_step.cu``).  Module names mirror the JAX package so each
function's counterpart is found at the same path.

Torus values (uint32 in the reference) are held in ``int32`` tensors with
the same bits: add, sub and mul wrap identically, and ``ops/u32.py`` supplies
the logical shift and unsigned compare that int32 lacks.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
there is no silent CPU fallback (``device.resolve_device``).
"""
from .device import resolve_device
from .core.bootstrap import (
    TfheParams, TfheEngine, LweCiphertext, GlweCiphertext, BootstrapKey,
    TFHE_BOOT_128, TFHE_BOOT_128_L2, TFHE_BOOT_128_K4, TFHE_BOOT_128_K4T,
)

__all__ = [
    "resolve_device", "TfheParams", "TfheEngine", "LweCiphertext",
    "GlweCiphertext", "BootstrapKey", "TFHE_BOOT_128", "TFHE_BOOT_128_L2",
    "TFHE_BOOT_128_K4", "TFHE_BOOT_128_K4T",
]
