"""tpu_air_torch.ops — hand-written CUDA kernels for Hopper, each beside its
plain PyTorch version.  Kernels are built from ``ops/csrc`` at first use.

The package exports the JAX package's names where the port has them:
``flash_attention``, ``flash_attention_with_lse`` and ``ring_attention``.
``flash_attention`` and ``ring_attention`` are the modules of those names,
callable as their functions (``tpu_air_torch/_exports.py``)."""

from tpu_air_torch._exports import lazy_exports

_CALLABLE_MODULES = ("flash_attention", "ring_attention")
_EXPORTS = {"flash_attention_with_lse": "flash_attention"}

__getattr__ = lazy_exports(__name__, _EXPORTS, _CALLABLE_MODULES)

__all__ = sorted([*_EXPORTS, *_CALLABLE_MODULES])
