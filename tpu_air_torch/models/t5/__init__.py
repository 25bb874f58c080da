"""PyTorch T5 / FLAN-T5 model family (counterpart of tpu_air.models.t5).
``generate`` is the module of that name, callable as its function
(``tpu_air_torch/_exports.py``)."""

from tpu_air_torch._exports import lazy_exports

_CALLABLE_MODULES = ("generate",)
_EXPORTS = {
    "T5Config": "config",
    "T5ForConditionalGeneration": "modeling",
    "config_from_hf": "hf_import",
    "convert_t5_state_dict": "hf_import",
    "cross_entropy_loss": "modeling",
    "load_t5": "hf_import",
    "load_t5_from_hf": "hf_import",
    "make_t5_decode_step_fn": "generate",
    "make_t5_prefill_fn": "generate",
    "shift_right": "modeling",
}

__getattr__ = lazy_exports(__name__, _EXPORTS, _CALLABLE_MODULES)

__all__ = sorted([*_EXPORTS, *_CALLABLE_MODULES])
