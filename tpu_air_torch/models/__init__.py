"""tpu_air_torch.models — PyTorch model families: ``t5``, ``lm`` and
``segformer``, and the tokenizers (``ByteTokenizer``, ``auto_tokenizer``)."""

from tpu_air_torch._exports import lazy_exports

from . import segformer

_EXPORTS = {
    "ByteTokenizer": "tokenizer",
    "auto_tokenizer": "tokenizer",
}

# t5 and the tokenizers load at first use
__getattr__ = lazy_exports(__name__, _EXPORTS, ("t5",))

__all__ = ["ByteTokenizer", "auto_tokenizer", "segformer", "t5"]
