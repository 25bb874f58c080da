"""Self-contained tokenizers.

The reference tokenizes with sentencepiece-backed ``T5Tokenizer``
(Model_finetuning…ipynb:cc-26; requirements.txt:146).  This environment has no
sentencepiece, so the framework ships a dependency-free byte-level tokenizer
with the T5 special-token convention (pad=0, eos=1) and an HF-compatible
calling surface (``__call__`` with padding/truncation/max_length,
``batch_decode``, ``save_pretrained``/``from_pretrained``) so the workload
layer is drop-in.  When HF fast tokenizers are importable, ``auto_tokenizer``
prefers them for real FLAN-T5 checkpoints.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Union

import numpy as np


class ByteTokenizer:
    """Byte-level tokenizer: one id per byte + specials. Lossless on any
    UTF-8 text, no training required — ideal for offline tests and a sound
    default for synthetic corpora."""

    PAD, EOS, UNK = 0, 1, 2
    OFFSET = 3

    def __init__(self, model_max_length: int = 512):
        self.model_max_length = model_max_length
        self.pad_token_id = self.PAD
        self.eos_token_id = self.EOS
        self.unk_token_id = self.UNK
        self.pad_token = "<pad>"
        self.eos_token = "</s>"
        self.vocab_size = 256 + self.OFFSET

    # -- encode ------------------------------------------------------------
    def encode(self, text: str, add_eos: bool = True) -> List[int]:
        ids = [b + self.OFFSET for b in text.encode("utf-8")]
        if add_eos:
            ids.append(self.EOS)
        return ids

    def __call__(
        self,
        text: Union[str, List[str]],
        max_length: Optional[int] = None,
        padding: Union[bool, str] = False,
        truncation: bool = False,
        return_tensors: Optional[str] = None,
        add_special_tokens: bool = True,
    ) -> Dict[str, Union[List, np.ndarray]]:
        texts = [text] if isinstance(text, str) else list(text)
        seqs = [self.encode(t, add_eos=add_special_tokens) for t in texts]
        limit = max_length or self.model_max_length
        if truncation:
            seqs = [s[:limit] for s in seqs]
        if padding == "max_length":
            width = limit
        elif padding in (True, "longest"):
            width = max((len(s) for s in seqs), default=0)
        else:
            width = None
        if width is not None:
            # like HF: padding never truncates — over-length sequences stay
            # full length unless truncation=True was passed
            attn = [[1] * len(s) + [0] * max(0, width - len(s)) for s in seqs]
            seqs = [s + [self.PAD] * max(0, width - len(s)) for s in seqs]
        else:
            attn = [[1] * len(s) for s in seqs]
        out = {"input_ids": seqs, "attention_mask": attn}
        if return_tensors in ("np", "jax"):
            if len({len(s) for s in seqs}) > 1:
                raise ValueError(
                    "ragged sequences cannot become tensors — pass "
                    "truncation=True (some inputs exceed max_length)"
                )
            out = {k: np.asarray(v, dtype=np.int32) for k, v in out.items()}
        return out

    # -- decode ------------------------------------------------------------
    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        data = bytearray()
        for i in np.asarray(ids).tolist():
            if self.OFFSET <= i < self.OFFSET + 256:
                data.append(i - self.OFFSET)
            elif i < self.OFFSET and not skip_special_tokens:
                data.extend(f"<{i}>".encode())
            # ids beyond the byte range (model vocab padded past 256+OFFSET,
            # reachable from an untrained head) decode to nothing, like HF's
            # handling of out-of-vocab pieces
        return data.decode("utf-8", errors="replace")

    def batch_decode(self, batch, skip_special_tokens: bool = True) -> List[str]:
        return [self.decode(ids, skip_special_tokens) for ids in np.asarray(batch)]

    # -- persistence (checkpoint bundling, SURVEY.md §5 checkpoint notes) --
    def save_pretrained(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
            json.dump(
                {
                    "tokenizer_class": "ByteTokenizer",
                    "model_max_length": self.model_max_length,
                },
                f,
            )

    @classmethod
    def from_pretrained(cls, path: str) -> "ByteTokenizer":
        cfg_path = os.path.join(path, "tokenizer_config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                cfg = json.load(f)
            return cls(model_max_length=cfg.get("model_max_length", 512))
        return cls()


def auto_tokenizer(name_or_path: str, strict: bool = False):
    """Best-effort tokenizer resolution (predictor.py:64 defaults to
    AutoTokenizer): HF fast tokenizer when its assets resolve locally, else
    the framework's pure-Python sentencepiece unigram loader for on-disk
    ``spiece.model``/``tokenizer.json`` (real FLAN-T5 vocab, offline), else
    ByteTokenizer.

    ``strict=True`` disables the ByteTokenizer fallback: a missing real
    vocab raises with both loaders' errors instead of silently degrading
    (a degraded tokenizer makes every downstream result quietly wrong)."""
    errors = []
    try:
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(name_or_path)
    except Exception as e:  # noqa: BLE001 — any backend failure falls through to the next loader
        errors.append(f"transformers.AutoTokenizer: {type(e).__name__}: {e}")
    try:
        from .sentencepiece_unigram import T5SentencePieceTokenizer

        return T5SentencePieceTokenizer.from_pretrained(name_or_path)
    except Exception as e:  # noqa: BLE001 — fall through to the strict/degraded decision below
        errors.append(f"T5SentencePieceTokenizer: {type(e).__name__}: {e}")
    if strict:
        raise RuntimeError(
            f"auto_tokenizer({name_or_path!r}, strict=True): no real vocab "
            "loadable:\n  " + "\n  ".join(errors)
        )
    if os.path.isdir(name_or_path):
        return ByteTokenizer.from_pretrained(name_or_path)
    return ByteTokenizer()
