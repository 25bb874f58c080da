"""Built-in predictors of the port.

* ``T5GenerativePredictor`` — batched text generation from a T5 model, the
  counterpart of ``tpu_air.predict.predictors.T5GenerativePredictor``: runs
  :func:`tpu_air_torch.models.t5.generate.generate` on the model's device
  and decodes to a ``generated_output`` column.  Its constructors cast the
  weights to the inference type once, at load.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import pandas as pd
import torch

from tpu_air_torch.device import DeviceLike
from tpu_air_torch.predict.predictor import Predictor


class T5GenerativePredictor(Predictor):
    """Batched text generation from a T5 model."""

    def __init__(self, model, state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 tokenizer=None, preprocessor=None):
        super().__init__(preprocessor)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        self.model = model
        self.tokenizer = tokenizer

    @classmethod
    def from_checkpoint(cls, checkpoint, dtype: Optional[str] = "bfloat16",
                        device: DeviceLike = None,
                        tokenizer=None) -> "T5GenerativePredictor":
        """Build from a training checkpoint: the model from its config and
        parameters on ``device`` (``cuda:0`` by default), cast to ``dtype``
        once, here (``"bfloat16"``, the reference's half-precision load;
        None keeps f32); the checkpoint's tokenizer (``tokenizer``, a class,
        loads it with that class; an instance replaces it) and preprocessor."""
        model = checkpoint.get_model(dtype=dtype, device=device)
        if tokenizer is None or isinstance(tokenizer, type):
            tokenizer = checkpoint.get_tokenizer(tokenizer)
        return cls(model, tokenizer=tokenizer, preprocessor=checkpoint.get_preprocessor())

    @classmethod
    def from_pretrained(cls, path: str, dtype: str = "bfloat16",
                        device: DeviceLike = None, tokenizer=None,
                        preprocessor=None) -> "T5GenerativePredictor":
        """Build from a local HF directory (``config.json``,
        ``model.safetensors`` and a tokenizer).  ``dtype="bfloat16"`` is the
        reference's half-precision load; the model lives on ``device``
        (``cuda:0`` by default)."""
        from tpu_air_torch.models.t5.hf_import import load_t5
        from tpu_air_torch.models.tokenizer import auto_tokenizer

        model = load_t5(path, dtype=dtype, device=device)
        if tokenizer is None:
            tokenizer = auto_tokenizer(path, strict=True)
        return cls(model, tokenizer=tokenizer, preprocessor=preprocessor)

    def _predict_numpy(
        self,
        data: Dict[str, np.ndarray],
        feature_columns: Optional[List[str]] = None,
        max_new_tokens: int = 128,
        do_sample: bool = False,
        temperature: float = 1.0,
        top_k: int = 0,
        generator: Optional[torch.Generator] = None,
        **_: Any,
    ) -> pd.DataFrame:
        from tpu_air_torch.models.t5.generate import generate

        if feature_columns:
            data = {k: v for k, v in data.items() if k in feature_columns}
        seqs = generate(
            self.model,
            np.asarray(data["input_ids"]),
            attention_mask=data.get("attention_mask"),
            max_new_tokens=max_new_tokens,
            do_sample=do_sample,
            temperature=temperature,
            top_k=top_k,
            generator=generator,
        ).cpu().numpy()
        if self.tokenizer is not None:
            texts = self.tokenizer.batch_decode(seqs, skip_special_tokens=True)
        else:
            texts = [" ".join(map(str, row)) for row in seqs]
        return pd.DataFrame({"generated_output": texts})
