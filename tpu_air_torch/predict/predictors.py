"""Built-in predictors of the port.

* ``T5GenerativePredictor`` — batched text generation from a T5 model, the
  counterpart of ``tpu_air.predict.predictors.T5GenerativePredictor``: runs
  :func:`tpu_air_torch.models.t5.generate.generate` on the model's device
  and decodes to a ``generated_output`` column.  Its constructors cast the
  weights to the inference type once, at load.
* ``LMGenerativePredictor`` — batched generation from a causal-LM
  checkpoint, the counterpart of ``tpu_air.predict.predictors.
  LMGenerativePredictor``: equal-length, un-padded prompts through
  :func:`tpu_air_torch.models.lm.generate.generate` on the model's device.
* ``TorchPredictor`` — the generic forward pass ``apply_fn(params,
  **features)`` (the JAX package's ``JaxPredictor``, under the reference's
  name), with the checkpoint's state dict and the features on the device.
* ``SemanticSegmentationPredictor`` — SegFormer batch inference (W7), the
  counterpart of ``tpu_air.predict.predictors.SemanticSegmentationPredictor``:
  feature-extract on the host, the forward on the model's device under
  ``torch.inference_mode()``, ``post_process_semantic_segmentation`` on
  the logits where they lie, per-image class maps at each image's size.
* ``GBDTPredictor`` — the ``XGBoostPredictor`` analog over the host-side
  estimator ``GBDTTrainer`` checkpoints (``HistGBDT`` or sklearn), copied
  from the JAX package: numpy, no card.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional

import numpy as np
import pandas as pd
import torch

from tpu_air_torch.device import DeviceLike, resolve_device
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


class LMGenerativePredictor(Predictor):
    """Batched text generation from a causal-LM checkpoint (``LMTrainer``'s
    output): the decoder-only sibling of :class:`T5GenerativePredictor`."""

    def __init__(self, model, tokenizer=None, preprocessor=None):
        super().__init__(preprocessor)
        self.model = model
        self.tokenizer = tokenizer
        self._calls = 0

    @classmethod
    def from_checkpoint(cls, checkpoint, *, tokenizer=None, dtype: Optional[str] = None,
                        device: DeviceLike = None) -> "LMGenerativePredictor":
        """The model from the checkpoint (the port's or the JAX package's
        format) on ``device`` (``cuda:0`` by default), its weights cast to
        ``dtype`` once, here (None keeps f32); the checkpoint's tokenizer,
        or none: token-id corpora train without one, and generation then
        returns id strings."""
        model = checkpoint.get_model(dtype=dtype, device=device)
        if tokenizer is None or isinstance(tokenizer, type):
            try:
                tokenizer = checkpoint.get_tokenizer(tokenizer)
            except FileNotFoundError:
                tokenizer = None
        return cls(model, tokenizer, checkpoint.get_preprocessor())

    def _predict_numpy(
        self,
        data: Dict[str, np.ndarray],
        feature_columns: Optional[List[str]] = None,
        max_new_tokens: int = 64,
        do_sample: bool = False,
        temperature: float = 1.0,
        top_k: int = 0,
        seed: int = 0,
        **_: Any,
    ) -> pd.DataFrame:
        from tpu_air_torch.models.lm.generate import generate

        if feature_columns:
            data = {k: v for k, v in data.items() if k in feature_columns}
        try:
            input_ids = np.stack([np.asarray(r) for r in data["input_ids"]])
        except ValueError as e:
            raise ValueError(
                "LMGenerativePredictor needs EQUAL-LENGTH prompts per batch "
                "(the decode cache is positional): bucket rows by length "
                f"before predict ({e})"
            ) from None
        if (input_ids == self.model.config.pad_token_id).any():
            # padded prompts would feed pad tokens as real context and
            # sample the first token from a pad position's logits
            raise ValueError(
                "LMGenerativePredictor prompts must be un-padded; strip pad "
                "tokens and bucket rows to equal lengths"
            )
        # vary sampling noise across batches deterministically: a generator
        # seeded from (seed, calls), the JAX package's per-call fold-in
        self._calls += 1
        generator = torch.Generator(self.model.device)
        generator.manual_seed(int(np.random.SeedSequence([seed, self._calls]).generate_state(1)[0]))
        toks = generate(
            self.model, input_ids, max_new_tokens=max_new_tokens, do_sample=do_sample,
            temperature=temperature, top_k=top_k,
            eos_token_id=getattr(self.model.config, "eos_token_id", None),
            generator=generator,
        ).cpu().numpy()
        if self.tokenizer is not None:
            texts = self.tokenizer.batch_decode(toks, skip_special_tokens=True)
        else:
            texts = [" ".join(map(str, row)) for row in toks]
        return pd.DataFrame({"generated_output": texts})


class TorchPredictor(Predictor):
    """Generic forward-pass predictor: ``apply_fn(params, **features)``,
    where ``params`` is a state dict on the predictor's device and each
    feature a tensor there; the output comes back as a numpy column."""

    def __init__(self, apply_fn: Callable, params: Mapping[str, torch.Tensor],
                 preprocessor=None, output_column: str = "predictions",
                 device: DeviceLike = None):
        super().__init__(preprocessor)
        self.device = resolve_device(device)
        self.apply_fn = apply_fn
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.output_column = output_column

    @classmethod
    def from_checkpoint(cls, checkpoint, *, apply_fn: Callable, dtype=None,
                        device: DeviceLike = None) -> "TorchPredictor":
        """The checkpoint's state dict (floating tensors cast to ``dtype``
        once, here) on ``device`` (``cuda:0`` by default) and its fitted
        preprocessor."""
        return cls(apply_fn, checkpoint.get_params(dtype=dtype), checkpoint.get_preprocessor(),
                   device=device)

    def _predict_numpy(self, data: Dict[str, np.ndarray], **kwargs) -> pd.DataFrame:
        feats = {k: torch.as_tensor(np.asarray(v)).to(self.device) for k, v in data.items()}
        with torch.inference_mode():
            out = self.apply_fn(self.params, **feats, **kwargs)
        out = out.cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
        if out.ndim > 1 and out.shape[-1] == 1:
            out = out[..., 0]
        col = list(out) if out.ndim > 1 else out
        return pd.DataFrame({self.output_column: col})


class SemanticSegmentationPredictor(Predictor):
    """SegFormer batch-inference predictor (the reference's custom
    ``SemanticSegmentationPredictor`` analog,
    Scaling_batch_inference.ipynb:cc-73): feature-extract → forward →
    ``post_process_semantic_segmentation`` → per-image class maps.

    Pre-processing runs on the host; the forward runs NHWC on the model's
    device under ``torch.inference_mode()``, and the logits are resized to
    each image's size and reduced to class ids there, so only the int32
    maps cross back to the host."""

    def __init__(self, model, feature_extractor=None, preprocessor=None,
                 output_column: str = "predicted_mask"):
        super().__init__(preprocessor)
        if feature_extractor is None:
            from tpu_air_torch.models.segformer import SegformerImageProcessor

            feature_extractor = SegformerImageProcessor()
        self.model = model.eval()
        self.feature_extractor = feature_extractor
        self.output_column = output_column

    @classmethod
    def from_checkpoint(cls, checkpoint, *, feature_extractor=None, dtype: Optional[str] = None,
                        device: DeviceLike = None) -> "SemanticSegmentationPredictor":
        """The model from the checkpoint's config, parameters and batch-norm
        stats on ``device`` (``cuda:0``, or the leased card in an actor, by
        default), cast to ``dtype`` once, here; the feature extractor given,
        else the one in the checkpoint's extras, else a default one."""
        model = checkpoint.get_model(dtype=dtype, device=device)
        if feature_extractor is None:
            feature_extractor = (checkpoint._load_extras() or {}).get("feature_extractor")
        # NB: deliberately does NOT attach the checkpoint's train-time
        # preprocessor — the reference's segmentation predictor consumes raw
        # images and applies its feature extractor inside _predict_pandas
        # (Scaling_batch_inference.ipynb:cc-73); the fitted-preprocessor
        # auto-apply contract belongs to the tabular/text predictors.
        return cls(model, feature_extractor=feature_extractor)

    def _predict_pandas(self, data: pd.DataFrame, **_: Any) -> pd.DataFrame:
        from tpu_air_torch.models.segformer.image_processor import (
            _to_numpy_image,
            collate_pixel_batch,
        )

        if "pixel_values" in data.columns:
            px = collate_pixel_batch(data["pixel_values"])
            sizes = [tuple(px.shape[1:3])] * len(px)
        else:
            col = "image" if "image" in data.columns else data.columns[0]
            # normalize layout first — raw CHW arrays would otherwise yield
            # (channels, height) target sizes
            images = [_to_numpy_image(im) for im in data[col]]
            sizes = [im.shape[:2] for im in images]
            px = self.feature_extractor(images)["pixel_values"]
        device = self.model.device
        x = torch.from_numpy(np.ascontiguousarray(px, np.float32))   # a fresh stack: writable
        if device.type == "cuda":
            x = x.pin_memory()
        with torch.inference_mode():
            logits = self.model(x.to(device, non_blocking=True))
            maps = self.feature_extractor.post_process_semantic_segmentation(
                logits, target_sizes=sizes)
        return pd.DataFrame({self.output_column: maps})


class GBDTPredictor(Predictor):
    """XGBoostPredictor analog: host-side GBDT scoring (Introduction…ipynb:cc-57)."""

    def __init__(self, model, preprocessor=None):
        super().__init__(preprocessor)
        self.model = model

    @classmethod
    def from_checkpoint(cls, checkpoint, **_: Any) -> "GBDTPredictor":
        model = checkpoint.get_model(device="cpu")
        if isinstance(model, torch.nn.Module):  # a T5 / LM checkpoint
            raise TypeError("checkpoint does not contain a GBDT/sklearn model")
        return cls(model, checkpoint.get_preprocessor())

    def _predict_pandas(self, data: pd.DataFrame, **_: Any) -> pd.DataFrame:
        X = data.to_numpy(dtype=np.float32)
        if hasattr(self.model, "predict_proba"):
            preds = self.model.predict_proba(X)[:, 1]
        else:
            preds = self.model.predict(X)
        return pd.DataFrame({"predictions": preds})


class SklearnPredictor(GBDTPredictor):
    """Alias family for generic sklearn estimators stored in checkpoints."""


#: Drop-in alias matching the reference import name (Introduction…ipynb:cc-57)
XGBoostPredictor = GBDTPredictor
