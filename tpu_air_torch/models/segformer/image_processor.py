"""SegFormer image (pre)processor, a copy of
``tpu_air/models/segformer/image_processor.py`` that resizes with torch in
place of PIL.

Capability target: the reference's `SegformerImageProcessor` /
`SegformerFeatureExtractor` usage — `do_reduce_labels=True` preprocessing for
ADE20K fine-tuning (Scaling_model_training.ipynb:cc-38,42) and
`post_process_semantic_segmentation` at inference
(Scaling_batch_inference.ipynb:cc-42).

Preprocessing runs on the host (numpy and torch on the CPU), NHWC output for
the model.  The resizes stand in for PIL's:

* uint8 images: ``F.interpolate(bilinear, antialias=True,
  align_corners=False)`` on a uint8 channels-last tensor (PIL's BILINEAR,
  which widens its filter when it shrinks: within 1 grey level of it);
* label maps: ``nearest-exact`` (PIL's NEAREST samples pixel centres too:
  the same labels), through float64 for ids above 255 (exact);
* float images and logits: bilinear with ``antialias=True`` in float32.

``post_process_semantic_segmentation`` also takes a torch tensor and then
resizes and takes the argmax on the tensor's device (the card, in the
predictor), copying only the class maps to the host.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _to_numpy_image(img) -> np.ndarray:
    """Accept PIL / numpy HWC / numpy CHW; return uint8-or-float HWC RGB."""
    if hasattr(img, "convert"):  # PIL
        img = np.asarray(img.convert("RGB"))
    img = np.asarray(img)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    if img.ndim == 3 and img.shape[0] in (1, 3) and img.shape[-1] not in (1, 3):
        img = np.transpose(img, (1, 2, 0))  # CHW → HWC
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    return img


def _tensor(a: np.ndarray) -> torch.Tensor:
    """``a`` as a CPU tensor, copied only when it is read-only (as arrays
    from the object store are) or not contiguous."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _resize_nhwc(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear resize of a [B, H, W, C] tensor (uint8 or float), PIL's
    BILINEAR: half-pixel centres, the filter widened when shrinking."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)


def _resize(img: np.ndarray, h: int, w: int, nearest: bool) -> np.ndarray:
    if nearest:
        return _resize_labels(img, h, w)
    x = _tensor(img)
    if x.dtype != torch.uint8:
        x = x.float()
    return _resize_nhwc(x[None], h, w)[0].numpy()


def _resize_labels(lbl: np.ndarray, h: int, w: int) -> np.ndarray:
    """Nearest-neighbour resize of a 2-D label map, in its own type; ids above
    255 go through float64, which holds them exactly."""
    x = _tensor(lbl)[None, None]
    if x.dtype != torch.uint8:
        x = x.double()
    y = F.interpolate(x, size=(h, w), mode="nearest-exact")[0, 0]
    return y.numpy().astype(lbl.dtype)


class SegformerImageProcessor:
    """Resize → rescale → normalize images; resize(nearest) → reduce labels."""

    def __init__(
        self,
        do_resize: bool = True,
        size: Union[int, Dict[str, int], Tuple[int, int]] = 512,
        do_rescale: bool = True,
        rescale_factor: float = 1.0 / 255.0,
        do_normalize: bool = True,
        image_mean: Sequence[float] = IMAGENET_MEAN,
        image_std: Sequence[float] = IMAGENET_STD,
        do_reduce_labels: bool = False,
        data_format: str = "channels_last",
    ):
        if isinstance(size, int):
            size = (size, size)
        elif isinstance(size, dict):
            size = (size["height"], size["width"])
        self.size = tuple(size)
        self.do_resize = do_resize
        self.do_rescale = do_rescale
        self.rescale_factor = rescale_factor
        self.do_normalize = do_normalize
        self.image_mean = np.asarray(image_mean, np.float32)
        self.image_std = np.asarray(image_std, np.float32)
        self.do_reduce_labels = do_reduce_labels
        self.data_format = data_format

    # -- single-image paths -------------------------------------------------
    def _process_image(self, img) -> np.ndarray:
        img = _to_numpy_image(img)
        if self.do_resize:
            img = _resize(img, self.size[0], self.size[1], nearest=False)
        img = img.astype(np.float32)
        if self.do_rescale:
            img = img * self.rescale_factor
        if self.do_normalize:
            img = (img - self.image_mean) / self.image_std
        if self.data_format == "channels_first":
            img = np.transpose(img, (2, 0, 1))
        return img

    def _process_label(self, lbl) -> np.ndarray:
        if hasattr(lbl, "convert"):
            lbl = np.asarray(lbl.convert("L") if lbl.mode not in ("I", "L") else lbl)
        lbl = np.asarray(lbl)
        if lbl.ndim == 3:
            lbl = lbl[..., 0]
        if self.do_reduce_labels:
            # ADE20K convention: 0 = "background/unlabeled" → ignore(255);
            # classes shift down by one.
            lbl = lbl.astype(np.int32)
            lbl = np.where(lbl == 0, 255, lbl - 1)
        if self.do_resize:
            # uint8 is enough for ADE20K (150 classes + ignore=255) but
            # truncates ids > 255 — keep int32 through the resize then
            lbl = np.asarray(lbl)
            if lbl.max(initial=0) < 256:
                lbl = _resize(lbl.astype(np.uint8), self.size[0], self.size[1], nearest=True)
            else:
                lbl = _resize(lbl.astype(np.int32), self.size[0], self.size[1], nearest=True)
        return lbl.astype(np.int32)

    # -- batch entry point --------------------------------------------------
    def __call__(
        self,
        images,
        segmentation_maps=None,
        return_tensors: str = "np",
        **_: Any,
    ) -> Dict[str, np.ndarray]:
        if not isinstance(images, (list, tuple)):
            images = [images]
        out = {"pixel_values": np.stack([self._process_image(i) for i in images])}
        if segmentation_maps is not None:
            if not isinstance(segmentation_maps, (list, tuple)):
                segmentation_maps = [segmentation_maps]
            out["labels"] = np.stack([self._process_label(m) for m in segmentation_maps])
        return out

    preprocess = __call__

    # -- postprocessing -----------------------------------------------------
    def post_process_semantic_segmentation(
        self,
        logits,
        target_sizes: Optional[List[Tuple[int, int]]] = None,
    ) -> List[np.ndarray]:
        """(B, h, w, L) NHWC logits → per-image (H, W) int class maps.

        Mirrors the reference's
        `feature_extractor.post_process_semantic_segmentation(outputs, sizes)`
        (Scaling_batch_inference.ipynb:cc-42): bilinear-upsample logits to each
        target size, then argmax.  ``logits`` is a numpy array (resized on
        the CPU) or a torch tensor, resized on its own device; the maps come
        back as int32 numpy arrays.
        """
        if isinstance(logits, torch.Tensor):
            logits = logits.float()
        else:
            logits = _tensor(np.asarray(logits, np.float32))
        results = []
        for i in range(logits.shape[0]):
            lg = logits[i : i + 1]
            if target_sizes is not None:
                h, w = target_sizes[i]
                lg = _resize_nhwc(lg, int(h), int(w))
            results.append(lg[0].argmax(-1).to(torch.int32).cpu().numpy())
        return results


def collate_pixel_batch(values) -> np.ndarray:
    """Stack per-row pixel arrays into one NHWC float32 batch, accepting CHW
    rows (torch-layout data) — the single home of the layout heuristic shared
    by the trainer collate and the segmentation predictor."""
    px = np.stack([np.asarray(v, dtype=np.float32) for v in values])
    if px.ndim == 4 and px.shape[1] in (1, 3) and px.shape[-1] not in (1, 3):
        px = px.transpose(0, 2, 3, 1)
    return px


# The reference imports both names (Scaling_batch_inference.ipynb:cc-24).
SegformerFeatureExtractor = SegformerImageProcessor
