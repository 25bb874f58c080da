"""Segmentation visualization helpers.

Capability parity with the reference's segmentation utils
(Supplementary_resources/Semantic_segmentation/utils.py:14-232): the ADE20K
151-color palette, prediction overlays, and example-image display.  Pure
host-side numpy/PIL; matplotlib is imported lazily and only needed for the
display helpers.  Copied from ``tpu_air/utils/segmentation.py`` with its own
copy of ``ade20k.json``: the port imports nothing of ``tpu_air``.
"""

from __future__ import annotations

import random
from typing import List, Optional, Sequence

import numpy as np


# The standard ADE20K visualization colormap (151 rows: background black +
# 150 class colors) and the SceneParse150 class names live in ade20k.json
# next to this module — public DATA (the colormap originates from the
# TensorFlow models repo's DeepLab get_dataset_colormap, the same source
# the reference's utils.py:14 cites; the names are objectInfo150's first
# synonyms).  Shipping them literally makes overlays color-identical to
# the reference's for the same class map, offline.  Loaded lazily and
# memoized so importing this module never does file I/O and a missing data
# file only fails the functions that need it.
import json as _json
import os as _os

_ADE20K: Optional[dict] = None


def _ade20k() -> dict:
    global _ADE20K
    if _ADE20K is None:
        with open(_os.path.join(
                _os.path.dirname(_os.path.abspath(__file__)),
                "ade20k.json")) as f:
            _ADE20K = _json.load(f)
    return _ADE20K


def ade_palette() -> List[List[int]]:
    """The real ADE20K 151-color RGB table ([0,0,0] background + 150 class
    colors) — color-identical to the reference's utils.py:14 for the same
    class map."""
    return [list(c) for c in _ade20k()["palette"]]


def get_labels() -> List[str]:
    """The real SceneParse150 label names in id order.  The reference
    fetches these from the HF hub (utils.py:41 id2label.json); they are
    shipped literally here so offline runs see real names."""
    return list(_ade20k()["labels"])


def convert_image_to_rgb(image):
    """RGB-mode normalizer (reference utils.py:229-232)."""
    if hasattr(image, "convert"):
        return image.convert("RGB")
    arr = np.asarray(image)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    return arr


def prepare_pixels_with_segmentation(
    image,
    seg_map: np.ndarray,
    palette: Optional[Sequence[Sequence[int]]] = None,
    alpha: float = 0.5,
) -> np.ndarray:
    """Overlay a predicted class map onto the image (utils.py overlay helper):
    color each class by the palette and alpha-blend with the source pixels."""
    img = np.asarray(convert_image_to_rgb(image), dtype=np.float32)
    seg_map = np.asarray(seg_map)
    pal = np.asarray(palette if palette is not None else ade_palette(), np.float32)
    color = pal[np.clip(seg_map, 0, len(pal) - 1)]
    out = (1 - alpha) * img + alpha * color
    return out.astype(np.uint8)


def get_image_indices(n_total: int, n_samples: int, seed: Optional[int] = None) -> List[int]:
    """Random sample of image indices (reference utils.py sampling helper);
    raises when over-sampling, like the text-side get_random_elements
    (Text_generation/utils.py:7-27)."""
    if n_samples > n_total:
        raise ValueError(f"cannot sample {n_samples} from {n_total} images")
    r = random.Random(seed)
    return sorted(r.sample(range(n_total), n_samples))


def visualize_predictions(
    images: Sequence,
    seg_maps: Sequence[np.ndarray],
    palette: Optional[Sequence[Sequence[int]]] = None,
    save_path: Optional[str] = None,
):
    """Side-by-side image/overlay grid (reference utils.py:visualize_*).
    Returns the matplotlib figure; saves instead of showing when save_path
    is given (headless-friendly)."""
    if save_path:  # headless save — don't disturb an interactive backend
        import matplotlib

        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(images)
    fig, axes = plt.subplots(n, 2, figsize=(8, 3 * n), squeeze=False)
    for i, (im, sm) in enumerate(zip(images, seg_maps)):
        axes[i][0].imshow(np.asarray(convert_image_to_rgb(im)))
        axes[i][0].set_title("image")
        axes[i][1].imshow(prepare_pixels_with_segmentation(im, sm, palette))
        axes[i][1].set_title("prediction")
        for ax in axes[i]:
            ax.axis("off")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path)
    return fig


def display_example_images(images: Sequence, n: int = 4, seed: Optional[int] = None,
                           save_path: Optional[str] = None):
    """Grid of sampled dataset images (reference utils.py:display_example_images)."""
    if save_path:  # headless save — don't disturb an interactive backend
        import matplotlib

        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    idx = get_image_indices(len(images), min(n, len(images)), seed)
    fig, axes = plt.subplots(1, len(idx), figsize=(3 * len(idx), 3), squeeze=False)
    for ax, i in zip(axes[0], idx):
        ax.imshow(np.asarray(convert_image_to_rgb(images[i])))
        ax.axis("off")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path)
    return fig
