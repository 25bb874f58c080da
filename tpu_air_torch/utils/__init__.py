"""tpu_air_torch.utils — helpers shared across the port's packages, and the
reference's display and segmentation helpers (copies of ``tpu_air.utils``)."""

from .display import get_random_elements
from .segmentation import (
    ade_palette,
    convert_image_to_rgb,
    display_example_images,
    get_image_indices,
    get_labels,
    prepare_pixels_with_segmentation,
    visualize_predictions,
)

__all__ = [
    "ade_palette",
    "convert_image_to_rgb",
    "display_example_images",
    "get_image_indices",
    "get_labels",
    "get_random_elements",
    "prepare_pixels_with_segmentation",
    "visualize_predictions",
]
