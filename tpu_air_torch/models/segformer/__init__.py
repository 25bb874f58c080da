"""PyTorch SegFormer model family (counterpart of tpu_air.models.segformer).

Covers the reference's semantic-segmentation workloads W6/W7
(Scaling_model_training.ipynb, Scaling_batch_inference.ipynb).
"""

from .config import SegformerConfig
from .hf_import import (
    config_from_hf,
    convert_segformer_state_dict,
    load_segformer_from_hf,
)
from .image_processor import (
    SegformerFeatureExtractor,
    SegformerImageProcessor,
)
from .modeling import (
    SegformerForImageClassification,
    SegformerForSemanticSegmentation,
    segmentation_loss,
)

__all__ = [
    "SegformerConfig",
    "SegformerForImageClassification",
    "SegformerForSemanticSegmentation",
    "SegformerImageProcessor",
    "SegformerFeatureExtractor",
    "segmentation_loss",
    "config_from_hf",
    "convert_segformer_state_dict",
    "load_segformer_from_hf",
]
