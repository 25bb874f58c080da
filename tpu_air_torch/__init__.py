"""tpu_air_torch — the PyTorch/CUDA port of tpu_air for NVIDIA Hopper.

Imports torch, numpy, the standard library and (for the trainers' pandas
datasets) pandas, never jax or tpu_air.
Subpackages mirror tpu_air's layout (``models.t5``, ``models.lm``, ``ops``,
``parallel``, ``predict``, ``train``) and are imported explicitly; importing
this package builds nothing.
"""

__version__ = "0.1.0"
