"""Device choice for the port's entry points.

The port runs on the card.  An entry point that is given no device takes
``cuda:0``; where there is no CUDA device it raises rather than carry on on
the CPU, which would run the plain versions in place of the kernels.  A
caller that wants the CPU (the tests) says so with ``device="cpu"``.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``cuda:0`` unless the caller names a device; raises when CUDA is
    absent and none was named."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "tpu_air_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions of its "
            "kernels on the CPU"
        )
    return torch.device("cuda", 0)
