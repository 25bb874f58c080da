"""Device choice for the port's entry points.

The port runs on the card.  An entry point that is given no device takes
``cuda:<first leased id>`` inside an actor of the port's runtime that holds
a chip lease (``num_chips``; the id wrapped onto the cards where the runtime
has more slots than cards), and ``cuda:0`` anywhere else; where there is
no CUDA device it raises rather than carry on on the CPU, which would run
the plain versions in place of the kernels.  A caller that wants the CPU
(the tests) says so with ``device="cpu"``.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The named device; else ``cuda:<first leased id mod cards>`` in a
    leased actor and ``cuda:0`` elsewhere.  Raises when CUDA is absent and no device was
    named."""
    if device is not None:
        return torch.device(device)
    from tpu_air_torch.core.runtime import current_worker

    worker = current_worker()
    lease = worker.chip_ids if worker is not None else []
    if not torch.cuda.is_available():
        where = f"this actor leased devices {lease} but " if lease else ""
        raise RuntimeError(
            f"tpu_air_torch runs on a CUDA device and {where}none is available; "
            "pass device='cpu' to run the plain PyTorch versions of its "
            "kernels on the CPU"
        )
    # lease ids index the runtime's chip slots; a runtime with more slots
    # than cards wraps them onto the cards, as ``parallel.mesh.visible_devices``
    return torch.device("cuda", lease[0] % torch.cuda.device_count() if lease else 0)
