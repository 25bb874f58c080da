"""Forkserver preload set of the port's runtime (the counterpart of
``tpu_air/core/worker_preload.py``).

Worker processes fork from a forkserver that has already imported the
heavy module graph below (torch alone takes seconds), so each worker starts
in milliseconds instead of paying the imports again.  A fork of the driver
itself is not an option once the driver has initialized CUDA: the child
inherits a CUDA context it cannot use.

Modules only: nothing here may initialize CUDA or touch a device; each
worker initializes its own CUDA context on first use.
"""
# airlint: disable-file=RT003 — every preload import is optional: a failure
# here only means the worker pays that import lazily on first use

try:  # noqa: SIM105
    import numpy  # noqa: F401
except Exception:
    pass
try:
    import pandas  # noqa: F401
except Exception:
    pass
try:
    import torch  # noqa: F401
except Exception:
    pass
try:
    # a trainer's first optimizer step imports dynamo (and the distributed
    # tensor ops it registers) lazily: about 2 s a process
    import torch._dynamo  # noqa: F401
except Exception:
    pass
try:
    import tpu_air_torch.core.runtime  # noqa: F401
except Exception:
    pass
