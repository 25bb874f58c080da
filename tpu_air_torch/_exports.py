"""How the port's packages export their names.

:func:`lazy_exports` makes a package's module-level ``__getattr__``: its
exported names load at first use, so that importing a package imports no
model, kernel wrapper or collective it does not need.

:func:`make_callable` makes a module its own function.  The JAX package's
``tpu_air.ops`` and ``tpu_air.models.t5`` export the functions
``flash_attention``, ``ring_attention`` and ``generate`` under the names
that the port's modules defining them have.  A package attribute is either
the module or the function, so those three modules are made callable:
``from tpu_air_torch.ops import flash_attention`` gives the module, which
calls its function of the same name, and its other attributes (the plain
versions, the counters) stay where they are.
"""

from __future__ import annotations

import importlib
import sys
import types
from typing import Dict, Sequence


def lazy_exports(package: str, exports: Dict[str, str], submodules: Sequence[str] = ()):
    """A ``__getattr__`` for ``package`` that imports ``exports``' names
    (name -> submodule defining it) and its ``submodules`` at first use."""
    def __getattr__(name):
        if name in submodules:
            return importlib.import_module(f"{package}.{name}")
        if name in exports:
            value = getattr(importlib.import_module(f"{package}.{exports[name]}"), name)
            setattr(sys.modules[package], name, value)
            return value
        raise AttributeError(f"module {package!r} has no attribute {name!r}")
    return __getattr__


class _CallableModule(types.ModuleType):
    def __call__(self, *args, **kwargs):
        # looked up at each call: a test that replaces the function is seen
        return getattr(self, self.__name__.rsplit(".", 1)[1])(*args, **kwargs)


def make_callable(module_name: str) -> None:
    """Calls of module ``module_name`` go to its function of the module's
    own last name."""
    sys.modules[module_name].__class__ = _CallableModule
