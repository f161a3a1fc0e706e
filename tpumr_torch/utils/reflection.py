"""Class resolution helpers: dotted class names from configuration to
classes and configured instances.

Counterpart of ``tpumr/utils/reflection.py``, trimmed to what the K-Means
job path uses.
"""

from __future__ import annotations

import importlib
from typing import Any


def resolve_class(name: str) -> type:
    """Resolve 'pkg.mod.Class' or 'pkg.mod.Outer.Inner' to the class."""
    parts = name.split(".")
    for split in range(len(parts) - 1, 0, -1):
        try:
            obj: Any = importlib.import_module(".".join(parts[:split]))
        except ImportError:
            continue
        try:
            for attr in parts[split:]:
                obj = getattr(obj, attr)
        except AttributeError:
            continue
        if isinstance(obj, type):
            return obj
        raise TypeError(f"{name} resolved to non-class {obj!r}")
    raise ImportError(f"cannot resolve class {name!r}")


def class_name(cls: type) -> str:
    return f"{cls.__module__}.{cls.__qualname__}"


def new_instance(cls: "type | str", conf: Any = None) -> Any:
    """Instantiate, then ``configure(conf)`` when the object has it."""
    if isinstance(cls, str):
        cls = resolve_class(cls)
    obj = cls()
    if conf is not None and hasattr(obj, "configure"):
        obj.configure(conf)
    return obj
