"""Key/value configuration with typed getters.

Counterpart of ``tpumr/core/configuration.py``, trimmed to what the port's
jobs and its command line use: a defaults layer, resource layers over it in
the order they were added (dicts, ``.json`` or ``.toml`` files, nested TOML
tables flattened to dotted keys; ``:54-90`` there), process-wide default
resources that every new configuration starts with, explicit ``set()``
values over all of them, the typed getters and class-valued keys, and
``${var}`` expansion in :meth:`Configuration.get` (``:112-133``): a string
value's ``${name}`` is taken from another key, then from the environment,
and one that resolves to neither is left as written, up to ``_MAX_SUBST``
rounds; the typed getters read through ``get`` and so see the expanded
value. Left out: deprecations and size suffixes. The key strings are the
JAX package's, so a job configuration written for it reads the same here.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Mapping

from tpumr_torch.utils.reflection import class_name, resolve_class

_TRUE = {"true", "yes", "on", "1"}
_FALSE = {"false", "no", "off", "0"}
_VAR_PAT = re.compile(r"\$\{([^}$\s]+)\}")
#: rounds of expansion before a value is returned as it stands
_MAX_SUBST = 20


class Configuration:
    """Explicit values over resource layers over a defaults layer, parsed
    on read."""

    #: process-wide default resources, copied into every new configuration
    #: that is not a copy of another (the command line's generic options)
    _default_resources: "list[dict[str, Any]]" = []

    def __init__(self, other: "Configuration | None" = None,
                 defaults: "Mapping[str, Any] | None" = None) -> None:
        self._defaults: dict[str, Any] = dict(defaults or {})
        self._resources: "list[dict[str, Any]]" = []
        self._values: dict[str, Any] = {}
        if other is not None:
            self._defaults.update(other._defaults)
            self._resources = [dict(r) for r in other._resources]
            self._values = dict(other._values)
        else:
            self._resources = [dict(r)
                               for r in Configuration._default_resources]

    @classmethod
    def add_default_resource(cls,
                             resource: "Mapping[str, Any] | str") -> None:
        """A process-wide layer for every configuration made after it: a
        dict, or a path to a ``.json`` or ``.toml`` file."""
        cls._default_resources.append(
            cls._load_file(resource) if isinstance(resource, str)
            else dict(resource))

    def add_resource(self, resource: "Mapping[str, Any] | str") -> None:
        """A layer over the earlier ones: a dict, or a path to a ``.json``
        or ``.toml`` file."""
        self._resources.append(
            self._load_file(resource) if isinstance(resource, str)
            else dict(resource))

    @staticmethod
    def _load_file(path: str) -> dict[str, Any]:
        with open(path, "rb") as f:
            data = f.read()
        if path.endswith(".toml"):
            import tomllib
            flat: dict[str, Any] = {}

            def walk(prefix: str, node: Any) -> None:
                if isinstance(node, dict):
                    for k, v in node.items():
                        walk(f"{prefix}.{k}" if prefix else k, v)
                else:
                    flat[prefix] = node

            walk("", tomllib.loads(data.decode("utf-8")))
            return flat
        return json.loads(data.decode("utf-8"))

    def _raw(self, key: str) -> Any:
        if key in self._values:
            return self._values[key]
        for res in reversed(self._resources):
            if key in res:
                return res[key]
        if key in self._defaults:
            return self._defaults[key]
        raise KeyError(key)

    def get(self, key: str, default: Any = None) -> Any:
        try:
            val = self._raw(key)
        except KeyError:
            return default
        return self._substitute(val) if isinstance(val, str) else val

    def _substitute(self, val: str) -> str:
        for _ in range(_MAX_SUBST):
            m = _VAR_PAT.search(val)
            if m is None:
                return val
            name = m.group(1)
            try:
                rep = self._raw(name)
            except KeyError:
                rep = os.environ.get(name)
            if rep is None:
                return val   # unresolvable: left as written
            val = val[:m.start()] + str(rep) + val[m.end():]
        return val

    def set(self, key: str, value: Any) -> None:
        self._values[key] = value

    def __iter__(self):
        """(key, value) of every key, each from its topmost layer."""
        merged = dict(self._defaults)
        for res in self._resources:
            merged.update(res)
        merged.update(self._values)
        return iter(merged.items())

    def get_int(self, key: str, default: int = 0) -> int:
        v = self.get(key)
        if v is None:
            return default
        if isinstance(v, str):
            s = v.strip()
            # decimal by default (leading zeros OK); 0x/0o/0b prefixes honored
            return int(s, 0) if s[1:2] in ("x", "o", "b") and s[:1] == "0" \
                else int(s, 10)
        return int(v)

    def get_float(self, key: str, default: float = 0.0) -> float:
        v = self.get(key)
        return default if v is None else float(v)

    def get_boolean(self, key: str, default: bool = False) -> bool:
        v = self.get(key)
        if v is None:
            return default
        if isinstance(v, bool):
            return v
        s = str(v).strip().lower()
        if s in _TRUE:
            return True
        if s in _FALSE:
            return False
        return default

    def get_strings(self, key: str) -> list[str]:
        v = self.get(key)
        if v is None:
            return []
        if isinstance(v, (list, tuple)):
            return [str(x) for x in v]
        return [s.strip() for s in str(v).split(",") if s.strip()]

    def get_class(self, key: str, default: "type | None" = None
                  ) -> "type | None":
        v = self.get(key)
        if v is None:
            return default
        if isinstance(v, type):
            return v
        return resolve_class(str(v))

    def set_class(self, key: str, cls: type) -> None:
        """The dotted name when it resolves back to ``cls``, else the
        class object itself (in-process jobs only)."""
        name = class_name(cls)
        try:
            importable = resolve_class(name) is cls
        except (ImportError, TypeError):
            importable = False
        self.set(key, name if importable else cls)
