"""Example programs and their dispatcher.

Counterpart of ``tpumr/examples/__init__.py``: a name -> program registry
that the CLI dispatches to (``python -m tpumr_torch.cli examples <name>
<args>``). Each program is a function ``main(argv: list[str]) -> int``. Only
the programs the port has are loaded; any other name is an unknown
program (rc 255), as in the JAX package.
"""

from __future__ import annotations

import sys
from typing import Callable

_PROGRAMS: dict[str, tuple[Callable[[list[str]], int], str]] = {}


def register(name: str, description: str):
    def deco(fn):
        _PROGRAMS[name] = (fn, description)
        return fn
    return deco


def programs() -> dict[str, str]:
    _load_all()
    return {k: v[1] for k, v in sorted(_PROGRAMS.items())}


def _load_all() -> None:
    # imported for their registrations
    from tpumr_torch.examples import basic, terasort  # noqa: F401


def main(argv: list[str]) -> int:
    """Dispatch by program name."""
    _load_all()
    if not argv or argv[0] in ("-h", "--help", "help"):
        print("Valid program names are:", file=sys.stderr)
        for name, desc in programs().items():
            print(f"  {name}: {desc}", file=sys.stderr)
        return 0 if argv else 255
    name, *rest = argv
    if name not in _PROGRAMS:
        print(f"Unknown program '{name}'", file=sys.stderr)
        for prog, desc in programs().items():
            print(f"  {prog}: {desc}", file=sys.stderr)
        return 255
    return _PROGRAMS[name][0](rest)
