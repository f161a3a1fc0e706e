"""Example programs and their dispatcher.

Counterpart of ``tpumr/examples/__init__.py``: a name -> program registry
that the CLI dispatches to (``python -m tpumr_torch.cli examples <name>
<args>``). Each program is a function ``main(argv: list[str]) -> int``. Only
the programs the port has are loaded; any other name is an unknown
program (rc 255), as in the JAX package.
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, Callable

_PROGRAMS: dict[str, tuple[Callable[[list[str]], int], str]] = {}


def register(name: str, description: str):
    def deco(fn):
        _PROGRAMS[name] = (fn, description)
        return fn
    return deco


def add_conf_option(ap: argparse.ArgumentParser) -> None:
    """``-D key=value`` for the job conf, as the port's programs take it."""
    ap.add_argument("-D", dest="defs", action="append", default=[],
                    metavar="k=v", help="set a job conf key "
                    "(tpumr_torch.device=cpu runs on the CPU)")


def apply_conf_option(conf: Any, defs: "list[str]") -> None:
    for kv in defs:
        k, _, v = kv.partition("=")
        conf.set(k.strip(), v.strip())


def programs() -> dict[str, str]:
    _load_all()
    return {k: v[1] for k, v in sorted(_PROGRAMS.items())}


def _load_all() -> None:
    # imported for their registrations
    from tpumr_torch.examples import (basic, join,  # noqa: F401
                                      random_writer, secondary_sort, sleep,
                                      sort, terasort)


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
