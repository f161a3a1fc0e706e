"""Command line of the port: ``python -m tpumr_torch.cli examples <name>
<args>``.

Counterpart of the ``examples`` subcommand of ``tpumr/cli.py``
(``cmd_examples``); the port has no other subcommand yet.
"""

from __future__ import annotations

import sys

USAGE = "usage: python -m tpumr_torch.cli examples <program> [args]"


def main(argv: "list[str] | None" = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] != "examples":
        print(USAGE, file=sys.stderr)
        return 255
    from tpumr_torch.examples import main as ex_main
    return ex_main(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
