"""Per-round conf templating for iterative jobs.

Counterpart of ``tpumr/pipeline/graph.py:40-63`` (``expand_round`` and
``_ROUND_RE``). Iterative jobs version their state files per round
(``cents-r{round}.npy`` in, ``cents-r{next_round}.npy`` out) instead of
rewriting one path, which lets the device cache keep every round's side
input valid. ``JobGraph`` and the pipeline engine need the job master and
are not ported.
"""

from __future__ import annotations

import re
from typing import Any

_ROUND_RE = re.compile(r"\{(round|prev_round|next_round)\}")


def expand_round(conf: dict, rnd: int) -> dict:
    """Per-round conf: in every string value, ``{round}``,
    ``{prev_round}`` and ``{next_round}`` become ``rnd``, ``rnd-1`` and
    ``rnd+1``. Other values pass through untouched."""
    vals = {"round": rnd, "prev_round": rnd - 1, "next_round": rnd + 1}

    def sub(v: Any) -> Any:
        if isinstance(v, str) and "{" in v:
            return _ROUND_RE.sub(lambda m: str(vals[m.group(1)]), v)
        return v

    return {k: sub(v) for k, v in conf.items()}
