"""Fault injection: probabilistic faults at named points of the runtime.

Counterpart of ``tpumr/utils/fi.py`` (the whole module but the
``failure_class`` stamp of ``maybe_fail``, which waits for the failure
classes of ``ROADMAP.md`` §1 item 3). A seam calls ``maybe_fail(point,
conf)``; with nothing configured that is one conf lookup.

Keys of one point:
  tpumr.fi.<point>.probability   fault probability (0, the default,
                                 disables it)
  tpumr.fi.<point>.max.failures  stop after N fires in this process (0:
                                 no limit)
Global:
  tpumr.fi.seed                  seeds one random stream per (seed,
                                 point) in this process, so a run replays
                                 its faults bit for bit; unset, the draws
                                 come from the unseeded ``random`` module

The port's seams are the shuffle's, at qualified names, so that one map's
output or one attempt generation can be targeted:
  shuffle.serve / shuffle.serve.m<map index> / shuffle.serve.a<attempt no>
                                 the runner serving a map output
                                 (``NodeRunner._maybe_fail_serve``)
  shuffle.fetch / shuffle.fetch.m<map index>
                                 the reduce's fetch
                                 (``ShuffleCopier._copy_one``)
  reduce.task                    the start of a reduce attempt
                                 (``reduce_task.run_reduce_task``)
"""

from __future__ import annotations

import random
import threading
from typing import Any

_lock = threading.Lock()
_fired: dict[str, int] = {}
#: one seeded stream per (seed, point), so that points drawn from
#: different threads never shift each other's sequence
_rngs: dict[tuple[str, str], random.Random] = {}


class InjectedFault(RuntimeError):
    """Raised at a point whose probability model fired."""


def reset() -> None:
    with _lock:
        _fired.clear()
        _rngs.clear()


def _random(point: str, conf: Any) -> float:
    """One draw from the (seed, point) stream when ``tpumr.fi.seed`` is
    set, else from the unseeded module stream."""
    seed = conf.get("tpumr.fi.seed") if conf is not None else None
    if seed in (None, ""):
        return random.random()
    key = (str(seed), point)
    with _lock:
        rng = _rngs.get(key)
        if rng is None:
            rng = _rngs[key] = random.Random(f"{seed}:{point}")
        return rng.random()


def fired(point: str) -> int:
    """How many times ``point`` fired in this process."""
    with _lock:
        return _fired.get(point, 0)


def fires(point: str, conf: Any = None) -> bool:
    """Draw ``point``'s probability model without raising; counts a fire
    as :func:`maybe_fail` does."""
    if conf is None:
        return False
    p = conf.get(f"tpumr.fi.{point}.probability")
    if not p:
        return False
    if _random(point, conf) >= float(p):
        return False
    limit = int(conf.get(f"tpumr.fi.{point}.max.failures", 0) or 0)
    with _lock:
        if limit and _fired.get(point, 0) >= limit:
            return False
        _fired[point] = _fired.get(point, 0) + 1
    return True


def maybe_fail(point: str, conf: Any = None) -> None:
    """Raise :class:`InjectedFault` when ``point``'s model fires."""
    if fires(point, conf):
        raise InjectedFault(f"injected fault at {point}")
