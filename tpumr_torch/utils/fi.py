"""Fault injection: probabilistic faults at named points of the runtime.

Counterpart of ``tpumr/utils/fi.py``, the whole module. A seam calls
``maybe_fail(point, conf)``; with nothing configured that is one conf
lookup. ``failure_class`` stamps the raised fault with a class of
``mapred/task.FailureClass``, so that a seam stands in for a device or
compile error; :func:`fires` draws a point without raising, for a fault
that is a behaviour (a hang) rather than an exception.

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

The port's seams, at qualified names, so that one map's output, one attempt
generation or one card can be targeted:
  shuffle.serve / shuffle.serve.m<map index> / shuffle.serve.a<attempt no>
                                 the runner serving a map output
                                 (``NodeRunner._maybe_fail_serve``)
  shuffle.fetch / shuffle.fetch.m<map index>
                                 the reduce's fetch
                                 (``ShuffleCopier._copy_one``)
  reduce.task                    the start of a reduce attempt
                                 (``reduce_task.run_reduce_task``)
  tpu.compile                    raises classed ``compile`` before an
                                 accelerator attempt stages its split
                                 (``gpu_runner._maybe_fail_accelerator``)
  tpu.execute / tpu.execute.d<id>
                                 raises classed ``device`` there, on any
                                 card or on card ``id`` only
  task.hang / task.hang.m<idx>   a behaviour: the map stops reporting
                                 progress and polls only the kill flag
                                 (``map_task._hang_silently``), until the
                                 node runner's reaper fails it after
                                 ``mapred.task.timeout``
  task.slow / task.slow.m<idx>   a behaviour: the map is a straggler for
                                 ``tpumr.fi.task.slow.ms``, reporting
                                 creeping progress and polling the kill
                                 flag (``map_task._run_slowly``), the
                                 target of speculation
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


def maybe_fail(point: str, conf: Any = None,
               failure_class: str = "") -> None:
    """Raise :class:`InjectedFault` when ``point``'s model fires, stamped
    with ``failure_class`` where one is given."""
    if fires(point, conf):
        e = InjectedFault(f"injected fault at {point}")
        if failure_class:
            e.failure_class = failure_class  # type: ignore[attr-defined]
        raise e
