"""JobGraph: a pipeline's description, its validation and its wire form.

Counterpart of ``tpumr/pipeline/graph.py``, whole. A pipeline is a DAG
whose nodes are job confs and whose edges are data dependencies, in one of
two modes:

``dfs`` (the default)
    The downstream stage reads the upstream stage's committed output
    directory and is submitted once the upstream job has committed. Its
    ``mapred.input.dir`` is wired by the engine when its conf names none.

``stream``
    The upstream reduce output is also written in map-output (IFile)
    framing and served over the shuffle wire; the downstream stage has one
    map per upstream partition, which fetches it from the runner serving
    it, and is submitted as soon as the upstream's first reduce commits.
    The upstream must have reduces and write SequenceFiles: its committed
    part files are what a lost stream falls back to.

A ``loop`` node is one job resubmitted round by round behind a round
barrier: round ``r + 1`` is submitted only after round ``r`` succeeded,
its convergence predicate (a counter threshold on the round job's summed
counters) did not hold, and ``max_rounds`` is not reached. Conf values may
hold ``{round}``, ``{prev_round}`` and ``{next_round}``, expanded per round
(:func:`expand_round`): iterative jobs version their state files per round
(``cents-r{round}.npy`` in, ``cents-r{next_round}.npy`` out) instead of
rewriting one path, which keeps every round's device-cache entry valid.

The wire form (:meth:`JobGraph.to_dict`) is the JAX package's dict, so a
graph written by either package loads in the other.
"""

from __future__ import annotations

import re
from typing import Any

#: comparators of the convergence predicate (counter value OP threshold)
_CONVERGE_OPS = {"lt", "le", "gt", "ge"}

#: node ids land in file names and job names
_ID_RE = re.compile(r"^[A-Za-z0-9_.\-]{1,64}$")

_ROUND_RE = re.compile(r"\{(round|prev_round|next_round)\}")


class PipelineError(ValueError):
    """A graph that fails validation: a cycle, a dangling edge, a duplicate
    id, a stream edge that cannot be served, a malformed loop spec."""


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


class JobGraph:
    """Assembles and validates one pipeline submission.

    >>> g = JobGraph("terasort-chain")
    >>> g.node("gen", gen_conf)
    >>> g.node("sort", sort_conf, conf_hook="pkg.mod.sample_hook")
    >>> g.node("validate", val_conf)
    >>> g.edge("gen", "sort")
    >>> g.edge("sort", "validate", stream=True)
    """

    def __init__(self, name: str = "", conf: "dict | None" = None) -> None:
        self.name = name
        #: pipeline-wide conf under every stage's own
        self.conf: dict = dict(conf or {})
        self.nodes: "dict[str, dict]" = {}
        self.edges: "list[dict]" = []

    # ------------------------------------------------------------ build

    def node(self, node_id: str, conf: dict,
             conf_hook: "str | None" = None) -> "JobGraph":
        """One job stage. ``conf_hook`` names an importable function
        ``fn(conf_dict, upstreams)`` that the master calls just before it
        submits the stage: the seam for preparation that needs the
        upstream output to exist (TeraSort's partition sampling)."""
        if node_id in self.nodes:
            raise PipelineError(f"duplicate node id {node_id!r}")
        if not _ID_RE.match(node_id or ""):
            raise PipelineError(f"bad node id {node_id!r} (want "
                                f"[A-Za-z0-9_.-], at most 64 characters)")
        self.nodes[node_id] = {"id": node_id, "conf": dict(conf),
                               "conf_hook": conf_hook}
        return self

    def loop(self, node_id: str, conf: dict, max_rounds: int,
             converge: "dict | None" = None,
             conf_hook: "str | None" = None) -> "JobGraph":
        """An iterative node: one job a round until ``converge``
        (``{"group": G, "counter": C, "op": lt|le|gt|ge, "value": V}`` over
        the round job's counters) holds, or ``max_rounds`` rounds ran."""
        self.node(node_id, conf, conf_hook)
        self.nodes[node_id]["loop"] = {
            "max_rounds": int(max_rounds),
            "converge": dict(converge) if converge else None,
        }
        return self

    def edge(self, src: str, dst: str, stream: bool = False) -> "JobGraph":
        self.edges.append({"src": src, "dst": dst, "stream": bool(stream)})
        return self

    # ------------------------------------------------------------- wire

    def to_dict(self) -> dict:
        return {"name": self.name, "conf": dict(self.conf),
                "nodes": [dict(n) for n in self.nodes.values()],
                "edges": [dict(e) for e in self.edges]}

    @staticmethod
    def from_dict(d: dict) -> "JobGraph":
        g = JobGraph(str(d.get("name", "") or ""), dict(d.get("conf") or {}))
        for n in d.get("nodes") or []:
            nid = str(n.get("id", ""))
            loop = n.get("loop")
            if loop:
                g.loop(nid, dict(n.get("conf") or {}),
                       int(loop.get("max_rounds", 1)), loop.get("converge"),
                       n.get("conf_hook"))
            else:
                g.node(nid, dict(n.get("conf") or {}), n.get("conf_hook"))
        for e in d.get("edges") or []:
            g.edge(str(e.get("src", "")), str(e.get("dst", "")),
                   bool(e.get("stream")))
        return g

    # ------------------------------------------------------- topology

    def upstreams(self, node_id: str) -> "list[dict]":
        return [e for e in self.edges if e["dst"] == node_id]

    def downstreams(self, node_id: str) -> "list[dict]":
        return [e for e in self.edges if e["src"] == node_id]

    def topo_order(self) -> "list[str]":
        """Kahn's order, ties by id; :class:`PipelineError` on a cycle,
        naming the nodes caught in it."""
        indeg = {nid: 0 for nid in self.nodes}
        for e in self.edges:
            indeg[e["dst"]] += 1
        ready = sorted(nid for nid, d in indeg.items() if d == 0)
        order: "list[str]" = []
        while ready:
            nid = ready.pop(0)
            order.append(nid)
            for e in self.downstreams(nid):
                indeg[e["dst"]] -= 1
                if indeg[e["dst"]] == 0:
                    ready.append(e["dst"])
            ready.sort()
        if len(order) != len(self.nodes):
            stuck = sorted(set(self.nodes) - set(order))
            raise PipelineError(f"cycle through nodes {stuck}")
        return order

    # ----------------------------------------------------- validation

    def validate(self) -> "JobGraph":
        """:class:`PipelineError` on anything the master could not run: a
        graph is refused whole at submission, never half run."""
        if not self.nodes:
            raise PipelineError("empty pipeline (no nodes)")
        for e in self.edges:
            for end in ("src", "dst"):
                if e[end] not in self.nodes:
                    raise PipelineError(
                        f"dangling edge endpoint {e[end]!r} "
                        f"({e['src']} -> {e['dst']})")
            if e["src"] == e["dst"]:
                raise PipelineError(f"self-edge on {e['src']!r} (iterate "
                                    f"with a loop node instead)")
        self.topo_order()
        for nid, n in self.nodes.items():
            conf = n["conf"]
            if not str(conf.get("mapred.output.dir") or ""):
                raise PipelineError(
                    f"node {nid!r} has no mapred.output.dir: every stage "
                    f"needs one (downstream wiring and the stream's "
                    f"fallback read the committed output)")
            loop = n.get("loop")
            if loop is not None:
                self._validate_loop(nid, loop)
            ins = self.upstreams(nid)
            modes = {bool(e["stream"]) for e in ins}
            if len(modes) > 1:
                raise PipelineError(
                    f"node {nid!r} mixes stream and dfs in-edges: a stage "
                    f"reads through one input format")
            if ins and modes == {True} \
                    and str(conf.get("mapred.input.dir") or ""):
                raise PipelineError(
                    f"node {nid!r} has stream in-edges and its own "
                    f"mapred.input.dir: streamed input is wired by the "
                    f"engine")
        for e in self.edges:
            if not e["stream"]:
                continue
            # a stream edge out of a loop node is legal: it streams once
            # the loop settles on its last round
            sconf = self.nodes[e["src"]]["conf"]
            if int(sconf.get("mapred.reduce.tasks", 1) or 0) < 1:
                raise PipelineError(
                    f"stream edge {e['src']} -> {e['dst']}: upstream is "
                    f"map-only, and the handoff serves reduce output (use a "
                    f"dfs edge)")
            out_fmt = str(sconf.get("mapred.output.format.class", "") or "")
            if "SequenceFileOutputFormat" not in out_fmt:
                raise PipelineError(
                    f"stream edge {e['src']} -> {e['dst']}: upstream must "
                    f"write SequenceFiles (got "
                    f"{out_fmt or 'the text default'}): its committed part "
                    f"files are the fallback of a lost stream")
        return self

    @staticmethod
    def _validate_loop(nid: str, loop: dict) -> None:
        if loop["max_rounds"] < 1:
            raise PipelineError(f"loop node {nid!r}: max_rounds must be "
                                f">= 1")
        conv = loop.get("converge")
        if conv is None:
            return
        missing = {"group", "counter", "op", "value"} - set(conv)
        if missing:
            raise PipelineError(f"loop node {nid!r}: converge spec is "
                                f"missing {sorted(missing)}")
        if conv["op"] not in _CONVERGE_OPS:
            raise PipelineError(f"loop node {nid!r}: converge op "
                                f"{conv['op']!r} not in "
                                f"{sorted(_CONVERGE_OPS)}")
        if isinstance(conv["value"], bool) or \
                not isinstance(conv["value"], (int, float)):
            # a string threshold would fail against the counter at every
            # advance and leave the pipeline running for ever
            raise PipelineError(f"loop node {nid!r}: converge value "
                                f"{conv['value']!r} must be a number")
