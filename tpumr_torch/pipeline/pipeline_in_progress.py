"""PipelineInProgress: the master's state of one pipeline.

Counterpart of ``tpumr/pipeline/pipeline_in_progress.py`` (``:45-332``).
The job master's pipeline-advance thread calls :meth:`plan_locked` under
the master's pipeline lock; it folds each running stage's job outcome into
its node and returns the (node, round) submissions now due, each node
marked ``SUBMITTING`` so that a concurrent pass cannot submit it twice. The
master builds and submits them outside the lock (conf hooks and split
computation do I/O) and reports back with :meth:`record_submitted` or
:meth:`record_submit_failed`.

A stage is ready when:

- it has no in-edges: at submission;
- it has ``dfs`` in-edges: every upstream node succeeded and its job's
  output is committed;
- it has ``stream`` in-edges only: every upstream node's job has committed
  at least one reduce (a loop upstream must first settle on its last
  round); the downstream maps wait on the handoff feed for the rest.

A loop node runs one job a round. After a round succeeds the convergence
predicate is read on the round job's counters: the node settles when it
holds or ``max_rounds`` rounds ran, else the next round is submitted with
its ``{round}``-expanded conf.

Restart recovery (``:228-247, 333-372``): the master journals
``PIPELINE_SUBMITTED`` (the whole graph) and one
``PIPELINE_STAGE_SUBMITTED`` per stage job in the pipeline's own history
file, and :meth:`PipelineInProgress.from_recovery` replays them, each stage
job id followed through the master's recovery alias (a stage job the
restart resubmitted is watched under its new id). A stage job that only
history remembers (it ended before the restart) is settled from its log,
never run again: :meth:`plan_locked` returns it as unresolved, the master
reads its outcome outside the lock (:meth:`_retired_state`) and feeds it
back through :meth:`apply_retired`. A loop whose finished round is known
only from history goes on to its next round, since that round's counters
died with the old master. Stages never submitted are submitted as usual.

Left out: the pipeline's trace root.
"""

from __future__ import annotations

import time
from typing import Any

from tpumr_torch.pipeline.graph import JobGraph, expand_round


class PipelineState:
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    KILLED = "KILLED"
    TERMINAL = {SUCCEEDED, FAILED, KILLED}


class NodeState:
    PENDING = "PENDING"
    SUBMITTING = "SUBMITTING"   # a submission is in flight outside the lock
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    SKIPPED = "SKIPPED"         # the pipeline ended before this stage ran
    TERMINAL = {SUCCEEDED, FAILED, SKIPPED}


class _Node:
    __slots__ = ("spec", "state", "round", "jobs", "job_id", "output_dir",
                 "num_reduces", "error")

    def __init__(self, spec: dict) -> None:
        self.spec = spec
        self.state = NodeState.PENDING
        self.round = 0
        #: every job this node submitted, in order (a loop's rounds)
        self.jobs: "list[str]" = []
        #: the current (or last) round's job
        self.job_id = ""
        #: the output directory of that job
        self.output_dir = ""
        self.num_reduces = 0
        self.error = ""

    @property
    def is_loop(self) -> bool:
        return self.spec.get("loop") is not None

    def round_conf(self, pipeline_conf: dict, rnd: int) -> dict:
        conf = dict(pipeline_conf)
        conf.update(self.spec["conf"])
        return expand_round(conf, rnd) if self.is_loop else conf


class PipelineInProgress:
    def __init__(self, pipeline_id: str, graph: JobGraph,
                 user: str = "") -> None:
        self.pipeline_id = pipeline_id
        self.graph = graph
        self.user = user
        self.state = PipelineState.RUNNING
        self.error = ""
        #: also the scheduler's anchor: stage jobs take it as their FIFO
        #: submit time, so a late stage never queues behind jobs submitted
        #: while the early stages ran
        self.start_time = time.time()
        self.finish_time = 0.0
        self.nodes: "dict[str, _Node]" = {
            nid: _Node(spec) for nid, spec in graph.nodes.items()}
        self.order = graph.topo_order()
        #: claimed by the one caller that runs the terminal bookkeeping
        self.finished_recorded = False

    # --------------------------------------------------------- queries

    def status_dict(self) -> dict:
        return {
            "pipeline_id": self.pipeline_id,
            "name": self.graph.name,
            "state": self.state,
            "error": self.error,
            "start_time": self.start_time,
            "finish_time": self.finish_time,
            "nodes": {nid: {
                "state": n.state,
                "round": n.round,
                "rounds_run": len(n.jobs),
                "job_id": n.job_id,
                "jobs": list(n.jobs),
                "output_dir": n.output_dir,
                "error": n.error,
            } for nid, n in self.nodes.items()},
        }

    # ------------------------------------------------------- readiness

    def _upstream_ready(self, master: Any, nid: str) -> bool:
        """Every in-edge of ``nid`` satisfied: its upstream node succeeded,
        and for a dfs edge the upstream job's output is committed."""
        for e in self.graph.upstreams(nid):
            up = self.nodes[e["src"]]
            if up.state != NodeState.SUCCEEDED:
                return False
            if e["stream"]:
                continue
            jip = master.jobs.get(up.job_id)
            if jip is not None and not jip.finalized.is_set():
                return False   # output not committed yet
        return True

    def _stream_ready(self, master: Any, nid: str) -> bool:
        """Early readiness of a node with stream in-edges only: each
        upstream settled which job serves (a loop: its last round) and
        that job committed a reduce."""
        ins = self.graph.upstreams(nid)
        if not ins or not all(e["stream"] for e in ins):
            return False
        for e in ins:
            up = self.nodes[e["src"]]
            if up.state == NodeState.SUCCEEDED:
                continue
            if up.is_loop or up.state != NodeState.RUNNING:
                # a loop's current round may not be its last
                return False
            jip = master.jobs.get(up.job_id)
            if jip is None or jip.finished_reduces < 1:
                return False
        return True

    # --------------------------------------------------------- advance

    def plan_locked(self, master: Any
                    ) -> "tuple[list[tuple[str, int]], list[tuple[str, str]]]":
        """Fold the running stages' job outcomes into their nodes and
        return ``(plans, unresolved)``: the (node, round) submissions now
        due, each node marked ``SUBMITTING``, and the (node, job id) pairs
        whose job only history remembers, for the caller to resolve
        outside the lock and feed back to :meth:`apply_retired`. The
        caller holds the master's pipeline lock; this does no I/O."""
        if self.state in PipelineState.TERMINAL:
            return [], []
        plans: "list[tuple[str, int]]" = []
        unresolved: "list[tuple[str, str]]" = []
        for nid in self.order:
            n = self.nodes[nid]
            if n.state == NodeState.RUNNING:
                jip = master.jobs.get(n.job_id)
                if jip is None:
                    unresolved.append((nid, n.job_id))
                else:
                    self._fold_job_outcome(nid, n, jip, plans)
            if n.state == NodeState.PENDING \
                    and (self._upstream_ready(master, nid)
                         or self._stream_ready(master, nid)):
                n.state = NodeState.SUBMITTING
                plans.append((nid, n.round))
        if self.state == PipelineState.RUNNING and all(
                n.state == NodeState.SUCCEEDED for n in self.nodes.values()):
            self.state = PipelineState.SUCCEEDED
            self.finish_time = time.time()
        return plans, unresolved

    def _fold_job_outcome(self, nid: str, n: _Node, jip: Any,
                          plans: "list[tuple[str, int]]") -> None:
        """One running node's current job: settle, iterate or fail. A job
        counts as ended once its output is committed or aborted."""
        if not jip.finalized.is_set():
            return
        st = jip.state
        if st == "SUCCEEDED":
            if n.is_loop and not self._loop_settled(n, jip):
                n.round += 1
                n.state = NodeState.SUBMITTING
                plans.append((nid, n.round))
                return
            n.state = NodeState.SUCCEEDED
        elif st in ("FAILED", "KILLED"):
            n.state = NodeState.FAILED
            n.error = jip.error or f"stage job {n.job_id} {st}"
            self.fail(f"stage {nid!r} {st.lower()}: {n.error}")

    def apply_retired(self, nid: str, state: str) -> None:
        """One stage outcome read from history (the caller holds the
        pipeline lock again). A loop cannot read the finished round's
        counters, so it goes on toward ``max_rounds``."""
        n = self.nodes.get(nid)
        if n is None or n.state != NodeState.RUNNING:
            return
        if state == "SUCCEEDED":
            if n.is_loop and n.round + 1 < int(
                    n.spec["loop"]["max_rounds"]):
                n.round += 1
                n.state = NodeState.PENDING
            else:
                n.state = NodeState.SUCCEEDED
        elif state in ("FAILED", "KILLED"):
            n.state = NodeState.FAILED
            n.error = f"stage job {n.job_id} {state} (history)"
            self.fail(f"stage {nid!r} {state.lower()}: {n.error}")

    @staticmethod
    def _retired_state(master: Any, job_id: str) -> str:
        """The end of a stage job that only history remembers, or
        ``RUNNING`` while it holds none."""
        if not job_id:
            return "RUNNING"
        st = master.history.retired_job_status(job_id)
        return str(st["state"]) if st and st.get("state") else "RUNNING"

    def _loop_settled(self, n: _Node, jip: Any) -> bool:
        """The loop is done: the predicate holds on the finished round's
        counters, or ``max_rounds`` rounds ran."""
        loop = n.spec["loop"]
        if n.round + 1 >= int(loop["max_rounds"]):
            return True
        conv = loop.get("converge")
        if not conv:
            return False
        value = jip.counters.value(str(conv["group"]), str(conv["counter"]))
        threshold = conv["value"]
        op = conv["op"]
        return (value < threshold if op == "lt" else
                value <= threshold if op == "le" else
                value > threshold if op == "gt" else
                value >= threshold)

    def fail(self, error: str) -> None:
        """To FAILED with ``error``; the stages not yet running are
        skipped."""
        if self.state in PipelineState.TERMINAL:
            return
        self.state = PipelineState.FAILED
        self.error = self.error or error
        self.finish_time = time.time()
        for n in self.nodes.values():
            if n.state in (NodeState.PENDING, NodeState.SUBMITTING):
                n.state = NodeState.SKIPPED

    def record_submitted(self, nid: str, rnd: int, job_id: str,
                         output_dir: str, num_reduces: int) -> bool:
        """A planned submission landed (the caller holds the pipeline lock
        again). False when the pipeline ended while it was in flight: the
        caller must kill the job it just submitted."""
        n = self.nodes[nid]
        n.jobs.append(job_id)
        n.job_id = job_id
        n.round = rnd
        n.output_dir = output_dir
        n.num_reduces = num_reduces
        if n.state == NodeState.SUBMITTING:
            n.state = NodeState.RUNNING
            return True
        return False

    def record_submit_failed(self, nid: str, error: str) -> None:
        n = self.nodes[nid]
        n.state = NodeState.FAILED
        n.error = error
        self.fail(f"stage {nid!r} submission failed: {error}")

    def kill(self) -> "list[str]":
        """Mark KILLED; returns the running stage jobs, which the caller
        kills outside the pipeline lock."""
        if self.state in PipelineState.TERMINAL:
            return []
        self.state = PipelineState.KILLED
        self.finish_time = time.time()
        return self.settle_running("killed with pipeline")

    def settle_running(self, error: str) -> "list[str]":
        """Every node still running or waiting ends (running: FAILED with
        ``error``, waiting: SKIPPED), since nothing folds a node of an
        ended pipeline again; returns the running nodes' jobs."""
        victims = []
        for n in self.nodes.values():
            if n.state == NodeState.RUNNING:
                if n.job_id:
                    victims.append(n.job_id)
                n.state = NodeState.FAILED
                n.error = n.error or error
            if n.state in (NodeState.PENDING, NodeState.SUBMITTING):
                n.state = NodeState.SKIPPED
        return victims

    # -------------------------------------------------------- recovery

    @staticmethod
    def from_recovery(pipeline_id: str, graph_dict: dict,
                      stage_events: "list[dict]", master: Any,
                      user: str = "") -> "PipelineInProgress":
        """Rebuild an interrupted pipeline from its journal: each stage
        submission replayed through the master's recovery alias, stages
        that history shows ended settled without running again, the rest
        left to the usual advance."""
        pip = PipelineInProgress(pipeline_id, JobGraph.from_dict(graph_dict),
                                 user=user)
        for ev in stage_events:
            n = pip.nodes.get(str(ev.get("node", "")))
            if n is None:
                continue
            job_id = str(ev.get("stage_job_id", ""))
            job_id = master.get_recovered_jobs().get(job_id, job_id)
            n.jobs.append(job_id)
            n.job_id = job_id
            n.round = int(ev.get("round", 0) or 0)
            n.output_dir = str(ev.get("output_dir", "") or "")
            n.num_reduces = int(ev.get("num_reduces", 0) or 0)
            n.state = NodeState.RUNNING
        for nid, n in pip.nodes.items():
            if n.state == NodeState.RUNNING \
                    and master.jobs.get(n.job_id) is None:
                pip.apply_retired(nid, pip._retired_state(master, n.job_id))
        return pip
