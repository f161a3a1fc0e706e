"""Streaming jobs: options to a job conf wired to the child-process
runners, and the ``streaming`` command.

Counterpart of ``tpumr/streaming/stream_job.py``: ``-mapper``,
``-reducer``, ``-combiner``, ``-input``, ``-output``,
``-numReduceTasks``, ``-io text|typedbytes`` and ``-jobconf``/``-D``.
``-reducer aggregate`` runs ``mapred/lib``'s ``ValueAggregatorReducer``
with ``ValueAggregatorCombiner``, over the script mapper's
``<TYPE>:<id><TAB>value`` lines.
"""

from __future__ import annotations

from tpumr_torch.mapred.jobconf import JobConf

#: the four directions that ``-io`` sets at once
IO_KEYS = ("stream.map.input", "stream.map.output", "stream.reduce.input",
           "stream.reduce.output")


def setup_stream_job(conf: JobConf, mapper: "str | None" = None,
                     reducer: "str | None" = None,
                     combiner: "str | None" = None,
                     io: "str | None" = None) -> None:
    from tpumr_torch.streaming.pipe_runner import (StreamCombiner,
                                                   StreamMapRunner,
                                                   StreamReducer)
    if mapper:
        conf.set("stream.map.command", mapper)
        conf.set_map_runner_class(StreamMapRunner)
    if reducer == "aggregate":
        from tpumr_torch.mapred.lib import (ValueAggregatorCombiner,
                                            ValueAggregatorReducer)
        conf.set_reducer_class(ValueAggregatorReducer)
        conf.set_combiner_class(ValueAggregatorCombiner)
    elif reducer:
        conf.set("stream.reduce.command", reducer)
        conf.set_reducer_class(StreamReducer)
    if combiner:
        conf.set("stream.combine.command", combiner)
        conf.set_combiner_class(StreamCombiner)
    if io:
        if io not in ("text", "typedbytes"):
            raise ValueError(f"unknown -io format {io!r} "
                             "(expected text or typedbytes)")
        for key in IO_KEYS:
            conf.set(key, io)


class StreamJob:
    """A streaming job built in code."""

    def __init__(self) -> None:
        self.conf = JobConf()

    def set_mapper(self, cmd: str) -> "StreamJob":
        setup_stream_job(self.conf, mapper=cmd)
        return self

    def set_reducer(self, cmd: str) -> "StreamJob":
        setup_stream_job(self.conf, reducer=cmd)
        return self

    def set_combiner(self, cmd: str) -> "StreamJob":
        setup_stream_job(self.conf, combiner=cmd)
        return self

    def run(self):
        from tpumr_torch.mapred.job_client import run_job
        return run_job(self.conf)


def main(argv: "list[str]") -> int:
    """The ``streaming`` command; 0 when the job succeeded."""
    import argparse
    ap = argparse.ArgumentParser(prog="tpumr_torch streaming")
    ap.add_argument("-input", dest="input", required=True, action="append")
    ap.add_argument("-output", dest="output", required=True)
    ap.add_argument("-mapper", dest="mapper", default=None)
    ap.add_argument("-reducer", dest="reducer", default=None)
    ap.add_argument("-combiner", dest="combiner", default=None)
    ap.add_argument("-numReduceTasks", dest="reduces", type=int, default=1)
    ap.add_argument("-io", dest="io", default=None,
                    choices=["text", "typedbytes"])
    ap.add_argument("-jobconf", "-D", dest="jobconf", action="append",
                    default=[])
    args = ap.parse_args(argv)

    conf = JobConf()
    conf.set_input_paths(*args.input)
    conf.set_output_path(args.output)
    conf.set_num_reduce_tasks(args.reduces)
    for kv in args.jobconf:
        k, _, v = kv.partition("=")
        conf.set(k.strip(), v.strip())
    setup_stream_job(conf, mapper=args.mapper, reducer=args.reducer,
                     combiner=args.combiner, io=args.io)
    from tpumr_torch.mapred.job_client import run_job
    return 0 if run_job(conf).successful else 1
