"""Join: a reduce-side join of two tab-keyed text datasets.

Counterpart of ``tpumr/examples/join.py``: the mapper tags each record
with its side, which each line carries (``key<TAB>L|payload`` or
``key<TAB>R|payload``; an unmarked line is left), and the reducer crosses
a key's left and right payloads, inner or (``--outer``) full outer.
``-D key=value`` sets a job conf key (``tpumr_torch.device=cpu`` runs it on
the CPU).
"""

from __future__ import annotations

import argparse

from tpumr_torch.examples import (add_conf_option, apply_conf_option,
                                  register)
from tpumr_torch.mapred.api import Mapper, Reducer
from tpumr_torch.mapred.input_formats import TextInputFormat
from tpumr_torch.mapred.job_client import run_job
from tpumr_torch.mapred.jobconf import JobConf


class TaggedJoinMapper(Mapper):
    """Line ``"<key><TAB>L|payload"`` or ``"<key><TAB>R|payload"`` →
    ``(key, (side, payload))``; a line without a tab is dropped."""

    def map(self, key, value, output, reporter):
        s = value.decode() if isinstance(value, (bytes, bytearray)) else value
        k, _, rest = s.partition("\t")
        if not rest:
            return
        side, _, payload = rest.partition("|")
        if side not in ("L", "R"):
            side, payload = "L", rest
        output.collect(k, (side, payload))


def _sides(values) -> "tuple[list, list]":
    left, right = [], []
    for side, payload in values:
        (left if side == "L" else right).append(payload)
    return left, right


class InnerJoinReducer(Reducer):
    def reduce(self, key, values, output, reporter):
        left, right = _sides(values)
        for lp in left:
            for rp in right:
                output.collect(key, f"{lp}\t{rp}")


class OuterJoinReducer(Reducer):
    def reduce(self, key, values, output, reporter):
        left, right = _sides(values)
        for lp in left or [""]:
            for rp in right or [""]:
                output.collect(key, f"{lp}\t{rp}")


@register("join", "reduce-side join of two tab-keyed text datasets")
def join(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="tpumr_torch examples join")
    ap.add_argument("left", help="text input: key<TAB>L|payload")
    ap.add_argument("right", help="text input: key<TAB>R|payload")
    ap.add_argument("output")
    ap.add_argument("--outer", action="store_true")
    ap.add_argument("-r", "--reduces", type=int, default=1)
    add_conf_option(ap)
    args = ap.parse_args(argv)
    conf = JobConf()
    conf.set_job_name("join")
    conf.set_input_paths(args.left, args.right)
    conf.set_output_path(args.output)
    conf.set_input_format(TextInputFormat)
    conf.set_mapper_class(TaggedJoinMapper)
    conf.set_reducer_class(OuterJoinReducer if args.outer
                           else InnerJoinReducer)
    conf.set_num_reduce_tasks(args.reduces)
    apply_conf_option(conf, args.defs)
    return 0 if run_job(conf).successful else 1
