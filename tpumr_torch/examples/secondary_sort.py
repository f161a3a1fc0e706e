"""SecondarySort: values in order inside each reduce group.

Counterpart of ``tpumr/examples/secondary_sort.py``: the map key is the
pair ``(first, second)``; partitions and reduce groups follow ``first``
alone (:class:`FirstPartitioner`, :class:`FirstGroupingComparator` as the
job's grouping comparator), while the merge orders whole pairs, so each
group's values come with ``second`` ascending. ``-D key=value`` sets a job
conf key (``tpumr_torch.device=cpu`` runs it on the CPU).
"""

from __future__ import annotations

import argparse
import zlib

from tpumr_torch.examples import (add_conf_option, apply_conf_option,
                                  register)
from tpumr_torch.io.writable import deserialize, serialize
from tpumr_torch.mapred.api import Mapper, Partitioner, Reducer
from tpumr_torch.mapred.input_formats import TextInputFormat
from tpumr_torch.mapred.job_client import run_job
from tpumr_torch.mapred.jobconf import JobConf


class FirstPartitioner(Partitioner):
    """The partition of the pair's first element alone."""

    def get_partition(self, key, value, num_partitions):
        return zlib.crc32(serialize(key[0])) % num_partitions


class FirstGroupingComparator:
    """Groups pairs by their first element."""

    def sort_key(self, kbytes: bytes):
        return deserialize(kbytes)[0]


class PairMapper(Mapper):
    """Line ``"<first> <second>"`` → key ``(first, second)``, value
    ``second``; lines of fewer fields are dropped."""

    def map(self, key, value, output, reporter):
        s = value.decode() if isinstance(value, (bytes, bytearray)) else value
        parts = s.split()
        if len(parts) >= 2:
            first, second = int(parts[0]), int(parts[1])
            output.collect((first, second), second)


class SortedValuesReducer(Reducer):
    """``(first, [seconds in ascending order])``."""

    def reduce(self, key, values, output, reporter):
        output.collect(key[0], list(values))


@register("secondarysort", "sort values within reduce groups")
def secondarysort(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="tpumr_torch examples secondarysort")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("-r", "--reduces", type=int, default=1)
    add_conf_option(ap)
    args = ap.parse_args(argv)
    conf = JobConf()
    conf.set_job_name("secondarysort")
    conf.set_input_paths(*args.input.split(","))
    conf.set_output_path(args.output)
    conf.set_input_format(TextInputFormat)
    conf.set_mapper_class(PairMapper)
    conf.set_reducer_class(SortedValuesReducer)
    conf.set_partitioner_class(FirstPartitioner)
    conf.set_output_value_grouping_comparator(FirstGroupingComparator)
    conf.set_num_reduce_tasks(args.reduces)
    apply_conf_option(conf, args.defs)
    return 0 if run_job(conf).successful else 1
