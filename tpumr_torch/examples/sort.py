"""Sort: the generic sort benchmark's job over SequenceFile records.

Counterpart of ``tpumr/examples/sort.py``: identity map and identity
reduce, so the records go through the host shuffle's spills and merges
unchanged. With ``--total-order`` it samples 1,000 keys
(``total_order.sample_input``), writes ``<output>.partitions``
(``write_partition_file``) and partitions by range
(``TotalOrderPartitioner``), so the part files in order are sorted as a
whole. ``-D key=value`` sets a job conf key (``tpumr_torch.device=cpu``
runs it on the CPU, ``io.sort.mb`` sizes the map buffer).
"""

from __future__ import annotations

import argparse

from tpumr_torch.examples import (add_conf_option, apply_conf_option,
                                  register)
from tpumr_torch.mapred.api import IdentityMapper, IdentityReducer
from tpumr_torch.mapred.input_formats import SequenceFileInputFormat
from tpumr_torch.mapred.job_client import run_job
from tpumr_torch.mapred.jobconf import JobConf
from tpumr_torch.mapred.output_formats import SequenceFileOutputFormat
from tpumr_torch.mapred.total_order import (TotalOrderPartitioner,
                                            sample_input,
                                            write_partition_file)


@register("sort", "sort SequenceFile records (identity map/reduce)")
def sort(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="tpumr_torch examples sort")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("-r", "--reduces", type=int, default=2)
    ap.add_argument("--total-order", action="store_true",
                    help="globally sort via sampled range partitioning")
    add_conf_option(ap)
    args = ap.parse_args(argv)
    conf = JobConf()
    conf.set_job_name("sorter")
    conf.set_input_paths(*args.input.split(","))
    conf.set_output_path(args.output)
    conf.set_input_format(SequenceFileInputFormat)
    conf.set_output_format(SequenceFileOutputFormat)
    conf.set_mapper_class(IdentityMapper)
    conf.set_reducer_class(IdentityReducer)
    conf.set_num_reduce_tasks(args.reduces)
    apply_conf_option(conf, args.defs)
    if args.total_order:
        samples = sample_input(conf, num_samples=1000)
        write_partition_file(conf, args.output.rstrip("/") + ".partitions",
                             samples, args.reduces)
        conf.set_partitioner_class(TotalOrderPartitioner)
    return 0 if run_job(conf).successful else 1
