"""RandomWriter: random SequenceFile records, the Sort benchmark's input.

Counterpart of ``tpumr/examples/random_writer.py``: a map-only job whose
maps each write about ``--bytes-per-map`` bytes of records with random
widths and random bytes to their own part file. Map ``m`` draws from
``numpy.random.default_rng(1234 + m)``, so the records are the JAX
package's from the same seeds (the files are not: each SequenceFile writer
draws its own sync marker). ``-D tpumr_torch.device=cpu`` runs it on the
CPU; without it the job asks for ``cuda``, though its maps are host work.
"""

from __future__ import annotations

import argparse

import numpy as np

from tpumr_torch.examples import (add_conf_option, apply_conf_option,
                                  register)
from tpumr_torch.fs.filesystem import FileSystem
from tpumr_torch.mapred.api import Mapper
from tpumr_torch.mapred.input_formats import NLineInputFormat
from tpumr_torch.mapred.job_client import run_job
from tpumr_torch.mapred.jobconf import JobConf
from tpumr_torch.mapred.output_formats import SequenceFileOutputFormat


class RandomWriteMapper(Mapper):
    """Input line ``"<seed> <total_bytes>"``: random records until their
    keys and values reach ``total_bytes``; key widths from
    ``tpumr.randomwriter.min.key`` to ``.max.key`` (10-100), values from
    ``.min.value`` to ``.max.value`` (0-1000)."""

    def configure(self, conf) -> None:
        self._min_key = conf.get_int("tpumr.randomwriter.min.key", 10)
        self._max_key = conf.get_int("tpumr.randomwriter.max.key", 100)
        self._min_val = conf.get_int("tpumr.randomwriter.min.value", 0)
        self._max_val = conf.get_int("tpumr.randomwriter.max.value", 1000)

    def map(self, key, value, output, reporter):
        s = value.decode() if isinstance(value, (bytes, bytearray)) else value
        seed, total = (int(x) for x in s.split())
        rng = np.random.default_rng(seed)
        written = 0
        while written < total:
            klen = int(rng.integers(self._min_key, self._max_key + 1))
            vlen = int(rng.integers(self._min_val, self._max_val + 1))
            kb = rng.integers(0, 256, size=klen, dtype=np.uint8).tobytes()
            vb = rng.integers(0, 256, size=vlen, dtype=np.uint8).tobytes()
            output.collect(kb, vb)
            written += klen + vlen


@register("randomwriter", "each map writes random SequenceFile records")
def randomwriter(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="tpumr_torch examples randomwriter")
    ap.add_argument("output")
    ap.add_argument("-m", "--maps", type=int, default=2)
    ap.add_argument("--bytes-per-map", type=int, default=1 << 20)
    add_conf_option(ap)
    args = ap.parse_args(argv)
    out = args.output.rstrip("/")
    inp = f"{out}.rw-in/maps.txt"
    FileSystem.get(inp).write_bytes(
        inp, "".join(f"{1234 + m} {args.bytes_per_map}\n"
                     for m in range(args.maps)).encode())
    conf = JobConf()
    conf.set_job_name("random-writer")
    conf.set_input_paths(inp)
    conf.set_output_path(out)
    conf.set_input_format(NLineInputFormat)
    conf.set("mapred.line.input.format.linespermap", 1)
    conf.set_mapper_class(RandomWriteMapper)
    conf.set_output_format(SequenceFileOutputFormat)
    conf.set_num_reduce_tasks(0)
    apply_conf_option(conf, args.defs)
    ok = run_job(conf).successful
    FileSystem.get(out).delete(f"{out}.rw-in", recursive=True)
    return 0 if ok else 1
