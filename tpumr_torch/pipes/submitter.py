"""Pipes job submission with dual CPU and GPU executables.

Counterpart of ``tpumr/pipes/submitter.py`` (the reference's
``Submitter.java``):

- conf keys ``tpumr.pipes.executable`` and ``tpumr.pipes.tpu.executable``
  (the reference's ``hadoop.pipes.executable`` and
  ``hadoop.pipes.gpu.executable``, the key the hybrid scheduler's gate
  reads: ``JobInProgress.has_kernel``);
- :func:`setup_pipes_job`: the runners, reducer and partitioner, and the
  cache list with the CPU binary at index 0 and the GPU binary at index 1;
- :func:`main`, the ``pipes`` command: ``-program`` (the CPU binary),
  ``-tpubin`` (the GPU binary; ``-gpubin`` too, the reference's flag),
  ``-input``, ``-output``, ``-reduces`` and ``-jobconf k=v[,k=v...]``. The
  job goes through ``job_client.run_job``, so ``-jt HOST:PORT`` (or
  ``mapred.job.tracker``) sends it to that master.
"""

from __future__ import annotations

import argparse
import os
from typing import Any

from tpumr_torch.mapred import filecache
from tpumr_torch.mapred.jobconf import JobConf

EXECUTABLE_KEY = "tpumr.pipes.executable"
TPU_EXECUTABLE_KEY = "tpumr.pipes.tpu.executable"


class Submitter:
    @staticmethod
    def set_executable(conf: Any, path: str) -> None:
        conf.set(EXECUTABLE_KEY, path)

    @staticmethod
    def get_executable(conf: Any) -> "str | None":
        return conf.get(EXECUTABLE_KEY)

    @staticmethod
    def set_tpu_executable(conf: Any, path: str) -> None:
        """The GPU binary (the reference's ``setGPUExecutable``)."""
        conf.set(TPU_EXECUTABLE_KEY, path)

    @staticmethod
    def get_tpu_executable(conf: Any) -> "str | None":
        return conf.get(TPU_EXECUTABLE_KEY)

    @staticmethod
    def run_job(conf: JobConf):
        """Set the job up and run it, locally or on the master the conf
        names."""
        from tpumr_torch.mapred.job_client import run_job
        setup_pipes_job(conf)
        return run_job(conf)


def setup_pipes_job(conf: JobConf) -> None:
    """Name the pipes runners, reducer and partitioner where the job names
    none, and cache the executables in slot order (CPU 0, GPU 1)."""
    from tpumr_torch.pipes.runner import (PipesGPUMapRunner, PipesMapRunner,
                                          PipesPartitioner, PipesReducer)
    cpu_bin = Submitter.get_executable(conf)
    tpu_bin = Submitter.get_tpu_executable(conf)
    if not cpu_bin:
        raise ValueError(f"pipes job needs {EXECUTABLE_KEY}")
    if not os.path.exists(cpu_bin):
        raise FileNotFoundError(cpu_bin)
    if tpu_bin and not os.path.exists(tpu_bin):
        raise FileNotFoundError(tpu_bin)
    conf.set_map_runner_class(PipesMapRunner)
    conf.set_tpu_map_runner_class(PipesGPUMapRunner)
    if conf.get_reducer_class() is None and conf.num_reduce_tasks > 0:
        conf.set_reducer_class(PipesReducer)
    if conf.get("mapred.partitioner.class") is None:
        conf.set_partitioner_class(PipesPartitioner)
    if not conf.get(filecache.CACHE_FILES_KEY):
        filecache.add_cache_file(conf, cpu_bin, link="pipes-cpu-bin",
                                 executable=True)
        if tpu_bin:
            filecache.add_cache_file(conf, tpu_bin, link="pipes-tpu-bin",
                                     executable=True)


def main(argv: "list[str]") -> int:
    """The ``pipes`` command; 0 when the job succeeded."""
    ap = argparse.ArgumentParser(prog="tpumr_torch pipes")
    ap.add_argument("-input", dest="input", required=True)
    ap.add_argument("-output", dest="output", required=True)
    ap.add_argument("-program", dest="program", required=True,
                    help="the CPU executable")
    ap.add_argument("-tpubin", "-gpubin", dest="tpubin", default=None,
                    help="the GPU executable")
    ap.add_argument("-reduces", dest="reduces", type=int, default=1)
    ap.add_argument("-jobconf", dest="jobconf", action="append", default=[],
                    help="k=v[,k=v...]")
    args = ap.parse_args(argv)
    conf = JobConf()
    conf.set_input_paths(*args.input.split(","))
    conf.set_output_path(args.output)
    conf.set_num_reduce_tasks(args.reduces)
    Submitter.set_executable(conf, args.program)
    if args.tpubin:
        Submitter.set_tpu_executable(conf, args.tpubin)
    for chunk in args.jobconf:
        for kv in chunk.split(","):
            k, _, v = kv.partition("=")
            conf.set(k.strip(), v.strip())
    return 0 if Submitter.run_job(conf).successful else 1
