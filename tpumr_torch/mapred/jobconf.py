"""JobConf: a Configuration with typed accessors for the job contract.

Counterpart of ``tpumr/mapred/jobconf.py``, trimmed to what the port's job
paths use. Key strings and defaults are the JAX package's
(``tpumr/core/confkeys.py``), so a job configuration written for it runs
unchanged here.
"""

from __future__ import annotations

from typing import Any

from tpumr_torch.core.configuration import Configuration
from tpumr_torch.utils.reflection import new_instance

DEFAULTS: dict[str, Any] = {
    "mapred.reduce.tasks": 1,
    "mapred.map.tasks": 1,
    "io.sort.mb": 100,
    "io.sort.spill.percent": 0.8,
    "io.sort.factor": 10,
    "mapred.compress.map.output": False,
}


class JobConf(Configuration):
    def __init__(self, other: "Configuration | None" = None) -> None:
        super().__init__(other=other, defaults=DEFAULTS)

    @property
    def job_name(self) -> str:
        return self.get("mapred.job.name", "")

    def set_job_name(self, name: str) -> None:
        self.set("mapred.job.name", name)

    # ------------------------------------------------------------ io paths

    def set_input_paths(self, *paths: str) -> None:
        self.set("mapred.input.dir", ",".join(paths))

    def add_input_path(self, path: str) -> None:
        self.set("mapred.input.dir",
                 ",".join(self.get_strings("mapred.input.dir") + [path]))

    def set_output_path(self, path: str) -> None:
        self.set("mapred.output.dir", path)

    # ------------------------------------------------------------ task counts

    @property
    def num_reduce_tasks(self) -> int:
        return self.get_int("mapred.reduce.tasks")

    def set_num_reduce_tasks(self, n: int) -> None:
        self.set("mapred.reduce.tasks", n)

    @property
    def num_map_tasks_hint(self) -> int:
        return self.get_int("mapred.map.tasks")

    # ------------------------------------------------------------ classes

    def set_mapper_class(self, cls: type) -> None:
        self.set_class("mapred.mapper.class", cls)

    def get_mapper_class(self) -> "type | None":
        return self.get_class("mapred.mapper.class")

    def set_combiner_class(self, cls: type) -> None:
        self.set_class("mapred.combiner.class", cls)

    def get_combiner_class(self) -> "type | None":
        return self.get_class("mapred.combiner.class")

    def set_map_runner_class(self, cls: type) -> None:
        self.set_class("mapred.map.runner.class", cls)

    def get_map_runner_class(self) -> type:
        """The per-record runner of a CPU map task."""
        from tpumr_torch.mapred.api import MapRunner
        return self.get_class("mapred.map.runner.class", MapRunner)

    def set_tpu_map_runner_class(self, cls: type) -> None:
        """The runner of an accelerator-slot map task
        (``mapred.map.runner.tpu.class``, the JAX package's key; the
        reference's ``JobConf.setGPUMapRunnerClass``)."""
        self.set_class("mapred.map.runner.tpu.class", cls)

    def get_tpu_map_runner_class(self) -> type:
        from tpumr_torch.mapred.gpu_runner import GpuMapRunner
        return self.get_class("mapred.map.runner.tpu.class", GpuMapRunner)

    def set_reducer_class(self, cls: type) -> None:
        self.set_class("mapred.reducer.class", cls)

    def get_reducer_class(self) -> "type | None":
        return self.get_class("mapred.reducer.class")

    def set_partitioner_class(self, cls: type) -> None:
        self.set_class("mapred.partitioner.class", cls)

    def get_partitioner_class(self) -> type:
        from tpumr_torch.mapred.api import HashPartitioner
        return self.get_class("mapred.partitioner.class", HashPartitioner)

    def set_input_format(self, cls: type) -> None:
        self.set_class("mapred.input.format.class", cls)

    def get_input_format(self) -> type:
        from tpumr_torch.mapred.input_formats import TextInputFormat
        return self.get_class("mapred.input.format.class", TextInputFormat)

    def set_output_format(self, cls: type) -> None:
        self.set_class("mapred.output.format.class", cls)

    def get_output_format(self) -> type:
        from tpumr_torch.mapred.output_formats import TextOutputFormat
        return self.get_class("mapred.output.format.class", TextOutputFormat)

    def set_output_key_comparator_class(self, cls: type) -> None:
        self.set_class("mapred.output.key.comparator.class", cls)

    def get_output_key_comparator(self) -> Any:
        from tpumr_torch.mapred.api import DeserializingComparator
        return new_instance(self.get_class(
            "mapred.output.key.comparator.class", DeserializingComparator),
            self)

    def set_output_value_grouping_comparator(self, cls: type) -> None:
        """Reduce groups run under this comparator, while the merge keeps
        the output-key comparator's order (the secondary-sort seam)."""
        self.set_class("mapred.output.value.groupfn.class", cls)

    def get_output_value_grouping_comparator(self) -> Any:
        cls = self.get_class("mapred.output.value.groupfn.class")
        return new_instance(cls, self) if cls is not None else None

    # ------------------------------------------------------------ kernel

    def set_map_kernel(self, name: str) -> None:
        """Name a registered kernel mapper (``tpumr_torch.ops`` registry)."""
        self.set("tpumr.map.kernel", name)

    def get_map_kernel(self) -> "str | None":
        return self.get("tpumr.map.kernel")

    def set_device_shuffle(self, key_bytes: int, value_bytes: int) -> None:
        """Sort this job's map output on the device
        (``mapred/device_shuffle.py``): its keys and values must be
        ``bytes`` of exactly these widths."""
        self.set("tpumr.shuffle.device", True)
        self.set("tpumr.shuffle.device.key.bytes", key_bytes)
        self.set("tpumr.shuffle.device.value.bytes", value_bytes)

    @property
    def device_shuffle(self) -> bool:
        """Whether the job's map output is sorted on the device (read here,
        so a CPU task checks it without loading the device sort)."""
        return self.get_boolean("tpumr.shuffle.device", False)

    # ------------------------------------------------------------ sort/spill

    @property
    def sort_mb(self) -> int:
        return self.get_int("io.sort.mb")

    @property
    def spill_percent(self) -> float:
        return self.get_float("io.sort.spill.percent")

    @property
    def sort_factor(self) -> int:
        """Runs merged at most at once (map spills and reduce merges)."""
        return self.get_int("io.sort.factor")

    @property
    def compress_map_output(self) -> str:
        """The codec of the map output: ``none`` unless
        ``mapred.compress.map.output``, then
        ``mapred.map.output.compression.codec`` (``zlib`` by default)."""
        if self.get_boolean("mapred.compress.map.output"):
            return self.get("mapred.map.output.compression.codec", "zlib")
        return "none"
