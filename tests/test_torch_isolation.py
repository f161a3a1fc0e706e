"""The port stands alone: tpumr_torch and chip_smoke.py import neither JAX
nor anything of the JAX package (tpumr), the pipes child runtime loads
neither torch nor numpy, and chip_smoke.py refuses to run without a card.
"""

import ast
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import tpumr_torch
names = [m.name for m in pkgutil.walk_packages(tpumr_torch.__path__,
                                               "tpumr_torch.")]
for name in names:
    importlib.import_module(name)
print(json.dumps({"imported": names, "forbidden": sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib") or m == "tpumr"
    or m.startswith("tpumr."))}))
"""


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib") or top == "tpumr"


def test_importing_every_module_loads_no_jax_and_no_tpumr():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert "tpumr_torch.mapred.local_runner" in report["imported"]
    assert "tpumr_torch.ops.kmeans" in report["imported"]
    for name in ("io.sequencefile", "io.compress", "mapred.total_order",
                 "mapred.device_shuffle", "parallel.device_sort",
                 "examples.terasort", "ipc.rpc", "mapred.job_in_progress",
                 "mapred.scheduler", "mapred.jobtracker",
                 "mapred.tasktracker", "mapred.shuffle_copier",
                 "mapred.job_client", "mapred.mini_cluster",
                 "pipeline.graph", "pipeline.pipeline_in_progress",
                 "pipeline.handoff", "pipeline.client", "cli", "utils.fi",
                 "io.fdcache", "mapred.filecache", "mapred.child",
                 "mapred.process_runner", "pipes", "pipes.protocol",
                 "pipes.application", "pipes.child", "pipes.runner",
                 "pipes.submitter", "mapred.lib", "mapred.lib_db",
                 "streaming", "streaming.typedbytes", "streaming.pipe_runner",
                 "streaming.stream_job", "mapreduce", "mapreduce.lib",
                 "contrib", "contrib.datajoin", "mapred.history"):
        assert f"tpumr_torch.{name}" in report["imported"]
    assert report["forbidden"] == []


def test_no_source_names_jax_or_tpumr_in_an_import():
    sources = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _dirs, files in os.walk(os.path.join(REPO, "tpumr_torch")):
        sources += [os.path.join(dirpath, f) for f in files
                    if f.endswith(".py")]
    assert len(sources) > 20
    bad = []
    for path in sources:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad += [f"{path}:{node.lineno} {n}" for n in names
                    if _forbidden(n)]
    assert bad == []


def test_pipes_child_runtime_loads_no_torch_and_no_numpy():
    """A pipes child imports tpumr_torch.pipes.child, and a CPU child
    must start in milliseconds and never reach torch.cuda: the runtime
    loads neither torch nor numpy."""
    out = subprocess.run(
        [sys.executable, "-c", "import sys, tpumr_torch.pipes.child; "
         "print(sorted(m for m in ('torch', 'numpy', 'jax') "
         "if m in sys.modules))"],
        cwd=REPO, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_chip_smoke_fails_without_a_card():
    """No CUDA device: a non-zero exit and no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
