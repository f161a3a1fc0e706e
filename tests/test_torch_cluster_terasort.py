"""A device-shuffled TeraSort on the port's cluster: submission through
JobClient (tpumr_torch.mapred.job_client.build_submission plans one gang
reduce), dense map outputs served by the node runners
(NodeRunner.get_map_output_dense) and the gang reduce on a runner
(tpumr_torch.mapred.device_shuffle.run_device_reduce), on the CPU
(tpumr_torch.device=cpu).

Oracle: tests/test_device_shuffle.py::TestDeviceShuffleMiniCluster::
test_terasort_device_shuffle_through_jobclient, and the JAX package's
TeraSort of the same teragen output (its LocalJobRunner), part for part as
decoded records (each writer draws its own sync marker); the partition
file is byte-identical. The serving guards and the comparator refusal
mirror tpumr/mapred/tasktracker.py:2150-2153 and
tests/test_device_shuffle.py:185. Each cluster runs in a ``with`` block and
every job waits with a timeout.
"""

import os

import pytest

from tpumr.cli import main as jax_cli
from tpumr.examples import terasort as jax_terasort
from tpumr.io import sequencefile as jax_seq
from tpumr.mapred.local_runner import run_job as jax_run_job
from tpumr_torch.cli import main as cli
from tpumr_torch.core.counters import BackendCounter
from tpumr_torch.device import DEVICE_KEY
from tpumr_torch.examples.terasort import make_terasort_conf
from tpumr_torch.fs.filesystem import FileSystem
from tpumr_torch.ipc.rpc import RpcClient, RpcError
from tpumr_torch.mapred.api import DeserializingComparator
from tpumr_torch.mapred.job_client import JobClient
from tpumr_torch.mapred.jobconf import JobConf
from tpumr_torch.mapred.mini_cluster import MiniMRCluster

ROWS, RANGES = 600, 4


@pytest.fixture
def cluster():
    FileSystem.clear_cache()
    base = JobConf()
    base.set(DEVICE_KEY, "cpu")
    with MiniMRCluster(num_trackers=2, cpu_slots=2, tpu_slots=0,
                       conf=base) as c:
        yield c
    FileSystem.clear_cache()


def _parts(path):
    out = []
    for name in sorted(os.listdir(path)):
        if name.startswith("part-"):
            with open(os.path.join(path, name), "rb") as f:
                out.append((name, list(jax_seq.Reader(f))))
    return out


def _on_cluster(conf, cluster):
    for k, v in cluster.create_job_conf():
        if conf.get(k) is None:
            conf.set(k, v)
    return conf


def test_device_shuffled_terasort_through_jobclient_matches_jax(
        tmp_path, cluster):
    """Maps on the runners, dense outputs over RPC, one gang reduce: the
    JAX package's records part for part, its partition file byte for
    byte."""
    gen = f"{tmp_path}/gen"
    assert jax_cli(["examples", "teragen", str(ROWS), f"file://{gen}",
                    "-m", "3"]) == 0
    conf = _on_cluster(make_terasort_conf(f"file://{gen}",
                                          f"file://{tmp_path}/p", RANGES,
                                          device_shuffle=True), cluster)
    client = JobClient(conf)
    try:
        result = client.run_job(conf, timeout=60)
    finally:
        client.close()
    assert result.successful and result.num_reduces == 1   # the gang task
    assert len(cluster.master.get_task_reports(str(result.job_id),
                                               "reduce")) == 1
    assert result.counters.value(BackendCounter.GROUP,
                                 BackendCounter.TPU_SHUFFLE_RECORDS) == ROWS
    assert result.counters.value(BackendCounter.GROUP,
                                 BackendCounter.DEVICE_SORT_ON_ACCEL) == 0
    jconf = jax_terasort.make_terasort_conf(
        f"file://{gen}", f"file://{tmp_path}/j", RANGES, True)
    assert jax_run_job(jconf).successful
    port, jax = _parts(tmp_path / "p"), _parts(tmp_path / "j")
    assert [p for p, _ in port] == [f"part-{r:05d}" for r in range(RANGES)]
    assert port == jax
    keys = [k for _, recs in port for k, _ in recs]
    assert len(keys) == ROWS and keys == sorted(keys)
    with open(f"{tmp_path}/p.partitions", "rb") as f, \
            open(f"{tmp_path}/j.partitions", "rb") as g:
        assert f.read() == g.read()


def test_terasort_device_shuffle_with_jt_reaches_the_master(tmp_path,
                                                            cluster):
    """``examples terasort --device-shuffle -jt H:P`` runs on that master
    (the refusal it met before is gone), and teravalidate finds the
    output sorted."""
    base = f"file://{tmp_path}"
    cpu = ["-D", f"{DEVICE_KEY}=cpu"]
    assert cli(cpu + ["examples", "teragen", "300", f"{base}/gen",
                      "-m", "2"]) == 0
    jt = ["-jt", cluster.master_address]
    assert cli(jt + cpu + ["examples", "terasort", f"{base}/gen",
                           f"{base}/out", "-r", "2",
                           "--device-shuffle"]) == 0
    jobs = list(cluster.master.jobs.values())
    assert len(jobs) == 1 and jobs[0].state == "SUCCEEDED"
    assert len(jobs[0].reduces) == 1
    assert sum(len(r) for _, r in _parts(tmp_path / "out")) == 300
    assert cli(cpu + ["examples", "teravalidate", f"{base}/out",
                      f"{base}/report"]) == 0


def test_serving_refuses_the_other_kind_of_output(tmp_path, cluster):
    """get_map_output and get_map_output_chunk refuse a dense output;
    get_map_output_dense refuses an IFile one (tasktracker.py:2150-2153,
    :2227-2229)."""
    runner = cluster.trackers[0]
    dense, ifile_out = tmp_path / "file.dense", tmp_path / "file.out"
    dense.write_bytes(b"TDSH")
    ifile_out.write_bytes(b"TIFL")
    runner.map_outputs[("job_x_0001", 0)] = (str(dense), {"dense": True})
    runner.map_outputs[("job_x_0001", 1)] = (
        str(ifile_out), {"codec": "none", "partitions": [(4, 0, 0)]})
    cli_ = RpcClient("127.0.0.1", runner.shuffle_port)
    try:
        for method, args in (("get_map_output", (0, 0)),
                             ("get_map_output_chunk", (0, 0, 0, 1024))):
            with pytest.raises(RpcError, match="dense") as e:
                cli_.call(method, "job_x_0001", *args)
            assert e.value.remote_type == "ValueError"
        with pytest.raises(RpcError, match="not dense"):
            cli_.call("get_map_output_dense", "job_x_0001", 1)
        with pytest.raises(RpcError, match="no map output"):
            cli_.call("get_map_output_dense", "job_x_0001", 7)
        assert cli_.call("get_map_output_dense", "job_x_0001", 0) == \
            {"data": b"TDSH"}
    finally:
        cli_.close()


def test_custom_comparator_is_refused_at_submit(cluster):
    """tests/test_device_shuffle.py:185, through the cluster's client:
    the refusal comes before anything reaches the master."""
    conf = cluster.create_job_conf()
    conf.set_input_paths("mem:///nothing")
    conf.set_output_path("mem:///nothing-out")
    conf.set_num_reduce_tasks(2)
    conf.set_device_shuffle(10, 90)
    conf.set_output_key_comparator_class(DeserializingComparator)
    client = JobClient(conf)
    try:
        with pytest.raises(ValueError, match="comparator"):
            client.submit_job(conf)
    finally:
        client.close()
    assert cluster.master.jobs == {}
