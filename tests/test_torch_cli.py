"""The port's command line (tpumr_torch.cli) on the CPU: its generic
options and site files, its job, pipeline, jobtracker and tasktracker
commands, and the example programs reaching the master that -jt names.

Oracles: tpumr/cli.py's _parse_generic on the same argv; its layering
(defaults < site file < -conf files < -D/-fs/-jt, the layers gone after
main returns); each example program's output from the JAX package's own
program on the same input (text parts byte for byte, SequenceFile parts as
decoded records, K-Means centroids within rtol 1e-5 and atol 1e-6 as in
tests/test_torch_rounds.py). The port's runs use tpumr_torch.device=cpu.
Every cluster runs in a with block and every wait has a timeout. The
daemons in processes of their own: tests/test_torch_cli_daemons.py.
"""

import json
import os

import numpy as np
import pytest

from tpumr.cli import _parse_generic as jax_parse_generic
from tpumr.cli import main as jax_cli
from tpumr.io import sequencefile as jax_sequencefile
from tpumr_torch import cli
from tpumr_torch.core.configuration import Configuration
from tpumr_torch.core.counters import TaskCounter
from tpumr_torch.device import DEVICE_KEY
from tpumr_torch.fs.filesystem import FileSystem
from tpumr_torch.io import sequencefile
from tpumr_torch.mapred.jobconf import JobConf
from tpumr_torch.mapred.mini_cluster import MiniMRCluster
from tpumr_torch.ops.kmeans import clear_centroid_cache

CPU = ["-D", f"{DEVICE_KEY}=cpu"]
RTOL, ATOL = 1e-5, 1e-6
#: seconds any one wait may take here
TIMEOUT = 60


@pytest.fixture(autouse=True)
def _fresh():
    FileSystem.clear_cache()
    clear_centroid_cache()
    yield
    FileSystem.clear_cache()
    clear_centroid_cache()
    assert Configuration._default_resources == []


def _cluster_conf(**kv):
    conf = JobConf()
    conf.set(DEVICE_KEY, "cpu")
    conf.set("mapred.reduce.slowstart.completed.maps", 0.0)
    conf.set("tpumr.heartbeat.interval.ms", 20)
    for k, v in kv.items():
        conf.set(k, v)
    return conf


# ------------------------------------------------------ generic options


@pytest.mark.parametrize("argv", [
    ["-D", "a=1", "job", "-list"],
    ["-Da=1", "-Db = two ", "examples", "pi"],
    ["-conf", "x.toml", "-conf", "y.json", "-D", "k=v=w", "version"],
    ["-fs", "mem:///", "-jt", "h:9", "pipeline", "-list", "-D", "z=9"],
    ["-jt", "local", "-D", "a=1", "-D", "a=2", "examples"],
    ["examples", "-D", "a=1"],
    ["-D", "novalue", "job"],
    ["-D"],
    [],
], ids=["D", "D-joined", "conf", "fs-jt-stop", "repeat", "first-not-option",
        "no-equals", "D-alone", "empty"])
def test_parse_generic_matches_the_jax_package(argv):
    """tpumr/cli.py::_parse_generic on the same argv."""
    assert cli._parse_generic(list(argv)) == jax_parse_generic(list(argv))


def test_layers_site_file_under_conf_files_under_overrides(tmp_path,
                                                           monkeypatch):
    """tpumr/cli.py::main's layering: defaults < $TPUMR_CONF_DIR's site
    file < -conf files in order < -D/-fs/-jt; the layers reach every conf
    the command builds, and are gone once main returns."""
    site = tmp_path / "site"
    site.mkdir()
    (site / "tpumr-site.toml").write_text(
        'a = "site"\nb = "site"\nc = "site"\nd = "site"\n'
        '[mapred]\nreduce.tasks = 7\n')
    (tmp_path / "one.json").write_text(json.dumps({"b": "one", "c": "one",
                                                   "d": "one"}))
    (tmp_path / "two.toml").write_text('c = "two"\nd = "two"\n')
    monkeypatch.setenv("TPUMR_CONF_DIR", str(site))
    seen = {}

    def probe(conf, argv):
        built = JobConf()   # a conf the command makes itself
        seen["built"] = {k: built.get(k) for k in "abcd"}
        seen["given"] = {k: conf.get(k) for k in "abcd"}
        seen["reduces"] = built.num_reduce_tasks
        seen["jt"] = built.get("mapred.job.tracker")
        seen["fs"] = built.get("fs.default.name")
        seen["argv"] = argv
        return 3

    monkeypatch.setitem(cli.COMMANDS, "probe", probe)
    assert cli.main(["-conf", str(tmp_path / "one.json"), "-conf",
                     str(tmp_path / "two.toml"), "-D", "d=cli", "-jt",
                     "h:1", "-fs", "mem:///", "probe", "x", "-D",
                     "e=1"]) == 3
    want = {"a": "site", "b": "one", "c": "two", "d": "cli"}
    assert seen["built"] == seen["given"] == want
    assert seen["reduces"] == 7
    assert (seen["jt"], seen["fs"]) == ("h:1", "mem:///")
    assert seen["argv"] == ["x", "-D", "e=1"]
    assert Configuration._default_resources == []
    conf = JobConf()
    assert conf.get("a") is None and conf.num_reduce_tasks == 1
    conf.add_resource(str(site / "tpumr-site.toml"))
    conf.add_resource({"b": "dict"})
    conf.set("c", "set")
    assert [conf.get(k) for k in "abcd"] == ["site", "dict", "set", "site"]
    assert dict(conf)["mapred.reduce.tasks"] == 7


@pytest.mark.parametrize("content", ["{not json", None],
                         ids=["unreadable", "missing"])
def test_a_broken_conf_file_raises_before_the_command(tmp_path, monkeypatch,
                                                      content):
    """tpumr/cli.py::main: a -conf file that cannot be read raises before
    the command runs, and leaves no layer behind."""
    path = tmp_path / "bad.json"
    if content is not None:
        path.write_text(content)
    ran = []
    monkeypatch.setitem(cli.COMMANDS, "probe",
                        lambda conf, argv: ran.append(1) or 0)
    with pytest.raises((ValueError, OSError)):
        cli.main(["-D", "a=1", "-conf", str(path), "probe"])
    assert ran == [] and Configuration._default_resources == []


def test_unknown_and_unported_commands_return_255(capsys):
    assert cli.main(["frobnicate"]) == 255
    assert cli.main([]) == 255
    for argv in (["job", "trace", "job_1"],
                 ["job", "-diagnose", "job_1"], ["job", "stats", "job_1"],
                 ["pipeline", "trace", "pipe_1"]):
        assert cli.main(argv) == 255
    err = capsys.readouterr().err
    assert "Unknown command: frobnicate" in err
    assert err.count("not ported to tpumr_torch") == 4
    # job -history is ported: with no history directory it says so
    assert cli.main(["job", "-history", "job_1"]) == 255
    assert "set tpumr.history.dir" in capsys.readouterr().err
    assert cli.main(["version"]) == 0
    assert capsys.readouterr().out.startswith("tpumr_torch ")


# ------------------------------------------------- examples on a cluster


def _seq_records(path, reader=sequencefile.Reader):
    recs = []
    for name in sorted(os.listdir(path)):
        if name.startswith("part-"):
            with open(os.path.join(path, name), "rb") as f:
                recs.append(list(reader(f)))
    return recs


def _prepare(program, tmp_path):
    """(the program's arguments, a function comparing the port's output
    with the JAX package's) on an input made here."""
    if program == "wordcount":
        (tmp_path / "in.txt").write_bytes(b"".join(
            b"w%02d x y%d\n" % (i % 11, i % 3) for i in range(300)))
        return ([f"file://{tmp_path}/in.txt"],
                lambda got, want: (got / "part-00000").read_bytes()
                == (want / "part-00000").read_bytes() != b"")
    if program == "sort":
        assert cli.main(["examples", "randomwriter", f"file://{tmp_path}/rw",
                         "-m", "2", "--bytes-per-map", "20000"] + CPU) == 0
        return ([f"file://{tmp_path}/rw"],
                lambda got, want: _seq_records(got)
                == _seq_records(want, jax_sequencefile.Reader) != [])
    pts = np.random.default_rng(0).normal(size=(400, 4)).astype(np.float32)
    np.save(tmp_path / "points.npy", pts)

    def same_centroids(got, want):
        np.testing.assert_allclose(np.load(got / "centroids.npy"),
                                   np.load(want / "centroids.npy"),
                                   rtol=RTOL, atol=ATOL)
        return sorted(os.listdir(got)) == ["centroids.npy", "iter0", "iter1"]

    return ([f"file://{tmp_path}/points.npy", "-k", "3", "-i", "2",
             "--split-rows", "50"], same_centroids)


@pytest.mark.parametrize("program,jobs", [("wordcount", 1), ("sort", 1),
                                          ("kmeans", 2)])
def test_examples_reach_the_master_that_jt_names(tmp_path, program, jobs):
    """The repair of the port's fault 1: each example program runs its
    jobs through job_client.run_job, as tpumr/examples' programs do
    (tpumr/mapred/job_client.py:108-124), so that -jt sends them to that
    master. Its output equals the JAX package's program's, run locally."""
    args, same = _prepare(program, tmp_path)
    assert jax_cli(["examples", program, args[0], f"file://{tmp_path}/jax",
                    *args[1:]]) == 0
    with MiniMRCluster(num_trackers=2, cpu_slots=2, tpu_slots=1,
                       conf=_cluster_conf()) as c:
        assert cli.main(["-jt", c.master_address, "examples", program,
                         args[0], f"file://{tmp_path}/port", *args[1:]]) == 0
        listed = c.master.list_jobs()
        assert len(listed) == jobs
        assert all(c.master.get_job_status(j)["state"] == "SUCCEEDED"
                   for j in listed)
        ran = sum(c.master.get_job_status(j)["finished_maps"]
                  for j in listed)
        assert ran >= jobs
    assert same(tmp_path / "port", tmp_path / "jax")


# ------------------------------------------------------- job, pipeline


def _stuck_conf(out):
    """A job no runner can take: its maps ask for more memory than the
    runner has, so it stays running until it is killed."""
    return {"mapred.input.dir": "mem:///cli/in.txt",
            "mapred.output.dir": out,
            "mapred.input.format.class":
                "tpumr_torch.mapred.input_formats.TextInputFormat",
            "mapred.mapper.class": "tpumr_torch.mapred.api.IdentityMapper",
            "mapred.reduce.tasks": 0,
            "mapred.job.map.memory.mb": 1 << 20}


def _count_graph(name, out):
    return {"name": name, "conf": {}, "edges": [], "nodes": [{
        "id": "count", "conf_hook": None, "conf": {
            "mapred.input.dir": "mem:///cli/in.txt",
            "mapred.output.dir": out,
            "mapred.input.format.class":
                "tpumr_torch.mapred.input_formats.TextInputFormat",
            "mapred.mapper.class":
                "tpumr_torch.ops.wordcount.WordCountCpuMapper",
            "mapred.reducer.class":
                "tpumr_torch.examples.basic.LongSumReducer"}}]}


def test_job_and_pipeline_commands_against_a_mini_cluster(tmp_path, capsys):
    """tpumr/cli.py::cmd_job (-list, -status, -counters, -kill) and
    ::cmd_pipeline (submit -wait, status, -list, -kill) through main."""
    fs = FileSystem.get("mem:///")
    fs.write_bytes("mem:///cli/in.txt", b"a b a\n" * 20)
    with MiniMRCluster(num_trackers=1, tpu_slots=0, conf=_cluster_conf(
            **{"mapred.tasktracker.memory.mb": 1024})) as c:
        jt = ["-jt", c.master_address]
        graph = tmp_path / "graph.json"
        graph.write_text(json.dumps(_count_graph("wc", "mem:///cli/wc")))
        assert cli.main(jt + ["pipeline", "submit", str(graph),
                              "-wait"]) == 0
        out = capsys.readouterr().out
        pid, status = out.split("\n", 1)
        st = json.loads(status)
        assert st["pipeline_id"] == pid and st["state"] == "SUCCEEDED"
        assert fs.read_bytes("mem:///cli/wc/part-00000") == b"a\t40\nb\t20\n"
        job = st["nodes"]["count"]["job_id"]

        assert cli.main(jt + ["job", "-list"]) == 0
        lines = capsys.readouterr().out.splitlines()
        assert [ln.split("\t")[:2] for ln in lines] == [[job, "SUCCEEDED"]]
        assert cli.main(jt + ["job", "-status", job]) == 0
        assert json.loads(capsys.readouterr().out)["num_maps"] >= 1
        assert cli.main(jt + ["job", "-counters", job]) == 0
        counters = json.loads(capsys.readouterr().out)
        assert counters[TaskCounter.FRAMEWORK_GROUP][
            TaskCounter.REDUCE_OUTPUT_RECORDS] == 2
        assert cli.main(jt + ["job", "-kill", job]) == 1
        assert "already finished" in capsys.readouterr().out

        from tpumr_torch.mapred.job_client import JobClient
        conf = c.create_job_conf()
        for k, v in _stuck_conf("mem:///cli/stuck").items():
            conf.set(k, v)
        client = JobClient(conf)
        try:
            stuck = client.submit_job(conf)
            assert cli.main(jt + ["job", "-kill", stuck.job_id]) == 0
            assert f"Killed {stuck.job_id}" in capsys.readouterr().out
            assert stuck.wait_for_completion(timeout=TIMEOUT)["state"] == \
                "KILLED"
        finally:
            client.close()

        g = _count_graph("stuck", "mem:///cli/stuck2")
        g["nodes"][0]["conf"] = _stuck_conf("mem:///cli/stuck2")
        graph.write_text(json.dumps(g))
        assert cli.main(jt + ["pipeline", "submit", str(graph)]) == 0
        pid2 = capsys.readouterr().out.strip()
        assert cli.main(jt + ["pipeline", "-list"]) == 0
        rows = [ln.split("\t") for ln in
                capsys.readouterr().out.splitlines()]
        assert rows == [[pid, "SUCCEEDED", "wc", "stages=1/1"],
                        [pid2, "RUNNING", "stuck", "stages=0/1"]]
        assert cli.main(jt + ["pipeline", "-kill", pid2]) == 0
        assert cli.main(jt + ["pipeline", "status", pid2]) == 0
        out = capsys.readouterr().out
        assert out.startswith(f"Killed {pid2}\n")
        assert json.loads(out.split("\n", 1)[1])["state"] == "KILLED"
        assert cli.main(jt + ["pipeline", "-kill", pid2]) == 1
        assert cli.main(jt + ["pipeline", "status", "pipe_none"]) == 1
    assert cli.main(["job", "-list"]) == 255        # no master named
    assert cli.main(["pipeline", "-list"]) == 255
