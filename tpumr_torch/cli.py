"""Command line of the port: ``python -m tpumr_torch.cli [generic options]
COMMAND [args]``.

Counterpart of ``tpumr/cli.py``, trimmed to the commands the port has.
Generic options come before the command (``_parse_generic``, ``:83-110``
there): ``-D k=v`` (or ``-Dk=v``), ``-conf FILE``, ``-fs URI`` and ``-jt
HOST:PORT|local``. ``$TPUMR_CONF_DIR/tpumr-site.{toml,json}`` loads by
itself (``_site_files``, ``:115-131``). The layers, lowest first: the
defaults, the site file, the ``-conf`` files in order, then ``-D``,
``-fs`` and ``-jt``. They are installed as default resources for the
command's run (``main``, ``:1529-1560``), so they also reach the confs a
command builds itself (``examples``' jobs), and removed after it, so that
calls in one process do not pile them up. A ``-conf`` file that cannot be
read raises before the command runs.

Commands: ``jobtracker`` and ``tasktracker``, which serve until SIGTERM or
SIGINT (``:141-154, 212-236``); ``job -list | -status ID | -kill ID |
-counters ID | -events ID | -set-priority ID PRIO | -kill-task ATTEMPT |
-fail-task ATTEMPT | -list-attempt-ids ID map|reduce running|completed |
-list-active-trackers | -list-blacklisted-trackers`` (``:267-396``; an
unhealthy runner with its health script's report; ``-status`` of a job a
restarted master recovered says on stderr what it was recovered as) and
``job -history ID [DIR]``, read from the history directory with no master
(``_job_history``, ``:797-848``); ``pipeline submit GRAPH.json [-wait] |
status ID | -list | -kill ID`` (``:397-479``); ``examples``; ``version``.
``job -diagnose``, ``job trace``, ``job stats`` and ``pipeline trace`` wait
for the port's tracing and metrics: each says so and returns 255. ``pipes -program CPU_BIN [-tpubin GPU_BIN] -input IN
-output OUT [-reduces N] [-jobconf k=v,...]`` submits a pipes job
(``pipes/submitter.main``, ``:1119-1121``); ``streaming -input IN -output
OUT [-mapper CMD] [-reducer CMD|aggregate] [-combiner CMD]
[-numReduceTasks N] [-io text|typedbytes] [-D k=v]`` a streaming job
(``streaming/stream_job.main``, ``:1124-1126``). The reference's other daemons
and tools are not ported (``ROADMAP.md``).
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
from typing import Any, Callable

USAGE = """\
Usage: python -m tpumr_torch.cli [generic options] COMMAND [args]
Generic options: -D k=v  -conf FILE  -fs <default-fs-uri>  -jt <host:port|local>
Site config: $TPUMR_CONF_DIR/tpumr-site.{toml,json} loads automatically
(precedence: defaults < site file < -conf files < -D/-fs/-jt)

Daemons:
  jobtracker [-host H] [-port P]   run the JobMaster (-port 0: a free port)
  tasktracker -jt HOST:PORT        run a NodeRunner (worker)

Clients:
  job ...              job control: -list | -status ID | -kill ID | -counters ID
                       | -events ID | -set-priority ID PRIO | -kill-task ATT
                       | -fail-task ATT | -list-attempt-ids ID map|reduce
                       running|completed | -list-active-trackers
                       | -list-blacklisted-trackers | -history ID [DIR]
  pipeline ...         DAG-of-jobs pipelines: submit GRAPH.json [-wait] |
                       status ID | -list | -kill ID
  pipes ...            submit a pipes job: -program BIN [-tpubin BIN]
                       -input IN -output OUT [-reduces N] [-jobconf k=v]
  streaming ...        submit a streaming job: -input IN -output OUT
                       [-mapper CMD] [-reducer CMD|aggregate] [-combiner CMD]
                       [-numReduceTasks N] [-io text|typedbytes] [-D k=v]
  examples NAME ...    run an example program (examples -h lists them)
  version              print the version
"""

VERSION = "0.1.0"

#: what the JAX package has and the port does not yet
_NOT_PORTED = ("needs tracing and the metrics registry, which are not "
               "ported to tpumr_torch")


def _parse_generic(argv: "list[str]"
                   ) -> "tuple[dict[str, Any], list[str], list[str]]":
    """Strip the leading generic options: (overrides, ``-conf`` files, the
    rest of ``argv``), stopping at the first argument that is not one."""
    over: "dict[str, Any]" = {}
    conf_files: "list[str]" = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-D" and i + 1 < len(argv):
            k, _, v = argv[i + 1].partition("=")
            over[k.strip()] = v.strip()
            i += 2
        elif a.startswith("-D") and "=" in a:
            k, _, v = a[2:].partition("=")
            over[k.strip()] = v.strip()
            i += 1
        elif a == "-conf" and i + 1 < len(argv):
            conf_files.append(argv[i + 1])
            i += 2
        elif a == "-fs" and i + 1 < len(argv):
            over["fs.default.name"] = argv[i + 1]
            i += 2
        elif a == "-jt" and i + 1 < len(argv):
            over["mapred.job.tracker"] = argv[i + 1]
            i += 2
        else:
            break
    return over, conf_files, argv[i:]


def _site_files(conf_files: "list[str]") -> "list[str]":
    """Resource files, lowest first: ``$TPUMR_CONF_DIR``'s site files that
    exist, then the ``-conf`` files (a missing one raises when loaded)."""
    out: "list[str]" = []
    conf_dir = os.environ.get("TPUMR_CONF_DIR")
    if conf_dir:
        for name in ("tpumr-site.toml", "tpumr-site.json"):
            p = os.path.join(conf_dir, name)
            if os.path.exists(p):
                out.append(p)
    out.extend(conf_files)
    return out


def _conf(overrides: "dict[str, Any]"):
    from tpumr_torch.mapred.jobconf import JobConf
    conf = JobConf()
    for k, v in overrides.items():
        conf.set(k, v)
    return conf


def _serve_forever(stop: Callable[[], None]) -> int:
    """Block until SIGINT or SIGTERM, then ``stop()`` the daemon."""
    done = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            signal.signal(sig, lambda *_: done.set())
        except ValueError:   # not the main thread
            pass
    try:
        while not done.wait(0.5):
            pass
    finally:
        stop()
    return 0


def _kv_args(argv: "list[str]") -> "dict[str, str]":
    """The daemons' ``-name value`` pairs."""
    out: "dict[str, str]" = {}
    i = 0
    while i < len(argv):
        if argv[i].startswith("-") and i + 1 < len(argv):
            out[argv[i].lstrip("-")] = argv[i + 1]
            i += 2
        else:
            raise SystemExit(f"unexpected argument: {argv[i]}")
    return out


def _host_port(s: str) -> "tuple[str, int]":
    host, _, port = s.partition(":")
    return host or "127.0.0.1", int(port)


def _master(conf) -> "str | None":
    jt = conf.get("mapred.job.tracker")
    return None if not jt or jt == "local" else str(jt)


# ------------------------------------------------------------------ daemons


def cmd_jobtracker(conf, argv: "list[str]") -> int:
    from tpumr_torch.mapred.jobtracker import JobMaster
    a = _kv_args(argv)
    jm = JobMaster(conf, host=a.get("host", "127.0.0.1"),
                   port=int(a.get("port", 9001))).start()
    host, port = jm.address
    print(f"JobMaster up at {host}:{port}", file=sys.stderr, flush=True)
    return _serve_forever(jm.stop)


def cmd_tasktracker(conf, argv: "list[str]") -> int:
    """A node runner; its slots come from the
    ``mapred.tasktracker.{map.cpu,map.tpu,reduce}.tasks.maximum`` keys."""
    from tpumr_torch.mapred.tasktracker import NodeRunner
    a = _kv_args(argv)
    jt = a.get("jt") or _master(conf)
    if not jt or ":" not in jt:
        print("tasktracker needs -jt HOST:PORT", file=sys.stderr)
        return 255
    host, port = _host_port(jt)
    nr = NodeRunner(host, port, conf).start()
    print(f"NodeRunner up, heartbeating to {host}:{port}", file=sys.stderr,
          flush=True)
    return _serve_forever(nr.stop)


# ------------------------------------------------------------------ clients


def cmd_job(conf, argv: "list[str]") -> int:
    from tpumr_torch.ipc.rpc import RpcClient, RpcError
    usage = ("Usage: python -m tpumr_torch.cli job -list | -status ID | "
             "-kill ID | -counters ID | -events ID | -set-priority ID PRIO "
             "| -kill-task ATTEMPT | -fail-task ATTEMPT | -list-attempt-ids "
             "ID map|reduce running|completed | -list-active-trackers | "
             "-list-blacklisted-trackers | -history ID [HISTORY_DIR]")
    if argv and argv[0] == "-history":
        return _job_history(conf, argv[1:])   # offline: no master
    if argv and argv[0].lstrip("-") in ("diagnose", "trace", "stats"):
        print(f"job {argv[0]} {_NOT_PORTED}", file=sys.stderr)
        return 255
    jt = _master(conf)
    if not jt:
        print("job control needs -jt HOST:PORT", file=sys.stderr)
        return 255
    if not argv or (argv[0] not in ("-list", "-list-active-trackers",
                                    "-list-blacklisted-trackers")
                    and len(argv) < 2):
        print(usage, file=sys.stderr)
        return 255
    cmd, *rest = argv
    client = RpcClient(*_host_port(jt))
    try:
        if cmd == "-list":
            for jid in client.call("list_jobs"):
                st = client.call("get_job_status", jid)
                print(f"{jid}\t{st.get('state')}"
                      f"\t{st.get('priority', 'NORMAL')}"
                      f"\tmaps={st.get('map_progress'):.2f}"
                      f"\treduces={st.get('reduce_progress'):.2f}")
            return 0
        if cmd in ("-list-active-trackers", "-list-blacklisted-trackers"):
            for name in client.call(
                    "get_active_trackers" if cmd == "-list-active-trackers"
                    else "get_blacklisted_trackers"):
                print(name)
            return 0
        if cmd == "-status":
            st = client.call("get_job_status", rest[0])
            if st.get("job_id") and st["job_id"] != rest[0]:
                print(f"job {rest[0]} was recovered as {st['job_id']} "
                      f"after a master restart", file=sys.stderr)
            print(json.dumps(st, indent=2, default=str))
            return 0
        if cmd == "-counters":
            print(json.dumps(client.call("get_counters", rest[0]),
                             indent=2, default=str))
            return 0
        if cmd == "-kill":
            ok = client.call("kill_job", rest[0])
            print(f"Killed {rest[0]}" if ok
                  else f"{rest[0]} already finished; not killed")
            return 0 if ok else 1
        if cmd == "-events":
            for ev in client.call("get_map_completion_events",
                                  rest[0], 0, 100):
                print(ev)
            return 0
        if cmd in ("-kill-task", "-fail-task"):
            ok = client.call("kill_task", rest[0], cmd == "-fail-task")
            verb = "Failed" if cmd == "-fail-task" else "Killed"
            print(f"{verb} task attempt {rest[0]}" if ok else
                  f"{rest[0]} not running; nothing to do")
            return 0 if ok else 1
        if cmd == "-list-attempt-ids":
            if len(rest) < 3:
                print(usage, file=sys.stderr)
                return 255
            for aid in client.call("get_attempt_ids", *rest[:3]):
                print(aid)
            return 0
        if cmd == "-set-priority":
            if len(rest) < 2:
                print("Usage: python -m tpumr_torch.cli job -set-priority "
                      "ID VERY_HIGH|HIGH|NORMAL|LOW|VERY_LOW",
                      file=sys.stderr)
                return 255
            p = client.call("set_job_priority", rest[0], rest[1])
            print(f"Changed job priority of {rest[0]} to {p}")
            return 0
    except RpcError as e:
        print(f"job {cmd}: {e}", file=sys.stderr)
        return 1
    finally:
        client.close()
    print(f"job: unknown option {cmd}", file=sys.stderr)
    return 255


def _job_history(conf, argv: "list[str]") -> int:
    """One job's history file summed up: its submission, end, backends,
    event counts and failed attempts."""
    if not argv:
        print("Usage: python -m tpumr_torch.cli job -history JOB_ID "
              "[HISTORY_DIR]", file=sys.stderr)
        return 255
    job_id = argv[0]
    hist_dir = argv[1] if len(argv) > 1 else conf.get("tpumr.history.dir")
    if not hist_dir:
        print("job -history: pass HISTORY_DIR or set tpumr.history.dir",
              file=sys.stderr)
        return 255
    path = os.path.join(hist_dir, f"{job_id}.jsonl")
    if not os.path.exists(path):
        known = [f[:-6] for f in sorted(os.listdir(hist_dir))
                 if f.endswith(".jsonl")] if os.path.isdir(hist_dir) else []
        print(f"no history for {job_id} in {hist_dir}; known: "
              f"{', '.join(known) or '(none)'}", file=sys.stderr)
        return 1
    from tpumr_torch.mapred.history import JobHistory, job_summary
    events = JobHistory.read(path)
    s = job_summary(events)
    print(f"Job: {s.get('job_id', job_id)}")
    print(f"Name: {s.get('name', '')}")
    print(f"State: {s.get('state', 'INCOMPLETE')}")
    if s.get("wall_time") is not None:
        print(f"Wall time: {s['wall_time']:.2f}s")
    print(f"Maps: {s.get('num_maps', '?')}  Reduces: "
          f"{s.get('num_reduces', '?')}")
    print(f"TPU maps: {s.get('finished_tpu_maps', 0) or 0}  CPU maps: "
          f"{s.get('finished_cpu_maps', 0) or 0}")
    if s.get("acceleration_factor"):
        print(f"Acceleration factor: {s['acceleration_factor']:.2f}")
    if s.get("error"):
        print(f"Error: {s['error']}")
    kinds: "dict[str, int]" = {}
    for ev in events:
        kinds[ev.get("event", "?")] = kinds.get(ev.get("event", "?"), 0) + 1
    print("Events: " + ", ".join(f"{k}={v}"
                                 for k, v in sorted(kinds.items())))
    for ev in events:
        if ev.get("event") == "TASK_FAILED":
            where = "tpu" if ev.get("run_on_tpu") else "cpu"
            print(f"  failed: {ev.get('attempt_id', '?')} ({where} on "
                  f"{ev.get('tracker', '?')}, "
                  f"{ev.get('runtime', 0):.2f}s)")
    return 0


def cmd_pipeline(conf, argv: "list[str]") -> int:
    """Submit a ``JobGraph``'s wire form (JSON), poll, list or kill."""
    from tpumr_torch.ipc.rpc import RpcError
    usage = ("Usage: python -m tpumr_torch.cli pipeline submit GRAPH.json "
             "[-wait] | status ID | -list | -kill ID")
    if argv and argv[0].lstrip("-") == "trace":
        print(f"pipeline {argv[0]} {_NOT_PORTED}", file=sys.stderr)
        return 255
    if not _master(conf):
        print("pipelines need -jt HOST:PORT (a cluster master)",
              file=sys.stderr)
        return 255
    if not argv or (argv[0] != "-list" and len(argv) < 2):
        print(usage, file=sys.stderr)
        return 255
    from tpumr_torch.pipeline import PipelineClient
    client = PipelineClient(conf)
    cmd, *rest = argv
    try:
        if cmd == "submit":
            with open(rest[0]) as f:
                graph = json.load(f)
            running = client.submit(graph)
            print(running.pipeline_id, flush=True)
            if "-wait" in rest:
                st = running.wait_for_completion()
                print(json.dumps(st, indent=2, default=str))
                return 0 if st["state"] == "SUCCEEDED" else 1
            return 0
        if cmd in ("status", "-status"):
            print(json.dumps(client.status(rest[0]), indent=2, default=str))
            return 0
        if cmd == "-list":
            for p in client.list():
                done = sum(1 for n in p["nodes"].values()
                           if n["state"] == "SUCCEEDED")
                print(f"{p['pipeline_id']}\t{p['state']}"
                      f"\t{p.get('name', '')}"
                      f"\tstages={done}/{len(p['nodes'])}")
            return 0
        if cmd == "-kill":
            ok = client.running(rest[0]).kill()
            print(f"Killed {rest[0]}" if ok
                  else f"{rest[0]} already finished; not killed")
            return 0 if ok else 1
    except (RpcError, OSError, ValueError) as e:
        print(f"pipeline {cmd}: {e}", file=sys.stderr)
        return 1
    finally:
        client.close()
    print(f"pipeline: unknown option {cmd}", file=sys.stderr)
    return 255


def cmd_pipes(conf, argv: "list[str]") -> int:
    from tpumr_torch.pipes.submitter import main as pipes_main
    return pipes_main(argv)


def cmd_streaming(conf, argv: "list[str]") -> int:
    from tpumr_torch.streaming.stream_job import main as stream_main
    return stream_main(argv)


def cmd_examples(conf, argv: "list[str]") -> int:
    from tpumr_torch.examples import main as ex_main
    return ex_main(argv)


def cmd_version(conf, argv: "list[str]") -> int:
    print(f"tpumr_torch {VERSION}")
    return 0


COMMANDS = {
    "jobtracker": cmd_jobtracker,
    "tasktracker": cmd_tasktracker,
    "job": cmd_job,
    "pipeline": cmd_pipeline,
    "pipes": cmd_pipes,
    "streaming": cmd_streaming,
    "examples": cmd_examples,
    "version": cmd_version,
}


def main(argv: "list[str] | None" = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    overrides, conf_files, rest = _parse_generic(argv)
    if not rest:
        sys.stderr.write(USAGE)
        return 255
    cmd, *args = rest
    fn = COMMANDS.get(cmd)
    if fn is None:
        sys.stderr.write(f"Unknown command: {cmd}\n\n" + USAGE)
        return 255
    from tpumr_torch.core.configuration import Configuration
    layers: "list[dict | str]" = list(_site_files(conf_files))
    if overrides:
        layers.append(overrides)
    installed = 0
    try:
        for layer in layers:
            # a broken -conf file raises here, before the command runs
            Configuration.add_default_resource(layer)
            installed += 1
        return fn(_conf(overrides), args)
    finally:
        if installed:
            del Configuration._default_resources[-installed:]


if __name__ == "__main__":
    sys.exit(main())
