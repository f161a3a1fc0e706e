"""Chip smoke test of the PyTorch/CUDA port (tpumr_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--points N] [--hybrid-points N] [--tera-rows N]
                          [--pipeline-tera-rows N] [--profile]

Builds the port's CUDA kernels from tpumr_torch/csrc (one nvcc call) and
holds each against its plain torch version on the card:
kmeans_assign_partials (assignment fused with the per-cluster sums and
counts, d <= 32 and k <= 64) against assign_and_partials_plain, and
kmeans_assign (assignment only, every other shape, any k and d) against
assign_plain at eight shapes. Then it drives the port's main path: a
K-Means job (100,000,000 x 16 f32 points, k = 16, 25 dense splits of
4,000,000 rows, one reduce) through
tpumr_torch's LocalJobRunner, one cold run and three warm runs, then one
more warm job submitted without tpumr.local.run.on.tpu, as a user would.
It checks that every job launched the fused kernel once per split and
kmeans_assign never, and committed the same centroids as an oracle computed
here in float64. A second, smaller job whose shape lies outside the fused
range (2,000,000 x 40 points, k = 300, 4 splits) drives kmeans_assign once
per split, and its centroids are held against a float64 oracle too; so does
a third, over the k * d cap kmeans_assign had before its redesign
(1,000,000 x 128 points, k = 1,024, 4 splits).

Two more paths follow. Rounds: ten rounds of iterative K-Means over the
main path's points and resident splits, through expand_round and
KMeansCentroidUpdateReducer with a centroid file of its own per round
(cents-r{round}.npy); each round stages nothing, uploads no centroids after
round 0 (the reducer pre-seeds the next round's on the card) and launches
the fused kernel once per split; rounds 0 and 9 are held against a float64
Lloyd step. The same ten rounds again with the caches cleared before each
round must give byte-identical centroids, and the examples kmeans program
(python -m tpumr_torch.cli examples kmeans, in a process of its own,
beside the rounds) must give round 3's centroids exactly. Hybrid: bench.py's hybrid phase on the
port's MiniMRCluster (a job master and one node runner with 3 CPU map slots
and 1 GPU map slot, RPC over localhost, optional scheduling on): K-Means
over 32,000,000 x 16 points from default_rng(4) in 8 maps, three times
(kmeans_round1, kmeans_round2 over a warm split cache, kmeans_minimize
under tpumr.scheduler.mode=minimize), each placing maps on both pools,
launching kmeans_assign_partials once per GPU map and kmeans_assign never,
and committing the centroids of a float64 Lloyd step; kmeans_round2's
acceleration factor (mean CPU map seconds over mean GPU map seconds) must
exceed 1; then a 4,096^2 f32 matmul in 4 maps to SequenceFiles against a
float64 product. Pipeline: the pipeline engine on the hybrid phase's points
(the same file), on a MiniMRCluster of one GPU slot and no CPU slot: ten
K-Means rounds as one PipelineClient submission (a loop node whose
predicate never holds, versioned centroid files, KMeansCentroidUpdateReducer)
against ten JobClient submissions with the centroid caches cleared before
each (bench.py:262-381's pair): byte-identical final centroids,
kmeans_assign_partials 80 times on each side and kmeans_assign never, every
map on its first attempt, bytes staged in round 0 only, round 0 against a
float64 Lloyd step, and a loop from round 10's centroids that its predicate
settles after one round; one pipeline line with each side's seconds and
per-round overhead. Then python -m tpumr_torch.cli jobtracker and
tasktracker (one GPU slot) in processes of their own: examples kmeans and
pipeline submit -wait sent there with -jt, each equal to round 3's
centroids, job -list naming their 6 jobs, both daemons exiting 0 on
SIGTERM. Then TeraSort's chain (teragen, sort with the partition sampling
in the master's hook, validate) as one pipeline at 1,000,000 records on a
cluster of CPU slots, with a dfs and with a stream edge into validate: the
same sorted records, the input's count and checksum, an empty validate
output, and both validate splits streamed. On the pipeline's cluster, the
first part of the cluster_shuffle phase: one K-Means round clean and one
with every map's first output unfetchable
(tpumr.fi.shuffle.serve.a0.probability=1), which must give byte-identical
centroids with every map re-executed once on the GPU slot (8 and 16
kmeans_assign_partials launches) and the reduce on its first attempt. Matmul: the map-only blocked
product of two 4,096 x 4,096 f32 matrices (4 maps) in f32 and in bf16 with
f32 output, each against a float64 product, and a chain job D = C @ B that
reads C from the card (0 bytes staged).
Text: bench.py's pi job (8 maps of 50,000,000
samples, NLineInputFormat, one map per line) with its sampling and counting
on the card, cold then warm (total exact, the estimate within 6 sigma of pi,
one fetch per map, the same count bit for bit on the second run), the same
job on the CPU batch runner, and python -m tpumr_torch.cli examples pi in a
process of its own; then bench.py's 200 MB wordcount text through the
wordcount kernel (RawTextInputFormat) and the grep kernel
(TextInputFormat), each against an oracle over the whole file. Spill:
host jobs of the shuffle's spill-and-merge path under the default cuda
device, launching no kernel, each printing one JSON line (seconds, maps,
reduces, spills per map, merge, spill and combine counters, peak RSS): the
per-record wordcount (WordCountCpuMapper over TextInputFormat, one record
per word) over the text's first 64 MiB split at io.sort.mb 100 and
io.sort.spill.percent 0.8, 2 reduces, whose counts must equal an oracle and
whose map must spill at least 3 times, as its buffer reckons them;
Hadoop's Sort benchmark pair, randomwriter (6 maps of 128 MiB: upstream
writes 1 GB a map) then sort --total-order (12 maps of 64 MiB, 2 reduces,
io.sort.mb 32), which must take at least 2 merge passes, keep the input's
record count and order-independent checksum, and write keys that never
decrease across its parts in order; and secondarysort and join (inner and
outer) through python -m tpumr_torch.cli, each in a process of its own,
against oracles computed here. TeraSort
(BASELINE config 5, 10 GB): teragen of 100,000,000 records (16 maps), the
device-shuffled terasort (4 ranges), printing its stage seconds, peak
host and card memory and counters (TPU_SHUFFLE_RECORDS must be 10^8,
DEVICE_SORT_ON_ACCEL 1); the card's sort of all 10^8 keys held to a
stable order (a permutation, keys non-decreasing, equal keys in input
order) and, on the first 10^7, to np.lexsort; teravalidate on the output,
and the record count and an order-independent checksum of the output
equal to the input's; the same job on a MiniMRCluster of 4 CPU slots, 1
GPU slot and 1 reduce slot, sent through job_client.run_job, its gang
reduce fetching every map's dense output over RPC (the cluster_shuffle
phase's second part: the local run's part counts, the input's checksum,
teravalidate, one device argsort); then bench.py's 2,000,000 records
through the host shuffle and the device shuffle (the same records, part
for part), teragen, terasort --device-shuffle and teravalidate through
python -m tpumr_torch.cli at 1,000,000 records, each in a process of its
own, and last that CLI input sorted by the host shuffle on the cluster
(part for part the CLI's output) and 200,000 records with every shuffle
segment on disk and merged in the background (part for part the local
run's). The steps that run in processes of their own run beside this
process's work, and their times and those of the work beside them are
taken under that load: teragen of 10^8 beside the text and spill phases,
the daemons beside the pipeline's TeraSort chain, the CLI's pi beside
wordcount and grep, secondarysort and join beside the spill jobs, and the
CLI's TeraSort programs beside the shuffles at 2,000,000, and the rounds'
examples kmeans program beside the rounds and their float64 oracles.

Accel_fault, the accelerator fault tolerance on the card: after the kernel
checks, a real OOM on cuda:0 must class oom and a real refused launch of
kmeans_assign_partials (more blocks than tiles: cudaErrorInvalidValue)
device, after which the CUDA probe passes and a fused launch matches its
plain version. On the hybrid phase's cluster, over the hybrid points'
first 4 splits: three injected faults on card 0 (tpumr.fi.tpu.execute.d0)
quarantine it, the runner advertising 0 GPU slots at once, the probe
(every 200 ms) restores it and the map launches kmeans_assign_partials
there; then every GPU attempt failing (tpumr.fi.tpu.execute) demotes the
map and quarantines the job's GPU pass, and the job succeeds on the CPU
slots with no fused launch; both jobs' centroids against a float64 Lloyd
step. Through the pipeline phase's daemons: examples sleep --tpu
--hang-map 0 with mapred.task.timeout=2000 must have exactly one attempt
reaped (class timeout), map 0 succeed on attempt 1 and no task thread stay
on the runner. Every other cluster job (hybrid, pipeline, the daemons',
cluster_shuffle) must show no demotion and no reap.

Pipes_isolation, the external-process task tier: (a) beside the hybrid
jobs, native/pipes built into tpumr_torch/build/pipes (native/ untouched),
python -m tpumr_torch.cli pipes -program wordcount in a process of its
own, and the wordcount-part, sort and wordcount-nopipe children through
Submitter.run_job, each against tests/test_pipes.py's counts. On the
hybrid cluster, a GPU pipes child started beside accel_fault's steps
holds 4 GB of the card and is SIGKILLed after them: the card's free memory
must grow by the 4 GB within 5 s. The cluster then stays up, and (b) and
(c) run on it beside the pipeline phase's TeraSort chain:
(b) one K-Means round over the hybrid points (8 splits) as a pipes job
with a CPU executable (numpy) and a GPU executable that binds
cuda:argv[1] and launches kmeans_assign_partials (scripts written to the
work directory), non-piped input, a pipes reducer folding the partials:
centroids against the hybrid phase's float64 Lloyd step, both pools used,
argv[1] "0" on every GPU attempt, the GPU child's launch counter equal to
the GPU maps, every attempt on its first try, no demotion, the card's free
memory back after; (c) the hybrid K-Means job over the first 4 splits in
the runner's threads and with tpumr.task.isolation=process (CPU maps and
reduce in child processes, the GPU map in the runner): byte-identical
parts, and no child that opened the CUDA driver (/dev/nvidia* open in
/proc/PID/fd, as a first torch.cuda call does) or is among nvidia-smi's
compute apps.

User_api, the user API tiers: (a) right after the main path's warm jobs,
on its resident points, a tpumr_torch.mapreduce.Job (DenseInputFormat,
set_map_kernel("kmeans-assign"), a new-API Reducer folding the partials,
one reduce) as the first ControlledJob of a JobControl run on a thread of
its own, and a new-API host job depending on it (KeyValueTextInputFormat
over its part file, mapreduce.lib.InverseMapper, no reduce): the first
launches kmeans_assign_partials once a split (TPU_MAP_TASKS the splits),
commits the old-API warm job's part file byte for byte and meets the
float64 oracle's gate; the second starts after it and writes its lines
with key and value swapped; the JobControl thread ends. (b) this script
again with --user-api-host, a process of its own beside the spill phase,
under the default cuda device: a 32 MiB wordcount through python -m
tpumr_torch.cli streaming (a Python script mapper emitting
LongValueSum:<word> 1, -reducer aggregate) against collections.Counter;
a -io typedbytes identity job (cat as mapper and reducer) over 10,000
binary records, the records out equal to those in; ChainMapper ->
ChainReducer with a MultipleOutputs side file committed beside the part
file of one reduce; the inner join of 10,000 orders and 1,500 users lines
through contrib.datajoin; and a sqlite-to-sqlite job (DBInputFormat,
DBOutputFormat) over 10^5 rows, each against an oracle computed there.
Master_state, the master's state (job history, restart recovery,
speculation): the hybrid and pipeline clusters' masters write job history
and recover at start (grace 800 ms). (b), on the pipeline cluster after
cluster_shuffle (c): a 3-round K-Means loop node whose master is stopped
with nothing finalised once round 0's job committed, and a new master
started on its address: the pipeline succeeds, round 0 keeps its one job,
every round's centroids are byte-identical to the loop submission's same
round, kmeans_assign_partials 8 times a round. (c), on the hybrid
cluster after accel_fault: one K-Means round over the first 4 splits of
1,000,000 rows with map 0 a task.slow straggler for 8 s and speculation
on (the hybrid cluster turns it off for the other phases, whose gates
hold every map to its first attempt): only map 0 is twinned, its twin
wins, and the job ends under 8 s. (a), on the hybrid cluster after
pipes_isolation (c), beside the TeraSort chain: the hybrid K-Means job
(8 maps, slow start 1.0) whose master is
stopped once every map launched and 4 folded: the job succeeds under its
new id, which the polling client follows, with jobs_recovered 1, the
folded maps recovered, the runner adopted, no map launched by the
restarted master and kmeans_assign_partials once a GPU map; (a) and (c)
against float64 Lloyd steps.
It prints the last line

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

Any failed check exits non-zero; so does a machine without a CUDA device.
TF32 is off for every f32 product here and in the port
(torch.backends.cuda.matmul.allow_tf32 = False, float32 matmul precision
"highest"): the tolerances below assume full f32 products.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

#: H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s, fp32 FLOP/s
#: outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

D, K = 16, 16
ROWS_PER_SPLIT = 4_000_000
#: the second job, outside the fused kernel's range: points, d, k, rows per
#: split
JOB2_N, JOB2_D, JOB2_K, JOB2_ROWS = 2_000_000, 40, 300, 500_000
#: the third job, over the k * d <= 16,384 cap that kmeans_assign had before
#: its redesign: SIFT1M's base set (1,000,000 x 128) under FAISS's IVF1024
#: coarse quantizer (k = 1,024), synthetic from the seed
JOB3_N, JOB3_D, JOB3_K, JOB3_ROWS = 1_000_000, 128, 1_024, 250_000
#: ids may differ only at a near-tie, where the two best plain distances to
#: distinct centroids differ by less than this, relative (f32 sums in
#: another order flip such ties); and wherever they differ, the kernel's
#: pick must lie within this of the best plain distance
NEAR_TIE_RTOL = 1e-5
#: kernel-phase shapes (label, n, d, k) of kmeans_assign: the main path's
#: split, a ragged one, exact ties, the second job's split, few points of
#: 40 floats (split k), a large k over few points (split k), the third job's
#: split (k * d = 131,072), and few centroids over wide rows (bytes bound)
ASSIGN_SHAPES = [("main", ROWS_PER_SPLIT, D, K), ("ragged", 1_000_003, 5, 7),
                 ("ties", 1_000_000, 16, 16),
                 ("job2", JOB2_ROWS, JOB2_D, JOB2_K),
                 ("wide", 50_000, 40, 300), ("large_k", 10_000, 1, 16_384),
                 ("job3", JOB3_ROWS, JOB3_D, JOB3_K),
                 ("narrow_k", 1_000_000, 64, 10)]
#: ... where the one-hot partials that follow the kernel on a job's map are
#: timed too
ONEHOT_SHAPES = ("job2", "job3")
#: checked, not timed: a point tile too wide to stay resident in shared
#: memory (kmeans.assign_plan), a ragged last chunk of d and a ragged tile
STREAMED_SHAPE = ("streamed", 20_003, 200, 70)
#: ... and of kmeans_assign_partials: the main path's split, a ragged one,
#: exact ties, the edge of its range (d = 32, k = 64), and the main split's
#: shape with every coordinate 1000 + N(0, 1) (OFFSET): long one-signed
#: sums, where an accumulation that truncates would show
FUSED_SHAPES = [("main", ROWS_PER_SPLIT, D, K), ("ragged", 1_000_003, 5, 7),
                ("ties", 1_000_000, 16, 16), ("fused_edge", 1_000_003, 32, 64),
                ("offset", ROWS_PER_SPLIT, D, K)]
OFFSET = 1000.0
#: committed centroids against the float64 oracle. rtol 1e-4 as the JAX
#: package's tests hold f32 partial sums; atol 1e-5 because a near-tie
#: point the kernel and the oracle assign differently moves a mean by
#: |x| / count (about 1e-6 at this size), which no rtol covers for a
#: coordinate whose mean is near 0
CENTROID_RTOL, CENTROID_ATOL = 1e-4, 1e-5
#: rounds of iterative K-Means (bench.py's count) in each of the versioned
#: and the sequential runs, and the examples kmeans program's iterations
ROUNDS, CLI_ITERATIONS = 10, 3
#: the matmul job (bench.py:655-705): A and B n x n f32 from default_rng(2),
#: splits of MM_ROWS rows (4 maps)
MM_N, MM_ROWS = 4096, 1024
#: |C - C64| <= MM_ERR * (|A| . |B|) elementwise. An f32 dot of n terms is
#: off the exact one by at most about n * 2**-24 (2.4e-4 at n = 4,096) of
#: sum |a||b|, and typically by sqrt(n) * 2**-24 (3.8e-6) of it, since the
#: roundings are independent; 1e-5 sits between. bf16 products are held
#: against the float64 product of the bf16-rounded operands: a product of
#: two bf16 values is exact in f32, so only the accumulation errs. The
#: chain's D is held against (A @ B) @ B by the same rule with
#: (|A| . |B|) . |B|, which also covers C's own error carried through.
MM_ERR = 1e-5
#: bench.py's pi job (bench.py:607-649): maps of PI_SAMPLES samples each,
#: seeds 0..PI_MAPS-1; and the CLI's (its own seeds from 1000)
PI_MAPS, PI_SAMPLES = 8, 50_000_000
PI_CLI_MAPS, PI_CLI_SAMPLES = 8, 1_000_000
#: an estimate of pi from N samples must lie within PI_SIGMAS standard
#: deviations 4 * sqrt(p (1 - p) / N), p = pi / 4, of pi
PI_SIGMAS = 6
#: bench.py's wordcount text (bench.py:568-601): WC_MB MiB of lines of 12
#: words drawn from 4,096 by default_rng(1), no final newline; and the grep
#: pattern run over it (100 distinct matches)
WC_MB, WC_WORDS = 200, 4096
GREP_PATTERN = "word00[0-9]{2}"
#: bench.py's hybrid phase (bench.py:1168-1308): its seed, K-Means points
#: (written in chunks of HYB_CHUNK rows) in splits of HYB_ROWS rows (8 maps),
#: and the HYB_MM_N x HYB_MM_N matmul (4 maps); seconds a job may take
HYB_SEED, HYB_N, HYB_ROWS, HYB_CHUNK = 4, 32_000_000, 4_000_000, 2_000_000
HYB_MM_N = 4096
HYB_JOB_TIMEOUT_S = 120
#: the pipeline phase: the K-Means loop's rounds (bench.py:262-381's 10)
#: and the daemons' rounds (the rounds phase's CLI_ITERATIONS); TeraSort's
#: chain at PIPE_TERA_ROWS records (tests/test_pipeline.py's chain, grown
#: to the size of the terasort phase's CLI run), teragen maps and sort
#: reduces; seconds a pipeline may take
PIPE_ROUNDS, PIPE_CLI_ROUNDS = 10, 3
PIPE_TERA_ROWS, PIPE_TERA_MAPS, PIPE_TERA_REDUCES = 1_000_000, 4, 2
PIPE_TIMEOUT_S = 600
#: H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet, 700 W), FLOP/s
PEAK_BF16_FLOP_PER_S = 989e12
#: the accel_fault phase: the hybrid points' first ACCEL_SPLITS splits for
#: its demotion and quarantine jobs, the node runner's probe interval, the
#: device faults that quarantine a card (the default threshold), the
#: reaper's timeout for the daemons' sleep job, and the shape of the fused
#: launch that must match its plain version after the real faults
ACCEL_SPLITS, ACCEL_PROBE_MS, ACCEL_DEVICE_FAULTS = 4, 200, 3
ACCEL_SLEEP_TIMEOUT_MS = 2000
ACCEL_CHECK_N = 1_000_000
#: master_state: the recovery grace; (c)'s straggler crawl, its age floor,
#: and its job (4 splits of 1,000,000 rows: one CPU wave, then the twin's)
MS_GRACE_MS = 800
MS_SLOW_MS, MS_SPEC_FLOOR_S = 8000, 0.3
MS_SPEC_SPLITS, MS_SPEC_ROWS = 4, 1_000_000
#: master_state (b): the loop's rounds; at least this many maps folded
#: before (a) stops its master
MS_LOOP_ROUNDS, MS_FOLDED = 3, 4
#: the clusters that fail attempts or lose outputs on purpose (accel_fault,
#: cluster_shuffle (c)) must not blacklist their one runner
MS_MAX_FAULTS = 1000
#: the pipes_isolation phase: the card memory the killed GPU child holds
#: (MB), the seconds the card's free memory has to grow by it after the
#: kill, and the interval of the isolated children's samples (s)
PIPES_HOLD_MB, PIPES_FREE_S, PIPES_SAMPLE_S = 4096, 5.0, 0.2
#: the fused kernel's sums against a float64 sum over its own ids: within
#: this times the sum of |x| of the cluster's points, per dimension (f32
#: sums of at most a few thousand terms in a row, then in order)
SUMS_RTOL = 1e-5


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


#: one line at a time from the main thread and a Beside thread
_LOG_LOCK = threading.Lock()


def log(msg: str) -> None:
    with _LOG_LOCK:
        print(msg, flush=True)


class Beside:
    """``fn(*args)`` in a thread of its own, beside the caller's work: for
    steps that wait on processes of their own and so hold the interpreter
    lock little. :meth:`join` waits for it and returns its result, or
    raises what it raised (a failed ``check`` too). Join it in a
    ``finally``, so that the processes it started end with it."""

    def __init__(self, fn, *args) -> None:
        self._out: dict = {}

        def run() -> None:
            try:
                self._out["value"] = fn(*args)
            except BaseException as e:  # noqa: BLE001 — raised at join()
                self._out["error"] = e

        self._thread = threading.Thread(target=run, daemon=True,
                                        name=f"beside-{fn.__name__}")
        self._thread.start()

    def join(self, timeout: float = 1800) -> object:
        self._thread.join(timeout)
        check(not self._thread.is_alive(),
              f"{self._thread.name}: no end in {timeout} s")
        if "error" in self._out:
            raise self._out["error"]
        return self._out["value"]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def assign_bound_ms(n: int, d: int, k: int) -> tuple[float, str]:
    """Least time for the card: each point and centroid read once, each id
    written once, against 2nkd f32 operations."""
    t_bytes = (4 * n * d + 4 * k * d + 4 * n) / PEAK_BYTES_PER_S
    t_ops = 2 * n * k * d / PEAK_F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


def fused_bound_ms(n: int, d: int, k: int) -> tuple[float, str]:
    """Least time for the card for assignment plus partials: each point and
    centroid read once, each id, sum and count written once, against 2nkd
    operations of distances and nd additions of sums."""
    t_bytes = (4 * n * d + 4 * k * d + 4 * n + 4 * k * d + 4 * k) \
        / PEAK_BYTES_PER_S
    t_ops = (2 * n * k * d + n * d) / PEAK_F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


def plain_distances(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    x2 = (x * x).sum(dim=1, keepdim=True)
    return x2 - 2.0 * (x @ c.T) + (c * c).sum(dim=1)[None, :]


def compare_ids(x, c, ids, ref, distinct=None) -> dict:
    """The kernel's ids against the plain version's, over the plain
    distances d2. ``distinct`` holds the distinct centroids where ``c``
    repeats some (default ``c``): a near-tie is a point whose two best
    distances to distinct centroids differ by at most NEAR_TIE_RTOL,
    relative. Counts the mismatches, the near-ties, the mismatches away
    from a near-tie (``unexcused``) and the points whose kernel pick lies
    farther than NEAR_TIE_RTOL, relative, from the best distance
    (``far_picks``); ``max_abs_err`` is max |d2[kernel id] - d2[plain id]|."""
    d2 = plain_distances(x, c)
    best = d2.min(dim=1).values
    dd = d2 if distinct is None else plain_distances(x, distinct)
    best2 = dd.topk(2, dim=1, largest=False).values
    near = best2[:, 1] - best2[:, 0] <= NEAR_TIE_RTOL * best2[:, 0].abs()
    mism = ids != ref
    picked = d2.gather(1, ids.long()[:, None])[:, 0]
    planned = d2.gather(1, ref.long()[:, None])[:, 0]
    return {"mismatches": int(mism.sum()), "near_ties": int(near.sum()),
            "unexcused": int((mism & ~near).sum()),
            "far_picks": int((picked - best > NEAR_TIE_RTOL * best.abs())
                             .sum()),
            "max_abs_err": float((picked - planned).abs().max())}


def check_ids(label: str, cmp: dict) -> None:
    check(cmp["unexcused"] == 0, f"{label}: "
          f"{cmp['unexcused']} ids differ from assign_plain away from a "
          f"near-tie")
    check(cmp["far_picks"] == 0, f"{label}: "
          f"{cmp['far_picks']} points assigned to a centroid farther than "
          f"the nearest by more than {NEAR_TIE_RTOL} relative")


def make_inputs(label: str, n: int, d: int, k: int, gen):
    """Points and centroids of a kernel-phase shape, and for ``ties`` the
    distinct centroids (every centroid twice: each point's best distance is
    an exact tie, which must go to the lower copy). ``offset`` moves every
    point by OFFSET in every dimension; its centroids stay N(0, 1)."""
    x = torch.randn(n, d, device="cuda", generator=gen)
    if label == "offset":
        x += OFFSET
    if label == "ties":
        distinct = torch.randn(k // 2, d, device="cuda", generator=gen)
        return x, torch.cat([distinct, distinct]).contiguous(), distinct
    return x, torch.randn(k, d, device="cuda", generator=gen), None


def check_range_and_ties(name: str, label: str, ids, ref, k: int) -> None:
    check(int(ids.min()) >= 0 and int(ids.max()) < k,
          f"{name} {label}: id out of range")
    if label == "ties":
        check(int(ids.max()) < k // 2 and int(ref.max()) < k // 2,
              f"{name} ties: an exact tie went to the higher index")


def kernel_phase(km) -> dict:
    """kmeans_assign against assign_plain at every shape of ASSIGN_SHAPES
    (ids by the near-tie rules, two launches bitwise equal), with the plan
    it launched (kmeans.assign_plan) and its time beside the bound, the plain
    version and torch.cdist(x, c).argmin(1); at the jobs' splits
    (ONEHOT_SHAPES) also the one-hot partials that follow it on a map. The
    same checks, untimed, at STREAMED_SHAPE."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = {}
    for label, n, d, k in [*ASSIGN_SHAPES, STREAMED_SHAPE]:
        x, c, distinct = make_inputs(label, n, d, k, gen)
        ids = km.kmeans_assign(x, c)
        ids2 = km.kmeans_assign(x, c)
        ref = km.assign_plain(x, c)
        torch.cuda.synchronize()
        cmp = compare_ids(x, c, ids, ref, distinct)
        check_ids(f"kmeans_assign {label}", cmp)
        check_range_and_ties("kmeans_assign", label, ids, ref, k)
        check(torch.equal(ids, ids2), f"kmeans_assign {label}: two launches "
              f"on one input differ")
        plan = km.assign_plan(n, d, k, sms)
        row = {"shape": [n, d, k], **cmp,
               "plan": {"bn": plan.bn, "bm": plan.bm, "splits": plan.splits,
                        "resident": plan.resident}}
        if label == STREAMED_SHAPE[0]:
            check(not plan.resident, "the streamed shape's plan keeps its "
                  "point tile resident")
            log(f"check kmeans_assign {label} " + json.dumps(row))
            continue
        bound, bound_by = assign_bound_ms(n, d, k)
        row |= {"kernel_ms": time_ms(lambda: km.kmeans_assign(x, c)),
                "plain_ms": time_ms(lambda: km.assign_plain(x, c)),
                "library_ms": time_ms(
                    lambda: torch.cdist(x, c).argmin(dim=1)),
                "bound_ms": bound, "bound_by": bound_by}
        if label in ONEHOT_SHAPES:
            row["onehot_ms"] = time_ms(lambda: km.onehot_partials(x, ids, k))
        log(f"kernel kmeans_assign {label} " + json.dumps(row))
        rows[label] = row
        del x, c, ids, ids2, ref
    torch.cuda.empty_cache()
    return rows


def fused_phase(km) -> dict:
    """kmeans_assign_partials against assign_and_partials_plain at every
    shape of FUSED_SHAPES. Ids by the near-tie rules; counts equal to the
    bincount of the kernel's own ids; sums within SUMS_RTOL of a float64
    sum over those ids; two launches bitwise equal; the plan it launched
    (kmeans.fused_plan) no more blocks an SM than the card holds. Times the
    kernel, the unfused route (kmeans_assign and the one-hot partials) and the
    plain version."""
    import ctypes

    from tpumr_torch.ops import native
    gen = torch.Generator(device="cuda").manual_seed(1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = {}
    for label, n, d, k in FUSED_SHAPES:
        plan = km.fused_plan(n, d, k, sms)
        per_sm = ctypes.c_int(0)
        rc = native.load().kmeans_assign_partials_occupancy(
            d, k, 0, ctypes.byref(per_sm))
        check(rc == 0 and per_sm.value >= plan.blocks_per_sm,
              f"kmeans_assign_partials {label}: the card holds "
              f"{per_sm.value} blocks an SM (cudaError {rc}), the plan "
              f"{plan.blocks_per_sm}")
        x, c, distinct = make_inputs(label, n, d, k, gen)
        ids, sums, counts = km.kmeans_assign_partials(x, c)
        ids2, sums2, counts2 = km.kmeans_assign_partials(x, c)
        ref = km.assign_plain(x, c)
        torch.cuda.synchronize()
        cmp = compare_ids(x, c, ids, ref, distinct)
        check_ids(f"kmeans_assign_partials {label}", cmp)
        check_range_and_ties("kmeans_assign_partials", label, ids, ref, k)
        check(torch.equal(ids, ids2) and torch.equal(sums, sums2) and
              torch.equal(counts, counts2), f"kmeans_assign_partials "
              f"{label}: two launches on one input differ")
        check(torch.equal(counts, torch.bincount(ids, minlength=k)
                          .to(torch.int32)) and int(counts.sum()) == n,
              f"kmeans_assign_partials {label}: counts are not the "
              f"bincount of its ids")
        idx = ids.long()
        want = torch.zeros(k, d, dtype=torch.float64, device="cuda") \
            .index_add_(0, idx, x.double())
        scale = torch.zeros(k, d, dtype=torch.float64, device="cuda") \
            .index_add_(0, idx, x.double().abs())
        sums_err = (sums.double() - want).abs()
        check(bool((sums_err <= SUMS_RTOL * scale).all()),
              f"kmeans_assign_partials {label}: sums off the float64 sum "
              f"over its ids by up to "
              f"{float((sums_err / scale.clamp_min(1e-30)).max()):.3g} "
              f"of sum |x|")
        bound, bound_by = fused_bound_ms(n, d, k)
        row = {"shape": [n, d, k], **cmp,
               "sums_max_abs_err": float(sums_err.max()),
               "sums_max_rel_err": float((sums_err / scale.clamp_min(1e-30))
                                         .max()),
               "plan": {"dp": plan.dp, "tile": plan.tile,
                        "blocks_per_sm": plan.blocks_per_sm,
                        "grid": plan.grid, "occupancy": per_sm.value},
               "kernel_ms": time_ms(lambda: km.kmeans_assign_partials(x, c)),
               "unfused_route_ms": time_ms(lambda: km.onehot_partials(
                   x, km.kmeans_assign(x, c), k)),
               "plain_ms": time_ms(
                   lambda: km.assign_and_partials_plain(x, c)),
               "library_ms": None,
               "bound_ms": bound, "bound_by": bound_by}
        log(f"kernel kmeans_assign_partials {label} " + json.dumps(row))
        rows[label] = row
        del x, c, ids, ids2, sums, sums2, counts, counts2, ref, want, scale
    torch.cuda.empty_cache()
    return rows


def write_points(work: str, n: int, d: int = D, k: int = K,
                 rows: int = ROWS_PER_SPLIT, seed: int = 0,
                 prefix: str = "") -> np.ndarray:
    """bench.py's K-Means data (for the main path: d = 16, k = 16, seed 0):
    centroids then points from default_rng(seed), written chunked so host
    memory stays about one split."""
    rng = np.random.default_rng(seed)
    cents = rng.standard_normal(size=(k, d), dtype=np.float32)
    np.save(os.path.join(work, f"{prefix}cents.npy"), cents)
    header = np.lib.format.header_data_from_array_1_0(
        np.empty((0, d), np.float32))
    header["shape"] = (n, d)
    with open(os.path.join(work, f"{prefix}points.npy"), "wb") as out:
        np.lib.format.write_array_header_1_0(out, header)
        for lo in range(0, n, rows):
            m = min(rows, n - lo)
            out.write(rng.standard_normal(size=(m, d),
                                          dtype=np.float32).tobytes())
    return cents


def job_conf(work: str, out: str, run_on_tpu_key: bool = True,
             rows: int = ROWS_PER_SPLIT, prefix: str = ""):
    from tpumr_torch.mapred.input_formats import DenseInputFormat
    from tpumr_torch.mapred.jobconf import JobConf
    from tpumr_torch.ops.kmeans import CentroidReducer
    conf = JobConf()
    conf.set_input_paths(f"file://{work}/{prefix}points.npy")
    conf.set_output_path(f"file://{work}/{out}")
    conf.set_input_format(DenseInputFormat)
    conf.set("tpumr.dense.split.rows", rows)
    conf.set("tpumr.kmeans.centroids", f"file://{work}/{prefix}cents.npy")
    conf.set_reducer_class(CentroidReducer)
    conf.set_num_reduce_tasks(1)
    # the whole 6.4 GB dataset stays resident (8% of an 80 GB card)
    conf.set("tpumr.tpu.split.cache.mb", 8192)
    conf.set_map_kernel("kmeans-assign")
    if run_on_tpu_key:
        conf.set("tpumr.local.run.on.tpu", True)
    return conf


def read_centroids(path: str) -> dict:
    """The committed centroids, cluster id -> float64 row."""
    import ast
    got = {}
    with open(path) as f:
        for line in f:
            k, v = line.rstrip("\n").split("\t")
            got[int(k)] = np.array(ast.literal_eval(v), np.float64)
    return got


def launch_counts(km) -> dict:
    return {"kmeans_assign_partials": km.kmeans_assign_partials.launches,
            "kmeans_assign": km.kmeans_assign.launches}


def zero_launch_counts(km) -> None:
    km.kmeans_assign_partials.launches = 0
    km.kmeans_assign.launches = 0


def oracle(work: str, n: int, cents: np.ndarray, km,
           compare: bool = True) -> dict:
    """One float64 Lloyd step from ``cents``: the means under assign_plain's
    ids on the card, with float64 sums, chunked (a cluster without points
    keeps its centroid). With ``compare``, on the way, the fused kernel's
    ids against assign_plain on all n points."""
    pts = np.load(os.path.join(work, "points.npy"), mmap_mode="r")
    c = torch.from_numpy(cents).cuda()
    sums = torch.zeros(K, D, dtype=torch.float64, device="cuda")
    counts = torch.zeros(K, dtype=torch.int64, device="cuda")
    totals = {"mismatches": 0, "near_ties": 0, "unexcused": 0,
              "far_picks": 0}
    for lo in range(0, n, ROWS_PER_SPLIT):
        x = torch.from_numpy(np.array(pts[lo:lo + ROWS_PER_SPLIT])).cuda()
        ref = km.assign_plain(x, c)
        if compare:
            cmp = compare_ids(x, c, km.kmeans_assign_partials(x, c)[0], ref)
            for key in totals:
                totals[key] += cmp[key]
        onehot = torch.nn.functional.one_hot(ref.long(), K).double()
        sums += onehot.T @ x.double()
        counts += torch.bincount(ref, minlength=K)
    counts_h = counts.cpu().numpy()
    check(int(counts_h.sum()) == n, f"oracle counted {counts_h.sum()} of {n}")
    means = (sums / counts.clamp_min(1)[:, None]).cpu().numpy()
    return {"centroids": np.where(counts_h[:, None] > 0, means, cents),
            "counts": counts_h, "kernel_vs_plain": totals}


def main_path(work: str, n: int, km, profile: bool) -> dict:
    """The main path's points written to ``work``, where they stay for the
    rounds, and its jobs: cold, three warm, the default route."""
    from tpumr_torch.mapred import gpu_runner
    from tpumr_torch.mapred.local_runner import run_job
    from tpumr_torch.core.counters import BackendCounter, TaskCounter

    t0 = time.monotonic()
    cents = write_points(work, n)
    log(f"data: {n} x {D} f32 points written in "
        f"{time.monotonic() - t0:.3f}s")
    n_splits = -(-n // ROWS_PER_SPLIT)
    gpu_runner.clear_split_caches()
    jobs, outputs = [], []
    zero_launch_counts(km)               # the main path's count starts
    for i, kind in enumerate(["cold", "warm", "warm", "warm"]):
        km.clear_centroid_cache()        # as bench.py does per job
        cache = gpu_runner.split_cache(torch.device("cuda", 0),
                                       8192 << 20)
        hits0, launches0 = cache.hits, launch_counts(km)
        t = time.monotonic()
        result = run_job(job_conf(work, f"out{i}"))
        secs = time.monotonic() - t
        check(result.successful, f"job {i} failed")
        launches = {name: v - launches0[name]
                    for name, v in launch_counts(km).items()}
        row = {"job": i, "kind": kind, "seconds": secs,
               "records_per_s": n / secs, "maps": result.num_maps,
               "launches": launches,
               "split_cache_hits": cache.hits - hits0,
               "bytes_staged": result.counters.value(
                   BackendCounter.GROUP,
                   BackendCounter.TPU_DEVICE_BYTES_STAGED),
               "map_input_records": result.counters.value(
                   TaskCounter.FRAMEWORK_GROUP,
                   TaskCounter.MAP_INPUT_RECORDS)}
        log("job " + json.dumps(row))
        check(result.num_maps == n_splits,
              f"job {i}: {result.num_maps} maps, expected {n_splits}")
        check(launches == {"kmeans_assign_partials": n_splits,
                           "kmeans_assign": 0},
              f"job {i}: launches {launches} for {n_splits} splits; "
              f"expected the fused kernel once per split")
        check(row["map_input_records"] == n, f"job {i}: "
              f"MAP_INPUT_RECORDS {row['map_input_records']} != {n}")
        check(result.counters.value(
            BackendCounter.GROUP, BackendCounter.TPU_MAP_TASKS)
            == n_splits, f"job {i}: not every map ran on the device")
        jobs.append(row)
        with open(os.path.join(work, f"out{i}", "part-00000"), "rb") as f:
            outputs.append(f.read())
    # read before the oracle's comparison launches add to the count
    main_launches = launch_counts(km)
    check(all(o == outputs[0] for o in outputs),
          "the four jobs committed different centroids")
    default_route(work, n_splits, km, outputs[0])

    t = time.monotonic()
    ref = oracle(work, n, cents, km)
    got = read_centroids(os.path.join(work, "out0", "part-00000"))
    check(sorted(got) == list(range(K)),
          f"committed clusters {sorted(got)}")
    got = np.stack([got[i] for i in range(K)])
    err = np.abs(got - ref["centroids"])
    rel = float((err / np.abs(ref["centroids"])).max())
    log("oracle " + json.dumps({
        "seconds": time.monotonic() - t,
        "max_abs_err": float(err.max()), "max_rel_err": rel,
        "kernel_vs_plain": ref["kernel_vs_plain"],
        "counts": ref["counts"].tolist()}))
    check_ids("kmeans_assign_partials on the job's points",
              ref["kernel_vs_plain"])
    check(bool(np.all(err <= CENTROID_ATOL + CENTROID_RTOL *
                      np.abs(ref["centroids"]))),
          f"committed centroids off the float64 oracle: max abs "
          f"{err.max():.3g}, max rel {rel:.3g}")
    if profile:
        profile_warm_job(work)
    return {"jobs": jobs, "launches": main_launches, "part": outputs[0],
            "oracle": ref["centroids"]}


def default_route(work: str, n_splits: int, km, want: bytes) -> None:
    """One more warm job as a user would submit it, without
    tpumr.local.run.on.tpu: on the card every map still takes the device
    path and launches the fused kernel, and none runs on the host."""
    from tpumr_torch.core.counters import BackendCounter
    from tpumr_torch.mapred.local_runner import run_job
    km.clear_centroid_cache()
    launches0 = km.kmeans_assign_partials.launches
    result = run_job(job_conf(work, "out-default", run_on_tpu_key=False))
    counts = {name: result.counters.value(BackendCounter.GROUP, name)
              for name in (BackendCounter.TPU_MAP_TASKS,
                           BackendCounter.CPU_MAP_TASKS,
                           BackendCounter.CPU_BATCH_MAP_TASKS)}
    counts["kmeans_assign_partials_launches"] = \
        km.kmeans_assign_partials.launches - launches0
    log("default_route " + json.dumps(counts))
    check(counts["kmeans_assign_partials_launches"] == n_splits and
          counts[BackendCounter.TPU_MAP_TASKS] == n_splits and
          counts[BackendCounter.CPU_MAP_TASKS] == 0 and
          counts[BackendCounter.CPU_BATCH_MAP_TASKS] == 0,
          "without tpumr.local.run.on.tpu the job did not run every map "
          "through the kernel on the card")
    with open(os.path.join(work, "out-default", "part-00000"), "rb") as f:
        check(f.read() == want, "the job without tpumr.local.run.on.tpu "
              "committed other centroids")


def second_job(km) -> dict:
    """A job outside the fused range (JOB2_N x JOB2_D points, JOB2_K
    centroids, splits of JOB2_ROWS, seed 2), through :func:`outside_job`."""
    return outside_job(km, "second_job", JOB2_N, JOB2_D, JOB2_K, JOB2_ROWS,
                       seed=2)


def third_job(km) -> dict:
    """A job over the k * d cap that kmeans_assign had before its redesign
    (JOB3_N x JOB3_D points, JOB3_K centroids, splits of JOB3_ROWS, seed 3),
    through :func:`outside_job`."""
    return outside_job(km, "third_job", JOB3_N, JOB3_D, JOB3_K, JOB3_ROWS,
                       seed=3)


def outside_job(km, label: str, n: int, d: int, k: int, rows: int,
                seed: int) -> dict:
    """A job outside the fused range: every map launches kmeans_assign and
    the one-hot partials. Its committed centroids against a float64 oracle
    of the means under kmeans_assign's own ids, and those ids against
    assign_plain by the near-tie rules."""
    from tpumr_torch.mapred import gpu_runner
    from tpumr_torch.mapred.local_runner import run_job

    work = tempfile.mkdtemp(prefix=f"tpumr_torch-{label}-")
    try:
        cents = write_points(work, n, d, k, rows, seed=seed)
        n_splits = -(-n // rows)
        gpu_runner.clear_split_caches()
        km.clear_centroid_cache()
        zero_launch_counts(km)               # this path's count starts
        t = time.monotonic()
        result = run_job(job_conf(work, "out", rows=rows))
        secs = time.monotonic() - t
        launches = launch_counts(km)
        check(result.successful, f"{label} failed")
        check(launches == {"kmeans_assign_partials": 0,
                           "kmeans_assign": n_splits},
              f"{label}: launches {launches} for {n_splits} splits; "
              f"expected kmeans_assign once per split")

        pts = np.load(os.path.join(work, "points.npy"), mmap_mode="r")
        c = torch.from_numpy(cents).cuda()
        sums = torch.zeros(k, d, dtype=torch.float64, device="cuda")
        counts = torch.zeros(k, dtype=torch.int64, device="cuda")
        totals = {"mismatches": 0, "near_ties": 0, "unexcused": 0,
                  "far_picks": 0}
        for lo in range(0, n, rows):
            x = torch.from_numpy(np.array(pts[lo:lo + rows])).cuda()
            ids = km.kmeans_assign(x, c)
            cmp = compare_ids(x, c, ids, km.assign_plain(x, c))
            for key in totals:
                totals[key] += cmp[key]
            sums.index_add_(0, ids.long(), x.double())
            counts += torch.bincount(ids, minlength=k)
        check_ids(f"kmeans_assign on the {label} points", totals)
        counts_h = counts.cpu().numpy()
        want = (sums / counts.clamp_min(1)[:, None]).cpu().numpy()
        got = read_centroids(os.path.join(work, "out", "part-00000"))
        live = [int(j) for j in np.flatnonzero(counts_h)]
        check(sorted(got) == live, f"{label}: committed clusters are not "
              f"the clusters with points")
        got = np.stack([got[j] for j in live])
        err = np.abs(got - want[live])
        check(bool(np.all(err <= CENTROID_ATOL + CENTROID_RTOL *
                          np.abs(want[live]))),
              f"{label}: committed centroids off the float64 oracle: "
              f"max abs {err.max():.3g}")
        row = {"shape": [n, d, k], "splits": n_splits, "seconds": secs,
               "launches": launches, "clusters": len(live),
               "max_abs_err": float(err.max()), "kernel_vs_plain": totals}
        log(f"{label} " + json.dumps(row))
        return row
    finally:
        gpu_runner.clear_split_caches()
        shutil.rmtree(work, ignore_errors=True)


def round_conf(work: str, prefix: str, rows: int) -> dict:
    """bench.py's round conf (bench.py:290-305) for the local runner on the
    card, templated by round: the centroids in from {prefix}cents-r{round}
    and out to {prefix}cents-r{next_round}, the kernel mapper named, the
    whole dataset resident."""
    return {
        "mapred.input.dir": f"file://{work}/points.npy",
        "mapred.output.dir": f"file://{work}/{prefix}round-out-r{{round}}",
        "mapred.input.format.class":
            "tpumr_torch.mapred.input_formats.DenseInputFormat",
        "tpumr.dense.split.rows": rows,
        "mapred.reducer.class":
            "tpumr_torch.ops.kmeans.KMeansCentroidUpdateReducer",
        "mapred.reduce.tasks": 1,
        "tpumr.kmeans.centroids": f"file://{work}/{prefix}cents-r{{round}}.npy",
        "tpumr.kmeans.centroids.out":
            f"file://{work}/{prefix}cents-r{{next_round}}.npy",
        "tpumr.map.kernel": "kmeans-assign",
        "tpumr.tpu.split.cache.mb": 8192,
    }


def run_rounds(work: str, prefix: str, n: int, km,
               clear_each_round: bool) -> list:
    """ROUNDS rounds from {prefix}cents-r0.npy, one job each. Checks every
    round: 0 bytes staged and a split-cache hit per split (the main path's
    splits are resident), the fused kernel once per split and kmeans_assign
    never, the next round's centroid tag resident on the card, and the
    shift counter equal to round(1000 * sum |r_next - r|) of the two
    files; centroid uploads: once in round 0 and never after for versioned
    rounds, once per round where the caches are cleared."""
    from tpumr_torch.core.counters import BackendCounter
    from tpumr_torch.mapred import gpu_runner
    from tpumr_torch.mapred.jobconf import JobConf
    from tpumr_torch.mapred.local_runner import run_job
    from tpumr_torch.ops import devcache
    from tpumr_torch.pipeline.graph import expand_round
    n_splits = -(-n // ROWS_PER_SPLIT)
    template = round_conf(work, prefix, ROWS_PER_SPLIT)
    rows = []
    for r in range(ROUNDS):
        if clear_each_round:
            km.clear_centroid_cache()    # bench.py:320-336's shape
        conf = JobConf()
        for key, value in expand_round(template, r).items():
            conf.set(key, value)
        cache = gpu_runner.split_cache(torch.device("cuda", 0), 8192 << 20)
        hits0, launches0 = cache.hits, launch_counts(km)
        uploads0 = km.centroids_from_numpy.uploads
        preseeds0 = km.KMeansCentroidUpdateReducer.preseeds
        t = time.monotonic()
        result = run_job(conf)
        secs = time.monotonic() - t
        check(result.successful, f"{prefix}round {r} failed")
        row = {"round": r, "seconds": secs,
               "bytes_staged": result.counters.value(
                   BackendCounter.GROUP,
                   BackendCounter.TPU_DEVICE_BYTES_STAGED),
               "split_cache_hits": cache.hits - hits0,
               "centroid_uploads": km.centroids_from_numpy.uploads - uploads0,
               "preseeds": km.KMeansCentroidUpdateReducer.preseeds
               - preseeds0,
               "launches": {name: v - launches0[name]
                            for name, v in launch_counts(km).items()},
               "shift_milli": result.counters.value(
                   km.SHIFT_COUNTER_GROUP, km.SHIFT_COUNTER)}
        log(f"rounds {'sequential' if clear_each_round else 'versioned'} "
            + json.dumps(row))
        label = f"{prefix}round {r}"
        check(row["bytes_staged"] == 0 and
              row["split_cache_hits"] == n_splits,
              f"{label}: staged {row['bytes_staged']} bytes, "
              f"{row['split_cache_hits']} split-cache hits of {n_splits}")
        want_uploads = 1 if clear_each_round or r == 0 else 0
        check(row["centroid_uploads"] == want_uploads,
              f"{label}: {row['centroid_uploads']} centroid uploads, "
              f"expected {want_uploads}")
        check(row["preseeds"] == 1, f"{label}: the reducer pre-seeded "
              f"{row['preseeds']} times")
        check(row["launches"] == {"kmeans_assign_partials": n_splits,
                                  "kmeans_assign": 0},
              f"{label}: launches {row['launches']}")
        tag = f"kmeans-centroids:file://{work}/{prefix}cents-r{r + 1}.npy"
        check(tag in devcache.inventory(),
              f"{label}: {tag} is not resident after the round")
        prev = np.load(os.path.join(work, f"{prefix}cents-r{r}.npy"))
        new = np.load(os.path.join(work, f"{prefix}cents-r{r + 1}.npy"))
        want_shift = int(round(float(np.abs(new - prev).sum()) * 1000))
        check(row["shift_milli"] == want_shift,
              f"{label}: CENTROID_SHIFT_MILLI {row['shift_milli']}, the "
              f"files give {want_shift}")
        rows.append(row)
    return rows


def rounds_phase(work: str, n: int, km) -> dict:
    """Iterative K-Means over the main path's points and resident splits:
    ROUNDS versioned rounds (no clear between them), rounds 0 and 9 against
    a float64 Lloyd step each; the same rounds with the caches cleared
    before each round, byte-identical (bench.py:379-381); and the examples
    kmeans program for CLI_ITERATIONS iterations in a process of its own
    beside them, equal to the versioned rounds' file of that round."""
    from tpumr_torch.examples.basic import load_npy_rows
    from tpumr_torch.fs.filesystem import FileSystem
    points = f"file://{work}/points.npy"
    seeds = load_npy_rows(FileSystem.get(points), points, K)
    for prefix in ("", "seq-"):
        np.save(os.path.join(work, f"{prefix}cents-r0.npy"),
                seeds.astype(np.float32))
    out = os.path.join(work, "cli-out")
    cmd = [sys.executable, "-m", "tpumr_torch.cli", "examples", "kmeans",
           points, f"file://{out}", "-k", str(K), "-i", str(CLI_ITERATIONS),
           "--split-rows", str(ROWS_PER_SPLIT)]

    def cli() -> float:
        t = time.monotonic()
        proc = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(
            __file__)), capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0, f"examples kmeans exited "
              f"{proc.returncode}: {proc.stderr[-2000:]}")
        return time.monotonic() - t

    # the program, a process of its own that seeds from the points as the
    # rounds do, runs beside the rounds and their oracles
    beside = Beside(cli)
    try:
        zero_launch_counts(km)               # the rounds' count starts
        t = time.monotonic()
        versioned = run_rounds(work, "", n, km, clear_each_round=False)
        sequential = run_rounds(work, "seq-", n, km, clear_each_round=True)
        launches = launch_counts(km)
        secs = time.monotonic() - t
        km.clear_pipeline_caches()           # teardown: one sweep
        final = []
        for prefix in ("", "seq-"):
            with open(os.path.join(work, f"{prefix}cents-r{ROUNDS}.npy"),
                      "rb") as f:
                final.append(f.read())
        check(final[0] == final[1], "sequential rounds' final centroids "
              "differ from the versioned rounds'")

        oracles = {}
        for r in (0, ROUNDS - 1):
            cents = np.load(os.path.join(work, f"cents-r{r}.npy"))
            got = np.load(os.path.join(work, f"cents-r{r + 1}.npy"))
            want = oracle(work, n, cents, km, compare=False)["centroids"]
            err = np.abs(got - want)
            oracles[r] = float(err.max())
            check(bool(np.all(err <= CENTROID_ATOL + CENTROID_RTOL *
                              np.abs(want))),
                  f"round {r}: centroids off a float64 Lloyd step by up to "
                  f"{err.max():.3g}")
    finally:
        t_cli = beside.join()
    cli_final = np.load(os.path.join(out, "centroids.npy"))
    want = np.load(os.path.join(work, f"cents-r{CLI_ITERATIONS}.npy"))
    check(cli_final.dtype == want.dtype and
          np.array_equal(cli_final, want),
          f"examples kmeans' centroids after {CLI_ITERATIONS} iterations "
          f"differ from round {CLI_ITERATIONS}'s by up to "
          f"{float(np.abs(cli_final - want).max()):.3g}")
    warm = [r["seconds"] for r in versioned[1:]]
    summary = {"rounds": ROUNDS, "seconds": secs, "launches": launches,
               "versioned_round_s": [r["seconds"] for r in versioned],
               "sequential_round_s": [r["seconds"] for r in sequential],
               "warm_round_s_median": float(np.median(warm)),
               "oracle_max_abs_err": oracles,
               "cli_seconds": t_cli, "cli_equal_round": CLI_ITERATIONS}
    log("rounds_summary " + json.dumps(summary))
    return summary


FAULT_METRICS = ("tpu_demotions", "jobs_tpu_quarantined",
                 "tasks_reaped_timeout", "tpu_devices_quarantined")


def check_no_faults(master, label: str) -> dict:
    """accel_fault (5): no job a cluster ran was demoted or reaped: the
    master's counts and every job's TPU_DEMOTIONS and TASKS_REAPED_TIMEOUT
    are 0."""
    from tpumr_torch.core.counters import JobCounter
    metrics = master.get_metrics()
    with master.lock:
        jobs = list(master.jobs.values())
    # the fault counts; the master's other counts (launches, recovery)
    # are no fault
    bad = {k: metrics[k] for k in FAULT_METRICS if metrics[k]}
    for jip in jobs:
        for name in (JobCounter.TPU_DEMOTIONS,
                     JobCounter.TASKS_REAPED_TIMEOUT):
            v = jip.counters.value(JobCounter.GROUP, name)
            if v:
                bad[f"{jip.job_id} {name}"] = v
    check(not bad, f"{label}: demotions or reaps in a clean run: {bad}")
    return {"jobs": len(jobs), **metrics}


def accel_fault_real(km) -> dict:
    """accel_fault (1): real faults on the card, classified as the node
    runner classes them. An allocation past the free memory of cuda:0 is
    torch.OutOfMemoryError, class oom; kmeans_assign_partials launched with
    more blocks than tiles, through native.load() directly and through its
    wrapper (its plan replaced for the call), returns cudaErrorInvalidValue
    and the wrapper's RuntimeError is class device. After both the CUDA
    probe passes and a fused launch matches its plain version: the context
    is sound."""
    from tpumr_torch.mapred.node_health import default_tpu_probe
    from tpumr_torch.mapred.task import classify_accelerator_exception
    from tpumr_torch.ops import native
    t0 = time.monotonic()
    free, _total = torch.cuda.mem_get_info(0)
    try:
        torch.empty(free + (4 << 30), dtype=torch.uint8, device="cuda:0")
        fail("accel_fault: an allocation past the free memory succeeded")
    except torch.OutOfMemoryError as e:
        oom = classify_accelerator_exception(e)
    torch.cuda.empty_cache()
    check(oom == "oom", f"accel_fault: a real OOM classed {oom!r}")

    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(ACCEL_CHECK_N, D, device="cuda", generator=gen)
    c = torch.randn(K, D, device="cuda", generator=gen)
    plan = km.fused_plan(ACCEL_CHECK_N, D, K,
                         torch.cuda.get_device_properties(0)
                         .multi_processor_count)
    tiles = -(-ACCEL_CHECK_N // plan.tile)
    scratch = torch.empty((K * D + K) * (tiles + 2), dtype=torch.float32,
                          device="cuda")
    ids = torch.empty(ACCEL_CHECK_N, dtype=torch.int32, device="cuda")
    rc = native.load().kmeans_assign_partials(
        x.data_ptr(), c.data_ptr(), ids.data_ptr(), scratch.data_ptr(),
        scratch.data_ptr(), scratch.data_ptr(), ACCEL_CHECK_N, D, K,
        plan.tile, 2 ** 31 - 1, 0, torch.cuda.current_stream().cuda_stream)
    check(rc in (1, 9), f"accel_fault: a launch of 2**31 - 1 blocks gave "
          f"cudaError {rc}, not 1 (invalid value) or 9 (invalid "
          "configuration)")
    real_plan = km._fused_plan_on
    km._fused_plan_on = lambda dev, n, d, k: plan._replace(grid=tiles + 1)
    launches = km.kmeans_assign_partials.launches
    try:
        km.kmeans_assign_partials(x, c)
        fail("accel_fault: a launch of more blocks than tiles succeeded")
    except RuntimeError as e:
        launch_error, device = str(e), classify_accelerator_exception(e)
    finally:
        km._fused_plan_on = real_plan
    check(device == "device", f"accel_fault: {launch_error!r} classed "
          f"{device!r}")
    check(km.kmeans_assign_partials.launches == launches,
          "accel_fault: a refused launch was counted")
    torch.cuda.synchronize()
    default_tpu_probe(0)
    ids, sums, counts = km.kmeans_assign_partials(x, c)
    ref, ref_sums, ref_counts = km.assign_and_partials_plain(x, c)
    cmp = compare_ids(x, c, ids, ref)
    check_ids("accel_fault: the fused launch after the faults", cmp)
    check(torch.equal(counts, torch.bincount(ids, minlength=K)
                      .to(torch.int32)),
          "accel_fault: counts after the faults are not the bincount of "
          "the ids")
    want = torch.zeros(K, D, dtype=torch.float64, device="cuda") \
        .index_add_(0, ids.long(), x.double())
    scale = torch.zeros(K, D, dtype=torch.float64, device="cuda") \
        .index_add_(0, ids.long(), x.double().abs())
    check(bool(((sums.double() - want).abs() <= SUMS_RTOL * scale).all()),
          "accel_fault: sums after the faults off the float64 sums")
    row = {"oom_class": oom, "launch_rc": rc, "launch_error": launch_error,
           "launch_class": device, "probe": "passed",
           "mismatches": cmp["mismatches"], "near_ties": cmp["near_ties"],
           "seconds": time.monotonic() - t0}
    del x, c, ids, sums, counts, ref, ref_sums, ref_counts, want, scale, \
        scratch
    torch.cuda.empty_cache()
    log("accel_fault_real " + json.dumps(row))
    return row


def accel_fault_job(c, conf, km, tag: str, work: str, ref) -> dict:
    """One K-Means job of the accel_fault phase on the hybrid cluster: its
    seconds, status, counters, failed attempts and fused launches, and its
    centroids against the float64 Lloyd step ``ref``."""
    from tpumr_torch.core.counters import JobCounter
    from tpumr_torch.mapred.job_client import JobClient
    from tpumr_torch.mapred.task import TaskState
    km.clear_centroid_cache()
    client = JobClient(conf)
    try:
        zero_launch_counts(km)
        t = time.monotonic()
        running = client.submit_job(conf)
        st = running.wait_for_completion(timeout=HYB_JOB_TIMEOUT_S)
        secs = time.monotonic() - t
        launches = launch_counts(km)
    finally:
        client.close()
    check(st["state"] == "SUCCEEDED", f"accel_fault {tag}: {st['state']} "
          f"{st.get('error', '')}")
    jip = c.master.jobs[running.job_id]
    failed = [(str(a.attempt_id), a.failure_class) for tip in jip.maps
              for a in tip.attempts.values() if a.state == TaskState.FAILED]
    got = read_centroids(os.path.join(work, tag, "part-00000"))
    check(sorted(got) == list(range(K)), f"accel_fault {tag}: clusters "
          f"{sorted(got)}")
    got = np.stack([got[i] for i in range(K)])
    err = np.abs(got - ref)
    check(bool(np.all(err <= CENTROID_ATOL + CENTROID_RTOL * np.abs(ref))),
          f"accel_fault {tag}: centroids off the float64 oracle by up to "
          f"{err.max():.3g}")
    return {"job_s": secs, "launches": launches, "failed": failed,
            "TPU_DEMOTIONS": jip.counters.value(JobCounter.GROUP,
                                                JobCounter.TPU_DEMOTIONS),
            "tpu_disabled": st["tpu_disabled"],
            "tpu_demoted_tips": st["tpu_demoted_tips"],
            "finished_tpu_maps": st["finished_tpu_maps"],
            "finished_cpu_maps": st["finished_cpu_maps"],
            "max_abs_err": float(err.max()), "t0": t}


def accel_fault_cluster(c, work: str, n: int, cents, km) -> dict:
    """accel_fault (2, 3) on the hybrid phase's running cluster (1 runner,
    3 CPU + 1 GPU slots), K-Means over the hybrid points' first
    ACCEL_SPLITS splits with the same centroids, each job's centroids
    against a float64 Lloyd step.

    (3) first, while card 0's streak of failures is clean: at most
    ACCEL_DEVICE_FAULTS faults at tpumr.fi.tpu.execute.d0 (class device),
    tpumr.tpu.attempt.retries above them and tpumr.tpu.job.quarantine.tips
    above the maps, so that nothing is demoted. The GPU slot fails its map
    three times while the CPU slots hold the others; the runner must
    advertise 0 GPU slots the moment the third failure quarantines the
    card; the CUDA probe (every ACCEL_PROBE_MS) restores it; the map then
    launches kmeans_assign_partials there. (2): every GPU attempt fails
    (tpumr.fi.tpu.execute.probability=1), class device, before staging:
    the map is demoted and, with tpumr.tpu.job.quarantine.tips=1 (only the
    first map reaches the one GPU slot while the CPU slots hold the
    others), the job's GPU pass quarantined; it succeeds on the CPU slots
    with 0 fused launches."""
    from tpumr_torch.mapred.input_formats import DenseInputFormat
    from tpumr_torch.utils import fi
    n4 = min(n, ACCEL_SPLITS * HYB_ROWS)
    t0 = time.monotonic()
    # the first splits as a file of their own: header, then the rows
    header = np.lib.format.header_data_from_array_1_0(
        np.empty((0, D), np.float32))
    header["shape"] = (n4, D)
    src = np.load(os.path.join(work, "points.npy"), mmap_mode="r")
    with open(os.path.join(work, "points4.npy"), "wb") as out:
        np.lib.format.write_array_header_1_0(out, header)
        for lo in range(0, n4, HYB_ROWS):
            out.write(np.ascontiguousarray(src[lo:lo + HYB_ROWS]).tobytes())
    del src
    ref = oracle(work, n4, cents, km, compare=False)["centroids"]
    setup_s = time.monotonic() - t0

    def job(tag: str, **keys):
        conf = c.create_job_conf()
        conf.set_job_name(f"accel-{tag}")
        conf.set_input_paths(f"file://{work}/points4.npy")
        conf.set_output_path(f"file://{work}/{tag}")
        conf.set_input_format(DenseInputFormat)
        conf.set("tpumr.dense.split.rows", HYB_ROWS)
        conf.set("tpumr.kmeans.centroids", f"file://{work}/cents.npy")
        conf.set_map_kernel("kmeans-assign")
        conf.set("mapred.reducer.class",
                 "tpumr_torch.ops.kmeans.CentroidReducer")
        conf.set_num_reduce_tasks(1)
        conf.set("tpumr.fi.seed", 20260804)
        for k, v in keys.items():
            conf.set(k, v)
        return accel_fault_job(c, conf, km, tag, work, ref)

    tracker = c.trackers[0]
    dh = tracker.device_health
    check(dh is not None and dh.threshold == ACCEL_DEVICE_FAULTS
          and dh.quarantined() == [], "accel_fault: the runner's device "
          "health is not armed")
    events: list = []
    record, probe_once = dh.record_failure, dh.probe_once

    def recorded(d):
        newly = record(d)
        if newly:
            events.append(("quarantined", time.monotonic(),
                           tracker._status_dict()["max_tpu_map_slots"]))
        return newly

    def probed(now=None):
        restored = probe_once(now)
        if restored:
            events.append(("restored", time.monotonic(),
                           tracker._status_dict()["max_tpu_map_slots"]))
        return restored

    dh.record_failure, dh.probe_once = recorded, probed
    fi.reset()
    try:
        quar = job("quarantine", **{
            "tpumr.fi.tpu.execute.d0.probability": 1.0,
            "tpumr.fi.tpu.execute.d0.max.failures": ACCEL_DEVICE_FAULTS,
            "tpumr.tpu.attempt.retries": ACCEL_DEVICE_FAULTS + 1,
            "tpumr.tpu.job.quarantine.tips": 100})
        fired_d0 = fi.fired("tpu.execute.d0")
    finally:
        del dh.record_failure, dh.probe_once
    check(fired_d0 == ACCEL_DEVICE_FAULTS and [f for _a, f in quar["failed"]]
          == ["device"] * ACCEL_DEVICE_FAULTS, f"accel_fault quarantine: "
          f"{fired_d0} faults, failed attempts {quar['failed']}")
    check([(kind, slots) for kind, _t, slots in events]
          == [("quarantined", 0), ("restored", 1)], f"accel_fault "
          f"quarantine: the runner advertised {events} GPU slots")
    check(quar["TPU_DEMOTIONS"] == 0 and not quar["tpu_disabled"],
          "accel_fault quarantine: a map was demoted")
    check(quar["launches"]["kmeans_assign_partials"] >= 1
          and quar["launches"]["kmeans_assign_partials"]
          == quar["finished_tpu_maps"], f"accel_fault quarantine: "
          f"{quar['launches']} launches for {quar['finished_tpu_maps']} GPU "
          "maps after the restore")
    quar["quarantined_after_s"] = events[0][1] - quar["t0"]
    quar["restored_after_s"] = events[1][1] - quar["t0"]
    quar["quarantine_to_restore_s"] = events[1][1] - events[0][1]

    fi.reset()
    try:
        demo = job("demotion", **{"tpumr.fi.tpu.execute.probability": 1.0,
                                  "tpumr.tpu.job.quarantine.tips": 1})
        fired = fi.fired("tpu.execute")
    finally:
        fi.reset()
    check(demo["TPU_DEMOTIONS"] >= 1 and demo["tpu_disabled"],
          f"accel_fault demotion: {demo['TPU_DEMOTIONS']} demotions, GPU "
          f"pass quarantined {demo['tpu_disabled']}")
    check(fired >= 1 and {f for _a, f in demo["failed"]} == {"device"},
          f"accel_fault demotion: {fired} faults, failed {demo['failed']}")
    check(demo["launches"]["kmeans_assign_partials"] == 0
          and demo["finished_tpu_maps"] == 0, f"accel_fault demotion: "
          f"{demo['launches']} launches, {demo['finished_tpu_maps']} GPU maps")
    for row in (quar, demo):
        del row["t0"]
    out = {"quarantine": quar, "demotion": demo, "setup_s": setup_s,
           "seconds": time.monotonic() - t0}
    log("accel_fault_cluster " + json.dumps(out))
    return out


def _repo() -> str:
    return os.path.dirname(os.path.abspath(__file__))


#: what both K-Means pipes executables share: the split's rows read from
#: the .npy by the child itself (tpumr.pipes.piped.input=false), the
#: centroids from the job's conf, and the k partial records a map emits
#: (key: cluster id; value: count, then the d sums, as Python floats)
PIPES_COMMON = '''\
#!{python}
"""A K-Means {role} pipes executable of chip_smoke.py's pipes phase."""
import time

T0 = time.monotonic()
import json
import sys

sys.path.insert(0, {repo!r})
import numpy as np

from tpumr_torch.pipes import child


def _local(path):
    return path[len("file://"):] if path.startswith("file://") else path


def split_rows(ctx):
    s = json.loads(ctx.input_split.decode())
    n, cols = int(s["num_rows"]), int(s["cols"])
    x = np.fromfile(_local(s["path"]), dtype=s["dtype"], count=n * cols,
                    offset=int(s["data_offset"])
                    + int(s["row_start"]) * int(s["row_bytes"]))
    return x.reshape(n, cols)


def centroids(ctx):
    return np.load(_local(ctx.get_job_conf().get(
        "tpumr.kmeans.centroids"))).astype(np.float32)


def emit_partials(ctx, sums, counts):
    for j in range(len(counts)):
        if counts[j]:
            ctx.emit(str(j), " ".join([str(int(counts[j]))]
                                      + [repr(float(v)) for v in sums[j]]))


def count_ms(ctx, role, t_map, t_read):
    """Milliseconds from the process's start to its map, reading the split
    and the rest of the map, summed per role in the job's counters."""
    now = time.monotonic()
    for name, ms in (("START", t_map - T0), ("READ", t_read - t_map),
                     ("COMPUTE", now - t_read)):
        ctx.increment_counter(ctx.get_counter(
            "KMeansPipes", f"{{role}}_{{name}}_MS"), int(ms * 1000))
'''

#: the CPU executable: numpy assignment and float64 partial sums for a map;
#: for the reduce, each cluster's partials folded into its new centroid
PIPES_CPU_EXE = PIPES_COMMON + '''

class CpuMapper(child.Mapper):
    def __init__(self, ctx):
        self.maps = ctx.get_counter("KMeansPipes", "CPU_MAPS")

    def map(self, ctx):
        t_map = time.monotonic()
        x, c = split_rows(ctx), centroids(ctx)
        t_read = time.monotonic()
        k, d = c.shape
        c2 = np.einsum("kd,kd->k", c, c)
        sums, counts = np.zeros((k, d)), np.zeros(k, np.int64)
        for lo in range(0, x.shape[0], 1 << 16):
            b = x[lo:lo + (1 << 16)]
            a = np.argmin(c2[None, :] - 2.0 * (b @ c.T), axis=1)
            counts += np.bincount(a, minlength=k)
            for j in range(d):
                sums[:, j] += np.bincount(a, weights=b[:, j], minlength=k)
        emit_partials(ctx, sums, counts)
        ctx.increment_counter(self.maps, 1)
        count_ms(ctx, "CPU", t_map, t_read)


class CentroidFold(child.Reducer):
    def reduce(self, ctx):
        total, n = 0.0, 0
        while ctx.next_value():
            f = ctx.input_value.split()
            n += int(f[0])
            total = total + np.array([float(t) for t in f[1:]])
        ctx.emit(ctx.input_key, " ".join(repr(float(t)) for t in total / n))


class Factory(child.Factory):
    def create_mapper(self, ctx):
        return CpuMapper(ctx)

    def create_reducer(self, ctx):
        return CentroidFold()


raise SystemExit(child.run_task(Factory()))
'''

#: the GPU executable: binds the card argv[1] names (the reference's
#: cudaSetDevice(argv[1])) and launches kmeans_assign_partials through
#: tpumr_torch.ops.kmeans.assign_and_partials from the library this process
#: built (it exits rather than build it again); counts its launches and the
#: argv[1] it was given in pipes counters. With kmeans.pipes.hold.mb in
#: the job's conf it only holds that much card memory until killed.
PIPES_GPU_EXE = PIPES_COMMON + '''
import torch

from tpumr_torch.ops import kmeans as km
from tpumr_torch.ops import native

DEVICE = torch.device("cuda", int(sys.argv[1]))
torch.cuda.set_device(DEVICE)
if native.stale():   # the parent built the library: never build it here
    raise SystemExit("the kernel library is stale: not rebuilding it here")


class GpuMapper(child.Mapper):
    def __init__(self, ctx):
        self.launches = ctx.get_counter("KMeansPipes", "GPU_LAUNCHES")
        self.bound = ctx.get_counter("KMeansPipes", "ARGV1_" + sys.argv[1])

    def map(self, ctx):
        hold_mb = ctx.get_job_conf().get_int("kmeans.pipes.hold.mb", 0)
        if hold_mb:
            held = torch.ones(hold_mb << 18, device=DEVICE)
            torch.cuda.synchronize(DEVICE)
            ctx.set_status(f"holding {{held.numel() * 4 >> 20}} MB")
            time.sleep(600)
        t_map = time.monotonic()
        x = torch.from_numpy(split_rows(ctx)).to(DEVICE)
        c = torch.from_numpy(centroids(ctx)).to(DEVICE)
        torch.cuda.synchronize(DEVICE)
        t_read = time.monotonic()
        before = km.kmeans_assign_partials.launches
        _ids, sums, counts = km.assign_and_partials(x, c)
        emit_partials(ctx, sums.cpu().numpy(), counts.cpu().numpy())
        ctx.increment_counter(self.launches,
                              km.kmeans_assign_partials.launches - before)
        ctx.increment_counter(self.bound, 1)
        count_ms(ctx, "GPU", t_map, t_read)


class Factory(child.Factory):
    def create_mapper(self, ctx):
        return GpuMapper(ctx)


raise SystemExit(child.run_task(Factory()))
'''


def write_pipes_exes(work: str) -> tuple:
    """The two executables in ``work``: (CPU path, GPU path)."""
    paths = []
    for role, text in (("cpu", PIPES_CPU_EXE), ("gpu", PIPES_GPU_EXE)):
        path = os.path.join(work, f"kmeans-pipes-{role}.py")
        with open(path, "w") as f:
            f.write(text.format(python=sys.executable, repo=_repo(),
                                role=role.upper()))
        os.chmod(path, 0o755)
        paths.append(path)
    return tuple(paths)


def text_parts(path: str) -> dict:
    """key -> value over a text output's part files."""
    out = {}
    for line in read_text_parts(path):
        k, v = line.split("\t")
        out[k] = v
    return out


def pipes_cpp(work: str) -> dict:
    """pipes_isolation (a), host work in processes of its own: native/pipes
    built into tpumr_torch/build/pipes (native/ untouched); ``python -m
    tpumr_torch.cli pipes -program wordcount`` in a process; then
    wordcount-part, sort and wordcount-nopipe through Submitter.run_job.
    Each result against tests/test_pipes.py's counts for its input."""
    from tpumr_torch.mapred.jobconf import JobConf
    from tpumr_torch.pipes import Submitter
    t0 = time.monotonic()
    build = os.path.join(_repo(), "tpumr_torch", "build", "pipes")
    proc = subprocess.run(["make", "-C", os.path.join(_repo(), "native",
                                                      "pipes"),
                           f"BUILD={build}"], capture_output=True, text=True,
                          timeout=300)
    check(proc.returncode == 0, f"pipes_isolation (a): make failed "
          f"{proc.stderr[-2000:]}")
    build_s = time.monotonic() - t0
    d = os.path.join(work, "cpp")
    os.makedirs(d, exist_ok=True)
    inputs = {"wc": b"tpu mxu tpu\nici mxu tpu\n" * 10,
              "part": b"apple crumble apple\nbanana crumble\n" * 5,
              "sort": ("\n".join(f"k{97 - i:03d}" for i in range(60))
                       + "\n").encode(),
              "nopipe": b"red green red\nblue green\n" * 40}
    for name, data in inputs.items():
        with open(os.path.join(d, f"{name}.txt"), "wb") as f:
            f.write(data)
    t = time.monotonic()
    cli = subprocess.Popen(
        [sys.executable, "-m", "tpumr_torch.cli", "pipes", "-program",
         os.path.join(build, "wordcount"), "-input", f"file://{d}/wc.txt",
         "-output", f"file://{d}/wc-out", "-reduces", "1", "-jobconf",
         f"tpumr.cache.dir={d}/cache-cli"], cwd=_repo(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        secs = {}
        for name, exe, reduces, keys in (
                ("part", "wordcount-part", 2, {}),
                ("sort", "sort", 1, {}),
                ("nopipe", "wordcount-nopipe", 1, {
                    "mapred.map.tasks": 3, "mapred.min.split.size": 1,
                    "tpumr.pipes.piped.input": False})):
            conf = JobConf()
            conf.set_input_paths(f"file://{d}/{name}.txt")
            conf.set_output_path(f"file://{d}/{name}-out")
            conf.set_num_reduce_tasks(reduces)
            conf.set("tpumr.cache.dir", f"{d}/cache")
            for k, v in keys.items():
                conf.set(k, v)
            Submitter.set_executable(conf, os.path.join(build, exe))
            ts = time.monotonic()
            check(Submitter.run_job(conf).successful,
                  f"pipes_isolation (a): {exe} failed")
            secs[exe] = time.monotonic() - ts
        _out, err = cli.communicate(timeout=300)
    finally:
        if cli.poll() is None:
            cli.kill()
            cli.communicate()
    secs["cli_wordcount"] = time.monotonic() - t
    check(cli.returncode == 0, f"pipes_isolation (a): the pipes command "
          f"exited {cli.returncode}: {err[-2000:]}")
    check(text_parts(f"{d}/wc-out") == {"tpu": "30", "mxu": "20",
                                          "ici": "10"},
          f"pipes_isolation (a): wordcount {text_parts(f'{d}/wc-out')}")
    by_part = {}
    for name in sorted(os.listdir(f"{d}/part-out")):
        if name.startswith("part-"):
            with open(os.path.join(d, "part-out", name)) as f:
                for line in f.read().splitlines():
                    k, v = line.split("\t")
                    by_part[k] = (int(name.rsplit("-", 1)[1]), v)
    check({k: v for k, (_p, v) in by_part.items()}
          == {"apple": "10", "banana": "5", "crumble": "10"}
          and all(p == ord(k[0]) % 2 for k, (p, _v) in by_part.items()),
          f"pipes_isolation (a): wordcount-part {by_part}")
    keys = [line.split("\t")[0] for line in read_text_parts(f"{d}/sort-out")]
    check(keys == sorted(f"k{97 - i:03d}" for i in range(60)),
          f"pipes_isolation (a): sort gave {keys[:5]}...")
    check(text_parts(f"{d}/nopipe-out") == {"red": "80", "green": "80",
                                              "blue": "40"},
          f"pipes_isolation (a): wordcount-nopipe "
          f"{text_parts(f'{d}/nopipe-out')}")
    return {"seconds": time.monotonic() - t0, "make_s": build_s,
            "jobs_s": secs}


def card_free_bytes() -> int:
    torch.cuda.synchronize()
    return int(torch.cuda.mem_get_info()[0])


class HeldCard:
    """A GPU pipes child that holds PIPES_HOLD_MB of the card until it is
    SIGKILLed: started at once (its start, torch's import and its CUDA
    context, runs beside the caller's work), killed by :meth:`kill_check`,
    after which the card's free memory must grow by what it held within
    PIPES_FREE_S seconds. :meth:`close` kills it wherever the caller
    failed first."""

    def __init__(self, gpu_exe: str) -> None:
        from tpumr_torch.mapred.api import OutputCollector, Reporter
        from tpumr_torch.mapred.jobconf import JobConf
        from tpumr_torch.pipes.application import Application
        from tpumr_torch.pipes.runner import _UplinkCollector
        self.t0 = time.monotonic()
        conf = JobConf()
        conf.set("kmeans.pipes.hold.mb", PIPES_HOLD_MB)
        self.reporter = Reporter()
        self.app = Application(
            conf, gpu_exe, _UplinkCollector(OutputCollector(lambda k, v:
                                                            None)),
            self.reporter, run_on_tpu=True, device_ordinal=0)
        self.app.downlink.start()
        self.app.downlink.set_job_conf({"kmeans.pipes.hold.mb":
                                        PIPES_HOLD_MB})
        self.app.downlink.run_map(b"{}", 0, piped_input=False)
        self.app.downlink.flush()

    def kill_check(self) -> dict:
        app = self.app
        deadline = time.monotonic() + 120
        while not self.reporter.status.startswith("holding"):
            check(time.monotonic() < deadline and app.process.poll() is None,
                  f"pipes_isolation: the holding child never held "
                  f"(rc {app.process.poll()}, {app.child_error})")
            time.sleep(0.05)
        held_s = time.monotonic() - self.t0
        before = card_free_bytes()
        t = time.monotonic()
        app.abort()                     # SIGKILL, then reaped
        rc = app.process.returncode
        free = card_free_bytes()
        while free - before < (PIPES_HOLD_MB << 20) and \
                time.monotonic() - t < PIPES_FREE_S:
            time.sleep(0.05)
            free = card_free_bytes()
        row = {"status": self.reporter.status, "held_after_s": held_s,
               "free_before_kill_gb": before / 1e9,
               "free_after_kill_gb": free / 1e9,
               "freed_gb": (free - before) / 1e9,
               "back_s": time.monotonic() - t, "rc": rc}
        log("pipes_kill " + json.dumps(row))
        check(rc == -signal.SIGKILL, f"pipes_isolation: the held child "
              f"exited {rc}, not by SIGKILL")
        check(free - before >= (PIPES_HOLD_MB << 20), f"pipes_isolation: "
              f"{(free - before) / 1e9:.3f} GB of the card came back "
              f"{PIPES_FREE_S} s after the kill, not the "
              f"{PIPES_HOLD_MB} MB the child held")
        return row

    def close(self) -> None:
        self.app.cleanup(kill=True)


def pipes_kmeans(c, work: str, exes: tuple, ref: np.ndarray, km) -> dict:
    """pipes_isolation (b), the reference's hybrid path: one K-Means round
    over the hybrid points (8 splits) as a pipes job on the hybrid cluster,
    a CPU and a GPU executable, non-piped input. Gates: the centroids
    against the hybrid phase's float64 Lloyd step, both pools used, every
    GPU attempt given argv[1] "0", the GPU launch counter equal to the GPU
    maps and >= 1, every map and the reduce on attempt 0, no demotion, and
    no launch in this process. The card's free memory before and after is
    printed (other processes use the card meanwhile: no gate)."""
    from tpumr_torch.core.counters import JobCounter
    from tpumr_torch.mapred.input_formats import DenseInputFormat
    from tpumr_torch.mapred.job_client import JobClient
    from tpumr_torch.pipes import Submitter
    from tpumr_torch.pipes.submitter import setup_pipes_job
    conf = c.create_job_conf()
    conf.set_job_name("pipes-kmeans")
    conf.set_input_paths(f"file://{work}/pipes-points.npy")
    conf.set_output_path(f"file://{work}/pipes-km")
    conf.set_input_format(DenseInputFormat)
    conf.set("tpumr.dense.split.rows", HYB_ROWS)
    conf.set("tpumr.kmeans.centroids", f"file://{work}/cents.npy")
    conf.set("tpumr.pipes.piped.input", False)
    conf.set_num_reduce_tasks(1)
    Submitter.set_executable(conf, exes[0])
    Submitter.set_tpu_executable(conf, exes[1])
    setup_pipes_job(conf)
    free0 = card_free_bytes()
    zero_launch_counts(km)
    client = JobClient(conf)
    try:
        t = time.monotonic()
        running = client.submit_job(conf)
        st = running.wait_for_completion(timeout=HYB_JOB_TIMEOUT_S)
        secs = time.monotonic() - t
        counters = running.counters()
        reports = running.task_reports("map")
        reduces = running.task_reports("reduce")
    finally:
        client.close()
    check(st["state"] == "SUCCEEDED", f"pipes_isolation (b): {st['state']} "
          f"{st.get('error', '')}")
    free = card_free_bytes()
    seq = "".join("T" if r["run_on_tpu"] else "c" for r in sorted(
        reports, key=lambda r: r["start_time"]))
    pipes = counters.to_dict().get("KMeansPipes", {})
    jip = c.master.jobs[running.job_id]
    row = {"job_s": secs, "placement": seq,
           "finished_tpu_maps": st["finished_tpu_maps"],
           "finished_cpu_maps": st["finished_cpu_maps"], "counters": pipes,
           "parent_launches": launch_counts(km),
           "TPU_DEMOTIONS": jip.counters.value(JobCounter.GROUP,
                                               JobCounter.TPU_DEMOTIONS),
           "free_before_gb": free0 / 1e9, "free_after_gb": free / 1e9}
    got = {int(k): np.array(v.split(), np.float64)
           for k, v in text_parts(f"{work}/pipes-km").items()}
    check(sorted(got) == list(range(K)), f"pipes_isolation (b): clusters "
          f"{sorted(got)}")
    got = np.stack([got[i] for i in range(K)])
    err = np.abs(got - ref)
    row["max_abs_err"] = float(err.max())
    log("pipes_kmeans " + json.dumps(row))
    check(bool(np.all(err <= CENTROID_ATOL + CENTROID_RTOL * np.abs(ref))),
          f"pipes_isolation (b): centroids off the float64 Lloyd step by up "
          f"to {err.max():.3g}")
    check("T" in seq and "c" in seq, f"pipes_isolation (b): placement {seq}")
    n_gpu = st["finished_tpu_maps"]
    check(pipes.get("GPU_LAUNCHES", 0) == n_gpu >= 1
          and pipes.get("ARGV1_0", 0) == n_gpu
          and not [k for k in pipes if k.startswith("ARGV1_")
                   and k != "ARGV1_0"]
          and pipes.get("CPU_MAPS", 0) == st["finished_cpu_maps"],
          f"pipes_isolation (b): counters {pipes} for {n_gpu} GPU maps")
    check(row["parent_launches"] == {"kmeans_assign_partials": 0,
                                     "kmeans_assign": 0},
          f"pipes_isolation (b): this process launched {launch_counts(km)}")
    retried = [r["task_id"] for r in reports + reduces
               if not r["successful_attempt"].endswith("_0")]
    check(not retried and row["TPU_DEMOTIONS"] == 0,
          f"pipes_isolation (b): retried {retried}, "
          f"{row['TPU_DEMOTIONS']} demotions")
    row["gpu_launches"] = n_gpu
    return row


def driver_files(pid: int) -> "list[str]":
    """The ``/dev/nvidia*`` files process ``pid`` holds open: none after
    ``import torch``, some after its first torch.cuda call, which
    initialises the driver (:class:`DriverControls` holds both in every
    run)."""
    out = []
    try:
        for fd in os.listdir(f"/proc/{pid}/fd"):
            try:
                target = os.readlink(f"/proc/{pid}/fd/{fd}")
            except OSError:
                continue
            if target.startswith("/dev/nvidia"):
                out.append(target)
    except OSError:
        pass
    return sorted(set(out))


class DriverControls:
    """The two controls of :func:`driver_files`, processes started at once
    beside the caller's work: one that imports torch, whose driver files
    must be none (an isolated CPU child imports torch too), and one that
    then calls torch.cuda.is_available(), whose must not be."""

    CODE = {"import_torch": "import torch",
            "torch_cuda_call": "import torch; torch.cuda.is_available()"}

    def __init__(self) -> None:
        self.procs = {
            label: subprocess.Popen(
                [sys.executable, "-c", code + "\nimport sys, time\n"
                 "print('ready', flush=True)\nsys.stdin.read()"],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
            for label, code in self.CODE.items()}

    def read(self) -> dict:
        out = {}
        try:
            for label, proc in self.procs.items():
                check(proc.stdout.readline().strip() == "ready",
                      f"pipes_isolation (c): control {label} exited "
                      f"{proc.poll()}")
                out[label] = driver_files(proc.pid)
        finally:
            for proc in self.procs.values():
                proc.kill()
                proc.communicate()
        return out


class ComputeApps:
    """Samples the node runner's task children every PIPES_SAMPLE_S until
    stopped: which of them opened the CUDA driver (:func:`driver_files`),
    and ``nvidia-smi --query-compute-apps=pid``, whose pids need not be
    this sandbox's."""

    def __init__(self, tracker) -> None:
        self.tracker = tracker
        self.apps: set = set()
        self.children: set = set()
        #: children holding the CUDA driver's device files open (what
        #: torch.cuda's first call does; importing torch does not)
        self.driver_children: set = set()
        self.samples = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="compute-apps")

    def _run(self) -> None:
        while not self._stop.is_set():
            pids = set(self.tracker.metrics()["task_children"].values())
            self.children |= pids
            for pid in pids:
                if driver_files(pid):
                    self.driver_children.add(pid)
            out = subprocess.run(
                ["nvidia-smi", "--query-compute-apps=pid",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=30).stdout
            self.apps |= {int(p) for p in out.split() if p.isdigit()}
            self.samples += 1
            self._stop.wait(PIPES_SAMPLE_S)

    def __enter__(self) -> "ComputeApps":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(60)


def isolation_pair(c, work: str, km) -> dict:
    """pipes_isolation (c): the hybrid K-Means job over the first
    ACCEL_SPLITS splits (accel_fault's points4.npy), in the runner's
    threads and then with tpumr.task.isolation=process: the CPU maps and
    the reduce in children, the GPU map in the runner (>= 1 fused launch).
    Gates: byte-identical parts, and no child pid among the card's compute
    apps while the isolated job runs."""
    from tpumr_torch.mapred.input_formats import DenseInputFormat
    from tpumr_torch.mapred.job_client import JobClient
    controls = DriverControls()
    rows = {}
    try:
        for mode in ("thread", "process"):
            conf = c.create_job_conf()
            conf.set_job_name(f"iso-{mode}")
            conf.set_input_paths(f"file://{work}/points4.npy")
            conf.set_output_path(f"file://{work}/iso-{mode}")
            conf.set_input_format(DenseInputFormat)
            conf.set("tpumr.dense.split.rows", HYB_ROWS)
            conf.set("tpumr.kmeans.centroids", f"file://{work}/cents.npy")
            conf.set_map_kernel("kmeans-assign")
            conf.set("mapred.reducer.class",
                     "tpumr_torch.ops.kmeans.CentroidReducer")
            conf.set_num_reduce_tasks(1)
            conf.set("tpumr.task.isolation", mode)
            km.clear_centroid_cache()
            zero_launch_counts(km)
            client = JobClient(conf)
            sampler = ComputeApps(c.trackers[0])
            try:
                t = time.monotonic()
                with sampler:
                    running = client.submit_job(conf)
                    st = running.wait_for_completion(timeout=HYB_JOB_TIMEOUT_S)
                secs = time.monotonic() - t
                reports = running.task_reports("map")
            finally:
                client.close()
            check(st["state"] == "SUCCEEDED", f"pipes_isolation (c) {mode}: "
                  f"{st['state']} {st.get('error', '')}")
            with open(os.path.join(work, f"iso-{mode}", "part-00000"),
                      "rb") as f:
                part = f.read()
            rows[mode] = {
                "job_s": secs,
                "gpu_maps": sorted(r["task_id"].rsplit("_", 1)[1]
                                   for r in reports if r["run_on_tpu"]),
                "placement": "".join(
                    "T" if r["run_on_tpu"] else "c" for r in sorted(
                        reports, key=lambda r: r["start_time"])),
                "launches": launch_counts(km),
                "finished_tpu_maps": st["finished_tpu_maps"],
                "children": sorted(sampler.children),
                "children_on_card": sorted(sampler.children & sampler.apps),
                "children_with_driver": sorted(sampler.driver_children),
                "compute_apps": sorted(sampler.apps),
                "self_on_card": os.getpid() in sampler.apps,
                "self_driver_files": driver_files(os.getpid()),
                "map_s": sorted(r["finish_time"] - r["start_time"]
                                for r in reports),
                "samples": sampler.samples, "part": part}
    finally:
        ctl = controls.read()
    thread, proc = rows["thread"], rows["process"]
    identical = thread["part"] == proc["part"]
    for row in rows.values():
        row["part_bytes"] = len(row.pop("part"))
    out = {"thread": thread, "process": proc, "identical": identical,
           "controls": ctl}
    log("isolation_pair " + json.dumps(out))
    check(identical, "pipes_isolation (c): the isolated job's part differs "
          "from the threaded job's")
    check(thread["gpu_maps"] == proc["gpu_maps"] and thread["children"] == [],
          f"pipes_isolation (c): GPU maps {thread['gpu_maps']} and "
          f"{proc['gpu_maps']}, threaded children {thread['children']}")
    n_cpu = ACCEL_SPLITS - proc["finished_tpu_maps"]
    check(n_cpu >= 1 and len(proc["children"]) >= n_cpu,
          f"pipes_isolation (c): {len(proc['children'])} children seen for "
          f"{n_cpu} CPU maps")
    check(proc["launches"]["kmeans_assign_partials"]
          == proc["finished_tpu_maps"] >= 1,
          f"pipes_isolation (c): {proc['launches']} launches for "
          f"{proc['finished_tpu_maps']} GPU maps in the runner")
    check(ctl["import_torch"] == [] and ctl["torch_cuda_call"] != [],
          f"pipes_isolation (c): the driver-file signal is not calibrated: "
          f"{ctl}")
    check(proc["self_driver_files"] != [] and proc["children_on_card"] == []
          and proc["children_with_driver"] == [], f"pipes_isolation (c): "
          f"children {proc['children_with_driver']} opened the CUDA driver, "
          f"{proc['children_on_card']} among the compute apps (this "
          f"process holds {proc['self_driver_files']})")
    return out


class PipesLater:
    """pipes_isolation (b) and (c) on the hybrid phase's cluster, which
    stays up past the hybrid phase so that they run beside the pipeline
    phase's TeraSort chain (host work, no K-Means launch in this process),
    then master_state (a): :meth:`run`, a Beside's function there,
    runs them, shuts the cluster down and prints the pipes phase's line; :meth:`close` shuts it down and
    removes the hybrid work directory (which keeps the points under
    ``pipes-points.npy``, points4.npy and cents.npy) wherever that did not
    happen yet."""

    def __init__(self, cluster, work: str) -> None:
        self.cluster, self.work = cluster, work
        self.closed = False
        self._lock = threading.Lock()

    def ready(self, exes: tuple, ref: np.ndarray, km, kill: dict,
              cpp: dict) -> None:
        self.exes, self.ref, self.km, self.kill, self.cpp = \
            exes, ref, km, kill, cpp

    def run(self) -> dict:
        try:
            t = time.monotonic()
            pipes = pipes_kmeans(self.cluster, self.work, self.exes,
                                 self.ref, self.km)
            b_s = time.monotonic() - t
            t = time.monotonic()
            iso = isolation_pair(self.cluster, self.work, self.km)
            c_s = time.monotonic() - t
            # master_state (a), whose restart replaces the cluster's master
            t = time.monotonic()
            restart = master_state_restart(self.cluster, self.work,
                                           self.ref, self.km)
            restart_s = time.monotonic() - t
        finally:
            self.shutdown()
        launches = pipes["gpu_launches"] + sum(
            iso[m]["launches"]["kmeans_assign_partials"]
            for m in ("thread", "process"))
        log("pipes_isolation_phase " + json.dumps({
            "seconds": self.cpp["seconds"] + b_s + c_s,
            "a_s": self.cpp["seconds"], "a_make_s": self.cpp["make_s"],
            "a_jobs_s": self.cpp["jobs_s"], "kill_check": self.kill,
            "b_s": b_s, "c_s": c_s,
            "c_thread_job_s": iso["thread"]["job_s"],
            "c_process_job_s": iso["process"]["job_s"],
            "placement": pipes["placement"],
            "gpu_child_launches": pipes["gpu_launches"],
            "isolation_launches": launches - pipes["gpu_launches"],
            "isolated_children": len(iso["process"]["children"]),
            "children_with_driver":
                len(iso["process"]["children_with_driver"]),
            "children_on_card": len(iso["process"]["children_on_card"]),
            "free_before_b_gb": pipes["free_before_gb"],
            "free_after_b_gb": pipes["free_after_gb"]}))
        return {"b_s": b_s, "c_s": c_s, "launches": launches,
                "master_state": {"a_s": restart_s, "a": restart}}

    def shutdown(self) -> None:
        """Stop the cluster once; its runner's threads must all end."""
        with self._lock:
            if self.closed:
                return
            self.closed = True
        c = self.cluster
        c.shutdown()
        check(not any(t._hb_thread.is_alive() or t._reaper_thread.is_alive()
                      or t.metrics()["task_threads"] for t in c.trackers),
              "the hybrid cluster left threads running")

    def close(self) -> None:
        try:
            self.shutdown()
        finally:
            shutil.rmtree(self.work, ignore_errors=True)


def poll_status(running, timeout_s: float = HYB_JOB_TIMEOUT_S) -> dict:
    """A job's or a pipeline's status, polled through a master restart:
    a poll that fails while the master is away is tried again."""
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            return running.status()
        except Exception:  # noqa: BLE001 — the master is restarting
            check(time.monotonic() < deadline,
                  "the master never answered a status poll")
            time.sleep(0.05)


def wait_terminal(running, timeout_s: float = HYB_JOB_TIMEOUT_S) -> dict:
    deadline = time.monotonic() + timeout_s
    while True:
        st = poll_status(running, timeout_s)
        if st["state"] in ("SUCCEEDED", "FAILED", "KILLED"):
            return st
        check(time.monotonic() < deadline, f"never ended: {st}")
        time.sleep(0.02)


def restart_master(c):
    """tests/test_master_restart.py::_kill_and_restart_master: the
    cluster's master stopped with nothing finalised, and a new one with
    the cluster's conf (history, recovery on) on the same address."""
    from tpumr_torch.mapred.jobtracker import JobMaster
    host, port = c.master.address
    c.master.stop()
    for _ in range(200):
        try:
            c.master = JobMaster(c.conf, host=host, port=port).start()
            return c.master
        except OSError:
            time.sleep(0.05)
    fail("could not bind the master's port again")


def master_state_speculation(c, work: str, cents: np.ndarray, km) -> dict:
    """master_state (c), targeted speculation, on the hybrid cluster after
    accel_fault and the pipes kill check, in line: one
    K-Means round over the hybrid points' first MS_SPEC_SPLITS x
    MS_SPEC_ROWS rows (one CPU wave for the maps the straggler leaves,
    then one for its twin) with map 0 a task.slow straggler for MS_SLOW_MS
    ms, speculation on (the cluster turns it off for the other phases),
    mapred.speculative.min.runtime.s MS_SPEC_FLOOR_S and optional
    scheduling off (it would give the job no CPU slot once no map is
    pending). Gates: the seam fired once; only map 0 twinned (its
    next_attempt 2, the others' 1); one twin launched and won, none wasted
    or in flight; the job under MS_SLOW_MS; kmeans_assign_partials once a
    successful GPU map; the centroids against a float64 Lloyd step."""
    from tpumr_torch.mapred.input_formats import DenseInputFormat
    from tpumr_torch.mapred.job_client import JobClient
    from tpumr_torch.utils import fi
    n = MS_SPEC_SPLITS * MS_SPEC_ROWS
    spec = os.path.join(work, "spec")
    os.makedirs(spec, exist_ok=True)
    src = np.load(os.path.join(work, "points.npy"), mmap_mode="r")
    np.save(os.path.join(spec, "points.npy"), np.ascontiguousarray(src[:n]))
    del src
    ref = oracle(spec, n, cents, km, compare=False)["centroids"]
    conf = c.create_job_conf()
    conf.set_job_name("master-state-speculation")
    conf.set_input_paths(f"file://{spec}/points.npy")
    conf.set_output_path(f"file://{spec}/out")
    conf.set_input_format(DenseInputFormat)
    conf.set("tpumr.dense.split.rows", MS_SPEC_ROWS)
    conf.set("tpumr.kmeans.centroids", f"file://{work}/cents.npy")
    conf.set_map_kernel("kmeans-assign")
    conf.set("mapred.reducer.class", "tpumr_torch.ops.kmeans.CentroidReducer")
    conf.set_num_reduce_tasks(1)
    conf.set("mapred.jobtracker.map.optionalscheduling", False)
    conf.set("mapred.speculative.execution", True)
    conf.set("mapred.speculative.min.runtime.s", MS_SPEC_FLOOR_S)
    conf.set("tpumr.fi.task.slow.m0.probability", 1.0)
    conf.set("tpumr.fi.task.slow.m0.max.failures", 1)
    conf.set("tpumr.fi.task.slow.ms", MS_SLOW_MS)
    fired = fi.fired("task.slow.m0")
    km.clear_centroid_cache()
    zero_launch_counts(km)
    client = JobClient(conf)
    try:
        t = time.monotonic()
        running = client.submit_job(conf)
        st = running.wait_for_completion(timeout=HYB_JOB_TIMEOUT_S)
        secs = time.monotonic() - t
    finally:
        client.close()
    launches = launch_counts(km)
    check(st["state"] == "SUCCEEDED", f"master_state (c): {st}")
    jip = c.master.jobs[running.job_id]
    with jip.lock:
        twin = [(aid, s.run_on_tpu) for aid, s in jip.maps[0].attempts.items()
                if aid.endswith("_1")]
        nexts = [t.next_attempt for t in jip.maps]
        winner = jip.maps[0].successful_attempt
    got = read_centroids(os.path.join(spec, "out", "part-00000"))
    check(sorted(got) == list(range(K)), f"master_state (c): clusters "
          f"{sorted(got)}")
    err = np.abs(np.stack([got[i] for i in range(K)]) - ref)
    row = {"job_s": secs, "placement": st["placement_seq"],
           "twin": twin[0][0] if twin else "",
           "twin_on": ("gpu" if twin[0][1] else "cpu") if twin else "",
           "winner": winner, "next_attempts": nexts,
           "speculative": {k: st[f"speculative_{k}"] for k in
                           ("launched", "won", "wasted", "in_flight")},
           "slow_fired": fi.fired("task.slow.m0") - fired,
           "gpu_maps": st["finished_tpu_maps"], "launches": launches,
           "max_abs_err": float(err.max())}
    log("master_state_speculation " + json.dumps(row))
    check(row["slow_fired"] == 1, f"master_state (c): task.slow.m0 fired "
          f"{row['slow_fired']} times")
    check(nexts == [2] + [1] * (len(nexts) - 1),
          f"master_state (c): next attempts {nexts}, only map 0 twinned")
    check(row["speculative"] == {"launched": 1, "won": 1, "wasted": 0,
                                 "in_flight": 0},
          f"master_state (c): speculation {row['speculative']}")
    check(winner == row["twin"], f"master_state (c): map 0 won by {winner}")
    check(secs < MS_SLOW_MS / 1000.0,
          f"master_state (c): {secs:.2f} s, not under the straggler's "
          f"{MS_SLOW_MS / 1000.0:.0f} s")
    check(launches == {"kmeans_assign_partials": st["finished_tpu_maps"],
                       "kmeans_assign": 0},
          f"master_state (c): launches {launches} for "
          f"{st['finished_tpu_maps']} GPU maps")
    check(bool(np.all(err <= CENTROID_ATOL + CENTROID_RTOL * np.abs(ref))),
          f"master_state (c): centroids off the float64 oracle by up to "
          f"{err.max():.3g}")
    return row


def master_state_restart(c, work: str, ref: np.ndarray, km) -> dict:
    """master_state (a), a master restart on the hybrid cluster (whose
    master writes history and recovers at start, grace MS_GRACE_MS): the
    hybrid K-Means job over the hybrid points (8 splits, slow start 1.0);
    once every map launched and MS_FOLDED folded, the master is stopped
    with nothing finalised and a new one started on its address
    (:func:`restart_master`). Gates: the job SUCCEEDED under its new id,
    which the polling client followed; jobs_recovered 1, attempts_recovered
    at least the maps folded before the stop, trackers_adopted >= 1; the
    restarted master launched no map; kmeans_assign_partials once a GPU
    map of the job (no recovered map ran again on the card); the centroids
    against the hybrid phase's float64 Lloyd step."""
    from tpumr_torch.mapred.input_formats import DenseInputFormat
    from tpumr_torch.mapred.job_client import JobClient
    conf = c.create_job_conf()
    conf.set_job_name("master-state-restart")
    conf.set_input_paths(f"file://{work}/pipes-points.npy")
    conf.set_output_path(f"file://{work}/out-ms-restart")
    conf.set_input_format(DenseInputFormat)
    conf.set("tpumr.dense.split.rows", HYB_ROWS)
    conf.set("tpumr.kmeans.centroids", f"file://{work}/cents.npy")
    conf.set_map_kernel("kmeans-assign")
    conf.set("mapred.reducer.class", "tpumr_torch.ops.kmeans.CentroidReducer")
    conf.set_num_reduce_tasks(1)
    conf.set("mapred.reduce.slowstart.completed.maps", 1.0)
    km.clear_centroid_cache()
    zero_launch_counts(km)
    client = JobClient(conf)
    try:
        t0 = time.monotonic()
        running = client.submit_job(conf)
        old_id = running.job_id
        jip = c.master.jobs[old_id]
        deadline = time.monotonic() + HYB_JOB_TIMEOUT_S
        while not (jip.pending_map_count() == 0
                   and jip.finished_maps >= MS_FOLDED):
            check(jip.state == "RUNNING" and time.monotonic() < deadline,
                  f"master_state (a): {jip.state} before the stop")
            time.sleep(0.005)
        folded = jip.finished_maps
        before_seq = jip.placement_timeline()["seq"]
        wall_stop = time.time()
        t_stop = time.monotonic()
        m2 = restart_master(c)
        restart_s = time.monotonic() - t_stop
        st = wait_terminal(running)
        stop_to_done = time.monotonic() - t_stop
        secs = time.monotonic() - t0
    finally:
        client.close()
    launches = launch_counts(km)
    check(st["state"] == "SUCCEEDED", f"master_state (a): {st}")
    new_id = running.job_id
    metrics = m2.get_metrics()
    jip2 = m2.jobs[new_id]
    with jip2.lock:
        attempts = sorted(t.successful_attempt for t in jip2.maps)
        # where the seconds after the stop went: the maps that were still
        # running, then the reduce (wall stamps of the runner's statuses)
        maps_done = max(t.report.finish_time for t in jip2.maps) - wall_stop
        reduce_start = jip2.reduces[0].report.start_time - wall_stop
    # the recovered GPU maps and those that ended after the restart
    gpu_maps = st["finished_tpu_maps"]
    got = read_centroids(os.path.join(work, "out-ms-restart", "part-00000"))
    check(sorted(got) == list(range(K)), f"master_state (a): clusters "
          f"{sorted(got)}")
    err = np.abs(np.stack([got[i] for i in range(K)]) - ref)
    row = {"job_s": secs, "stop_to_succeeded_s": stop_to_done,
           "restart_s": restart_s, "maps_done_after_stop_s": maps_done,
           "reduce_start_after_stop_s": reduce_start,
           "folded_before_stop": folded,
           "placement_before_stop": before_seq, "old_id": old_id,
           "new_id": new_id, "gpu_maps": gpu_maps,
           "cpu_maps": st["finished_cpu_maps"],
           "map_attempts": attempts, "launches": launches,
           "metrics": {k: metrics[k] for k in (
               "jobs_recovered", "attempts_recovered", "attempts_adopted",
               "trackers_adopted", "maps_launched_cpu", "maps_launched_tpu",
               "reduces_launched")},
           "max_abs_err": float(err.max())}
    log("master_state_restart " + json.dumps(row))
    check(new_id != old_id and m2.get_recovered_jobs().get(old_id) == new_id,
          f"master_state (a): the client polls {new_id}, the master "
          f"recovered {m2.get_recovered_jobs()}")
    check(metrics["jobs_recovered"] == 1
          and metrics["attempts_recovered"] >= folded
          and metrics["trackers_adopted"] >= 1,
          f"master_state (a): {row['metrics']} ({folded} folded)")
    check(metrics["maps_launched_cpu"] + metrics["maps_launched_tpu"] == 0,
          f"master_state (a): the restarted master launched maps: "
          f"{row['metrics']}")
    check(launches == {"kmeans_assign_partials": gpu_maps,
                       "kmeans_assign": 0},
          f"master_state (a): launches {launches} for {gpu_maps} GPU maps")
    check(bool(np.all(err <= CENTROID_ATOL + CENTROID_RTOL * np.abs(ref))),
          f"master_state (a): centroids off the float64 oracle by up to "
          f"{err.max():.3g}")
    return row


def hybrid_data(work: str, n: int, mm_n: int) -> np.ndarray:
    """bench.py's hybrid data (bench.py:1187-1201), the same draws in the
    same order: default_rng(4) gives the k x d centroids, the n x d points
    in chunks of HYB_CHUNK rows, then A and B, mm_n x mm_n each."""
    rng = np.random.default_rng(HYB_SEED)
    cents = rng.standard_normal(size=(K, D), dtype=np.float32)
    np.save(os.path.join(work, "cents.npy"), cents)
    header = np.lib.format.header_data_from_array_1_0(
        np.empty((0, D), np.float32))
    header["shape"] = (n, D)
    with open(os.path.join(work, "points.npy"), "wb") as out:
        np.lib.format.write_array_header_1_0(out, header)
        for lo in range(0, n, HYB_CHUNK):
            m = min(HYB_CHUNK, n - lo)
            out.write(rng.standard_normal(size=(m, D),
                                          dtype=np.float32).tobytes())
    np.save(os.path.join(work, "a.npy"),
            rng.standard_normal(size=(mm_n, mm_n), dtype=np.float32))
    np.save(os.path.join(work, "b.npy"),
            rng.standard_normal(size=(mm_n, mm_n), dtype=np.float32))
    return cents


def hybrid_run(conf, tag: str, km) -> dict:
    """One job through the cluster's JobClient, as bench.py's
    run_and_profile: the job's seconds, its per-backend mean map seconds
    and acceleration factor from the master, its counters, the placement
    of every map in assignment order (T: the GPU slot, c: a CPU slot) and
    the all-GPU tail, the fused kernel's launches in the run, and how
    many heartbeats the acceleration factor starved the CPU slots in.
    Every map must succeed on its first attempt: a failed attempt on
    either pool fails the phase."""
    from tpumr_torch.core.counters import BackendCounter
    from tpumr_torch.mapred import gpu_runner
    from tpumr_torch.mapred.job_client import JobClient
    from tpumr_torch.ops import matmul
    km.clear_centroid_cache()            # as bench.py does per job
    matmul.clear_b_cache()
    cache = gpu_runner.split_cache(
        torch.device("cuda", 0),
        conf.get_int("tpumr.tpu.split.cache.mb", 2048) << 20)
    hits0 = cache.hits
    client = JobClient(conf)
    try:
        zero_launch_counts(km)
        t = time.monotonic()
        running = client.submit_job(conf)
        st = running.wait_for_completion(timeout=HYB_JOB_TIMEOUT_S)
        secs = time.monotonic() - t
        launches = launch_counts(km)
        counters = running.counters()
        reports = running.task_reports("map")
    finally:
        client.close()
    check(st["state"] == "SUCCEEDED", f"hybrid {tag}: {st['state']} "
          f"{st.get('error', '')}")
    seq = "".join("T" if r["run_on_tpu"] else "c" for r in sorted(
        reports, key=lambda r: r["start_time"]))
    tail = len(seq) - len(seq.rstrip("T"))
    row = {"run": tag, "job_s": secs,
           "acceleration_factor": st["acceleration_factor"],
           "cpu_map_mean_s": st["cpu_map_mean_time"],
           "gpu_map_mean_s": st["tpu_map_mean_time"],
           "TPU_MAP_TASKS": counters.value(BackendCounter.GROUP,
                                           BackendCounter.TPU_MAP_TASKS),
           "CPU_MAP_TASKS": counters.value(BackendCounter.GROUP,
                                           BackendCounter.CPU_MAP_TASKS),
           "CPU_BATCH_MAP_TASKS": counters.value(
               BackendCounter.GROUP, BackendCounter.CPU_BATCH_MAP_TASKS),
           "placement": seq, "gpu_tail": tail,
           "gpu_device_ids": sorted({r["tpu_device_id"] for r in reports
                                     if r["run_on_tpu"]}),
           "launches": launches,
           "bytes_staged": counters.value(
               BackendCounter.GROUP, BackendCounter.TPU_DEVICE_BYTES_STAGED),
           "split_cache_hits": cache.hits - hits0,
           "cpu_starved_heartbeats": st["cpu_starved_heartbeats"]}
    log("hybrid " + json.dumps(row))
    retried = [r["task_id"] for r in reports
               if not r["successful_attempt"].endswith("_0")]
    check(not retried, f"hybrid {tag}: maps {retried} succeeded only "
          "after a failed attempt")
    check(row["TPU_MAP_TASKS"] + row["CPU_MAP_TASKS"] == st["num_maps"]
          == len(seq), f"hybrid {tag}: {row['TPU_MAP_TASKS']} GPU and "
          f"{row['CPU_MAP_TASKS']} CPU maps of {st['num_maps']}")
    check(row["TPU_MAP_TASKS"] == st["finished_tpu_maps"] and
          row["CPU_MAP_TASKS"] == st["finished_cpu_maps"],
          f"hybrid {tag}: counters and the master's placement disagree")
    check(row["gpu_device_ids"] in ([], [0]),
          f"hybrid {tag}: GPU maps on devices {row['gpu_device_ids']}")
    return row


def hybrid_phase(km, n: int, keep_points: str) -> dict:
    """bench.py's hybrid phase (bench.py:1168-1308) on the port's
    MiniMRCluster: one node runner with 3 CPU map slots and 1 GPU map slot,
    optional scheduling on. K-Means over n x 16 points (16 centroids,
    splits of HYB_ROWS rows: 8 maps at the default n, one reduce) three
    times on the same cluster: kmeans_round1, kmeans_round2 (warm split
    cache) and kmeans_minimize (tpumr.scheduler.mode=minimize). Each must
    place maps on both pools, launch kmeans_assign_partials once per GPU
    map and kmeans_assign never, run every CPU map on the batch runner, and
    commit the centroids of a float64 Lloyd step. kmeans_round2's
    acceleration factor must exceed 1. Then hybrid-matmul: HYB_MM_N^2 f32 A
    and B, 4 maps, map-only, SequenceFileOutputFormat, f32 products (TF32
    off, cuBLAS on the GPU slot, numpy on the CPU slots), against a float64
    product. Then accel_fault's steps 2-3 on the same cluster, with
    pipes_isolation's held GPU child (:class:`HeldCard`) beside them and
    its kill check after, while (a) (:func:`pipes_cpp`) runs beside the
    whole phase. The points end at ``keep_points``, for the pipeline
    phase. The cluster stays up: the result's ``pipes``
    (:class:`PipesLater`) runs pipes_isolation (b) and (c) on it later, and
    its ``close`` shuts it down."""
    from tpumr_torch.io import sequencefile
    from tpumr_torch.mapred import gpu_runner
    from tpumr_torch.mapred.input_formats import DenseInputFormat
    from tpumr_torch.mapred.jobconf import JobConf
    from tpumr_torch.mapred.mini_cluster import MiniMRCluster
    from tpumr_torch.mapred.output_formats import SequenceFileOutputFormat
    from tpumr_torch.ops import devcache

    t_phase = time.monotonic()
    work = tempfile.mkdtemp(prefix="tpumr_torch-hybrid-")
    later = None
    # pipes_isolation (a), processes of their own and no card work, beside
    # the hybrid jobs
    cpp = Beside(pipes_cpp, work)
    try:
        t = time.monotonic()
        cents = hybrid_data(work, n, HYB_MM_N)
        log(f"hybrid data: {n} x {D} points and two {HYB_MM_N}^2 "
            f"matrices written in {time.monotonic() - t:.3f}s")
        gpu_runner.clear_split_caches()
        devcache.clear_device_cache()
        n_maps = -(-n // HYB_ROWS)
        base = JobConf()
        base.set("mapred.jobtracker.map.optionalscheduling", True)
        # the accel_fault steps' runner settings; no other job meets them
        base.set("tpumr.tpu.device.probe.interval.ms", ACCEL_PROBE_MS)
        base.set("tpumr.tpu.device.quarantine.failures", ACCEL_DEVICE_FAULTS)
        # accel_fault fails attempts on purpose: the one runner stays in
        base.set("tpumr.tracker.max.faults", MS_MAX_FAULTS)
        # the gates here hold every map to its first attempt; master_state
        # (c) turns speculation on for its own job
        base.set("mapred.speculative.execution", False)
        # master_state (a): the master writes history from the start, and
        # the one started in its place recovers from it
        base.set("tpumr.history.dir", os.path.join(work, "history"))
        base.set("mapred.jobtracker.restart.recover", True)
        base.set("mapred.jobtracker.restart.recovery.grace.ms", MS_GRACE_MS)
        runs = []
        c = MiniMRCluster(num_trackers=1, cpu_slots=3, tpu_slots=1,
                          conf=base)
        later = PipesLater(c, work)
        conf = c.create_job_conf()
        conf.set_job_name("hybrid-kmeans")
        conf.set_input_paths(f"file://{work}/points.npy")
        conf.set_output_path(f"file://{work}/out-km")
        conf.set_input_format(DenseInputFormat)
        conf.set("tpumr.dense.split.rows", HYB_ROWS)
        conf.set("tpumr.kmeans.centroids", f"file://{work}/cents.npy")
        conf.set_map_kernel("kmeans-assign")
        conf.set("mapred.reducer.class",
                 "tpumr_torch.ops.kmeans.CentroidReducer")
        conf.set_num_reduce_tasks(1)
        for tag, out in (("kmeans_round1", "out-km"),
                         ("kmeans_round2", "out-km-r2"),
                         ("kmeans_minimize", "out-km-r3")):
            if tag == "kmeans_minimize":
                conf.set("tpumr.scheduler.mode", "minimize")
            conf.set_output_path(f"file://{work}/{out}")
            row = hybrid_run(conf, tag, km)
            row["out"] = out
            runs.append(row)

        conf = c.create_job_conf()
        conf.set_job_name("hybrid-matmul")
        conf.set_input_paths(f"file://{work}/a.npy")
        conf.set_output_path(f"file://{work}/out-mm")
        conf.set_input_format(DenseInputFormat)
        conf.set("tpumr.dense.split.rows", HYB_MM_N // 4)
        conf.set("tpumr.matmul.b", f"file://{work}/b.npy")
        conf.set("tpumr.matmul.bf16", False)
        conf.set_map_kernel("matmul-block")
        conf.set_output_format(SequenceFileOutputFormat)
        conf.set_num_reduce_tasks(0)
        mm = hybrid_run(conf, "matmul", km)
        clean = check_no_faults(c.master, "hybrid")
        # pipes_isolation: the holding GPU child starts beside the
        # accel_fault steps; (b) and (c) on the same cluster after them
        exes = write_pipes_exes(work)
        held = HeldCard(exes[1])
        try:
            accel = accel_fault_cluster(c, work, n, cents, km)
            t = time.monotonic()
            kill = held.kill_check()
            kill["added_s"] = time.monotonic() - t
        finally:
            held.close()
        ref = oracle(work, n, cents, km, compare=False)["centroids"]
        # master_state (c), in line: beside the chain's host threads its
        # CPU maps crawl for the interpreter lock (PR 16 run 1)
        t = time.monotonic()
        spec = master_state_speculation(c, work, cents, km)
        spec["seconds"] = time.monotonic() - t

        for row in runs:
            tag = row["run"]
            check(row["TPU_MAP_TASKS"] + row["CPU_MAP_TASKS"] == n_maps,
                  f"hybrid {tag}: {row['TPU_MAP_TASKS']} + "
                  f"{row['CPU_MAP_TASKS']} maps, expected {n_maps}")
            check(row["TPU_MAP_TASKS"] >= 1 and row["CPU_MAP_TASKS"] >= 1,
                  f"hybrid {tag}: placement {row['placement']} does not "
                  "use both pools")
            check(row["launches"] == {
                "kmeans_assign_partials": row["TPU_MAP_TASKS"],
                "kmeans_assign": 0}, f"hybrid {tag}: launches "
                f"{row['launches']} for {row['TPU_MAP_TASKS']} GPU maps")
            check(row["CPU_BATCH_MAP_TASKS"] == row["CPU_MAP_TASKS"],
                  f"hybrid {tag}: {row['CPU_BATCH_MAP_TASKS']} of "
                  f"{row['CPU_MAP_TASKS']} CPU maps on the batch runner")
        for row in runs:
            got = read_centroids(os.path.join(work, row["out"],
                                              "part-00000"))
            check(sorted(got) == list(range(K)),
                  f"hybrid {row['run']}: clusters {sorted(got)}")
            got = np.stack([got[i] for i in range(K)])
            err = np.abs(got - ref)
            row["max_abs_err"] = float(err.max())
            check(bool(np.all(err <= CENTROID_ATOL + CENTROID_RTOL *
                              np.abs(ref))),
                  f"hybrid {row['run']}: centroids off the float64 oracle "
                  f"by up to {err.max():.3g}")
        r2 = runs[1]
        check(r2["acceleration_factor"] > 1.0,
              f"hybrid kmeans_round2: acceleration factor "
              f"{r2['acceleration_factor']:.3f} (CPU map "
              f"{r2['cpu_map_mean_s']:.4f} s, GPU map "
              f"{r2['gpu_map_mean_s']:.4f} s) is not above 1")

        blocks = {}
        for name in sorted(os.listdir(os.path.join(work, "out-mm"))):
            if name.startswith("part-"):
                with open(os.path.join(work, "out-mm", name), "rb") as f:
                    for row0, block in sequencefile.Reader(f):
                        blocks[int(row0)] = np.asarray(block)
        check(sorted(blocks) == list(range(0, HYB_MM_N, HYB_MM_N // 4)),
              f"hybrid matmul: blocks at rows {sorted(blocks)}")
        got = np.concatenate([blocks[r] for r in sorted(blocks)])
        check(got.dtype == np.float32 and got.shape == (HYB_MM_N, HYB_MM_N),
              f"hybrid matmul: output {got.dtype} {got.shape}")
        a = torch.from_numpy(np.load(os.path.join(work, "a.npy"))).cuda()
        b = torch.from_numpy(np.load(os.path.join(work, "b.npy"))).cuda()
        err = (torch.from_numpy(got).cuda().double()
               - a.double() @ b.double()).abs()
        ratio = float((err / (a.double().abs() @ b.double().abs())).max())
        mm |= {"max_abs_err": float(err.max()),
               "max_err_over_scale": ratio, "err_bound": MM_ERR}
        del a, b, err
        log("hybrid_matmul " + json.dumps(mm))
        check(ratio <= MM_ERR, f"hybrid matmul: |C - C64| reaches "
              f"{ratio:.3g} of the f32 error scale, over {MM_ERR}")
        later.ready(exes, ref, km, kill, cpp.join())
        secs = time.monotonic() - t_phase
        log("hybrid_phase " + json.dumps({
            "seconds": secs, "accel_fault_s": accel["seconds"],
            "pipes_kill_added_s": kill["added_s"], "clean_jobs":
            clean["jobs"]}))
        return {"runs": runs, "matmul": mm, "seconds": secs, "accel": accel,
                "launches": sum(r["launches"]["kmeans_assign_partials"]
                                for r in runs)
                + accel["quarantine"]["launches"]["kmeans_assign_partials"],
                "pipes": later, "master_state_c": spec}
    except BaseException:
        if later is not None:
            later.close()
        raise
    finally:
        cpp.join()
        gpu_runner.clear_split_caches()
        if os.path.exists(os.path.join(work, "points.npy")):
            # the pipes job keeps the points under a name of its own
            os.link(os.path.join(work, "points.npy"),
                    os.path.join(work, "pipes-points.npy"))
            os.replace(os.path.join(work, "points.npy"), keep_points)
        if later is None or later.closed:
            shutil.rmtree(work, ignore_errors=True)


def pipe_round_conf(work: str, prefix: str) -> dict:
    """The pipeline phase's K-Means round, templated by round: the hybrid
    phase's points and splits on the GPU slot, the centroids in from
    {prefix}cents-r{round}.npy and out to {prefix}cents-r{next_round}.npy
    (bench.py:290-305's round conf), the split cache large enough for all
    8 splits."""
    return {
        "mapred.input.dir": f"file://{work}/points.npy",
        "mapred.output.dir": f"file://{work}/{prefix}out-r{{round}}",
        "mapred.input.format.class":
            "tpumr_torch.mapred.input_formats.DenseInputFormat",
        "tpumr.dense.split.rows": HYB_ROWS,
        "tpumr.map.kernel": "kmeans-assign",
        "mapred.reducer.class":
            "tpumr_torch.ops.kmeans.KMeansCentroidUpdateReducer",
        "mapred.reduce.tasks": 1,
        "tpumr.kmeans.centroids":
            f"file://{work}/{prefix}cents-r{{round}}.npy",
        "tpumr.kmeans.centroids.out":
            f"file://{work}/{prefix}cents-r{{next_round}}.npy",
        "tpumr.tpu.split.cache.mb": 8192,
    }


def stage_rows(master, job_ids: list) -> list:
    """Per stage job: its seconds on the master (submission to its last
    task), the bytes its maps staged (0 where every split was a split-cache
    hit), its GPU maps, and whether every map succeeded on its first
    attempt."""
    from tpumr_torch.core.counters import BackendCounter
    rows = []
    for j in job_ids:
        jip = master.jobs[j]
        reports = master.get_task_reports(j, "map")
        rows.append({
            "job": j, "exec_s": jip.finish_time - jip.start_time,
            "bytes_staged": jip.counters.value(
                BackendCounter.GROUP, BackendCounter.TPU_DEVICE_BYTES_STAGED),
            "gpu_maps": jip.finished_tpu_maps,
            "first_attempts": all(r["successful_attempt"].endswith("_0")
                                  for r in reports)})
    return rows


def pipeline_loop(c, work: str, n: int, km) -> dict:
    """(a): PIPE_ROUNDS rounds as one PipelineClient submission (a loop
    node whose predicate never holds) against PIPE_ROUNDS JobClient
    submissions on the same cluster with the centroid caches cleared
    before each (bench.py:262-381's pair), each side from a cold split
    cache; then a loop from the last
    round's centroids that its predicate settles after one round."""
    from tpumr_torch.mapred import gpu_runner
    from tpumr_torch.mapred.job_client import JobClient
    from tpumr_torch.pipeline import JobGraph, PipelineClient
    from tpumr_torch.pipeline.graph import expand_round
    n_maps = -(-n // HYB_ROWS)
    never = {"group": km.SHIFT_COUNTER_GROUP, "counter": km.SHIFT_COUNTER,
             "op": "lt", "value": 0}
    master = c.master
    client = PipelineClient(c.create_job_conf())
    try:
        zero_launch_counts(km)
        t = time.monotonic()
        st = client.submit(JobGraph("kmeans-loop").loop(
            "km", pipe_round_conf(work, "pipe-"), max_rounds=PIPE_ROUNDS,
            converge=never)).wait_for_completion(
                poll_s=0.05, timeout=PIPE_TIMEOUT_S)
        pipe_s = time.monotonic() - t
        pipe_launches = launch_counts(km)
    finally:
        client.close()
    check(st["state"] == "SUCCEEDED", f"pipeline kmeans loop: {st}")
    node = st["nodes"]["km"]
    check(node["rounds_run"] == PIPE_ROUNDS,
          f"pipeline kmeans loop ran {node['rounds_run']} rounds")
    pipe = stage_rows(master, node["jobs"])

    # both sides start cold: the sequential side's round 0 stages the
    # points again, as the pipelined side's did
    gpu_runner.clear_split_caches()
    zero_launch_counts(km)
    seq_jobs = []
    t = time.monotonic()
    for r in range(PIPE_ROUNDS):
        km.clear_centroid_cache()
        conf = c.create_job_conf()
        for key, value in expand_round(pipe_round_conf(work, "seq-"),
                                       r).items():
            conf.set(key, value)
        jc = JobClient(conf)
        try:
            running = jc.submit_job(conf)
            sst = running.wait_for_completion(timeout=HYB_JOB_TIMEOUT_S)
        finally:
            jc.close()
        check(sst["state"] == "SUCCEEDED", f"sequential round {r}: {sst}")
        seq_jobs.append(running.job_id)
    seq_s = time.monotonic() - t
    seq_launches = launch_counts(km)
    seq = stage_rows(master, seq_jobs)

    finals = []
    for prefix in ("pipe-", "seq-"):
        with open(os.path.join(work, f"{prefix}cents-r{PIPE_ROUNDS}.npy"),
                  "rb") as f:
            finals.append(f.read())
    check(finals[0] == finals[1], "the pipelined rounds' final centroids "
          "differ from the sequential rounds'")
    want = {"kmeans_assign_partials": PIPE_ROUNDS * n_maps,
            "kmeans_assign": 0}
    check(pipe_launches == want and seq_launches == want,
          f"pipeline launches {pipe_launches}, sequential {seq_launches}, "
          f"expected {want} each")
    for label, rows in (("pipelined", pipe), ("sequential", seq)):
        check(all(r["first_attempts"] for r in rows),
              f"{label} rounds: a map succeeded only after a failed attempt")
        check(all(r["gpu_maps"] == n_maps for r in rows),
              f"{label} rounds: GPU maps {[r['gpu_maps'] for r in rows]}")
    staged = [r["bytes_staged"] for r in pipe]
    seq_staged = [r["bytes_staged"] for r in seq]
    for label, got in (("pipelined", staged), ("sequential", seq_staged)):
        check(got[0] > 0 and not any(got[1:]),
              f"{label} rounds staged {got} bytes")
    cents0 = np.load(os.path.join(work, "pipe-cents-r0.npy"))
    ref = oracle(work, n, cents0, km, compare=False)["centroids"]
    err = np.abs(np.load(os.path.join(work, "pipe-cents-r1.npy")) - ref)
    check(bool(np.all(err <= CENTROID_ATOL + CENTROID_RTOL * np.abs(ref))),
          f"pipelined round 0: centroids off a float64 Lloyd step by up to "
          f"{err.max():.3g}")

    # settling: a loop from round PIPE_ROUNDS's centroids, whose predicate
    # (le, just above the float64 step's shift) holds after its one round
    last = np.load(os.path.join(work, f"pipe-cents-r{PIPE_ROUNDS}.npy"))
    np.save(os.path.join(work, "conv-cents-r0.npy"), last)
    step = oracle(work, n, last, km, compare=False)["centroids"]
    shift = int(round(float(np.abs(step - last).sum()) * 1000))
    threshold = shift + max(2, shift // 100)
    client = PipelineClient(c.create_job_conf())
    try:
        zero_launch_counts(km)
        cst = client.submit(JobGraph("kmeans-settle").loop(
            "km", pipe_round_conf(work, "conv-"), max_rounds=5,
            converge=dict(never, op="le", value=threshold))
        ).wait_for_completion(poll_s=0.05, timeout=PIPE_TIMEOUT_S)
        conv_launches = launch_counts(km)
    finally:
        client.close()
    check(cst["state"] == "SUCCEEDED" and cst["nodes"]["km"]["rounds_run"]
          == 1, f"the settling loop: {cst['state']}, "
          f"{cst['nodes']['km']['rounds_run']} rounds")
    got_shift = master.jobs[cst["nodes"]["km"]["job_id"]].counters.value(
        km.SHIFT_COUNTER_GROUP, km.SHIFT_COUNTER)
    check(got_shift <= threshold, f"the settling round's shift {got_shift} "
          f"above its threshold {threshold}")

    pipe_exec = sum(r["exec_s"] for r in pipe)
    seq_exec = sum(r["exec_s"] for r in seq)
    row = {"rounds": PIPE_ROUNDS, "maps_per_round": n_maps,
           "seq_s": seq_s, "pipe_s": pipe_s,
           "seq_exec_s": seq_exec, "pipe_exec_s": pipe_exec,
           "seq_overhead_per_round_s": (seq_s - seq_exec) / PIPE_ROUNDS,
           "pipe_overhead_per_round_s": (pipe_s - pipe_exec) / PIPE_ROUNDS,
           "pipe_round_s": [r["exec_s"] for r in pipe],
           "seq_round_s": [r["exec_s"] for r in seq],
           "pipe_bytes_staged": staged,
           "seq_bytes_staged": seq_staged,
           "launches": {"pipelined": pipe_launches,
                        "sequential": seq_launches,
                        "settling": conv_launches},
           "round0_max_abs_err": float(err.max()),
           "settle_shift_milli": got_shift, "settle_threshold": threshold}
    log("pipeline " + json.dumps(row))
    return row


def pipeline_restart(c, work: str, n: int, km) -> dict:
    """master_state (b), a pipeline through a master restart, on the
    pipeline phase's cluster (1 runner, 1 GPU slot; its master writes
    history and recovers at start, grace MS_GRACE_MS): a MS_LOOP_ROUNDS-
    round K-Means loop node from (a)'s seeds (pipe_round_conf, prefix
    rst-); once round 0's job committed, the master is stopped with
    nothing finalised and a new one started on its address. Gates: the
    pipeline SUCCEEDED under its id; round 0 kept its one job (settled
    from history, not run again) and each later round ran one; every
    round's centroid file byte-identical to the same round of (a)'s loop
    submission (one slot: the placement is fixed); kmeans_assign_partials
    n_maps times a round; pipelines_recovered 1."""
    from tpumr_torch.pipeline import JobGraph, PipelineClient
    n_maps = -(-n // HYB_ROWS)
    never = {"group": km.SHIFT_COUNTER_GROUP, "counter": km.SHIFT_COUNTER,
             "op": "lt", "value": 0}
    shutil.copyfile(os.path.join(work, "pipe-cents-r0.npy"),
                    os.path.join(work, "rst-cents-r0.npy"))
    km.clear_centroid_cache()
    zero_launch_counts(km)
    client = PipelineClient(c.create_job_conf())
    try:
        t0 = time.monotonic()
        running = client.submit(JobGraph("kmeans-restart").loop(
            "km", pipe_round_conf(work, "rst-"), max_rounds=MS_LOOP_ROUNDS,
            converge=never))
        deadline = time.monotonic() + PIPE_TIMEOUT_S
        while True:
            jobs = poll_status(running)["nodes"]["km"]["jobs"]
            if jobs and c.master.jobs[jobs[0]].finalized.is_set():
                break
            check(time.monotonic() < deadline,
                  "master_state (b): round 0 never committed")
            time.sleep(0.005)
        round0 = jobs[0]
        t_stop = time.monotonic()
        m2 = restart_master(c)
        st = wait_terminal(running, PIPE_TIMEOUT_S)
        stop_to_done = time.monotonic() - t_stop
        secs = time.monotonic() - t0
    finally:
        client.close()
    launches = launch_counts(km)
    node = st["nodes"]["km"]
    same = []
    for r in range(1, MS_LOOP_ROUNDS + 1):
        with open(os.path.join(work, f"rst-cents-r{r}.npy"), "rb") as f, \
                open(os.path.join(work, f"pipe-cents-r{r}.npy"), "rb") as g:
            same.append(f.read() == g.read())
    metrics = m2.get_metrics()
    row = {"seconds": secs, "stop_to_succeeded_s": stop_to_done,
           "jobs": node["jobs"], "round0": round0,
           "rounds_identical": same, "launches": launches,
           "pipelines_recovered": metrics["pipelines_recovered"],
           "jobs_recovered": metrics["jobs_recovered"],
           "maps_launched_tpu": metrics["maps_launched_tpu"]}
    log("master_state_pipeline " + json.dumps(row))
    check(st["state"] == "SUCCEEDED", f"master_state (b): {st}")
    check(node["jobs"][0] == round0 and len(set(node["jobs"]))
          == MS_LOOP_ROUNDS, f"master_state (b): round jobs {node['jobs']}")
    check(all(same), f"master_state (b): rounds identical {same}")
    check(launches == {"kmeans_assign_partials": MS_LOOP_ROUNDS * n_maps,
                       "kmeans_assign": 0},
          f"master_state (b): launches {launches}, expected "
          f"{MS_LOOP_ROUNDS * n_maps}")
    check(metrics["pipelines_recovered"] == 1
          and metrics["maps_launched_tpu"] <= (MS_LOOP_ROUNDS - 1) * n_maps,
          f"master_state (b): {row}")
    return row


def wait_for_line(path: str, prefix: str, proc, timeout: float) -> str:
    """The first line of a daemon's log that contains ``prefix``."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with open(path) as f:
            for line in f:
                if prefix in line:
                    return line.strip()
        check(proc.poll() is None, f"daemon exited {proc.returncode}: "
              + open(path).read()[-2000:])
        time.sleep(0.1)
    fail(f"no {prefix!r} from a daemon within {timeout}s")


def pipeline_cli(work: str, km) -> dict:
    """(b): python -m tpumr_torch.cli jobtracker and tasktracker (one GPU
    slot, no CPU slot), each a process of its own; examples kmeans sent to
    them with -jt, and pipeline submit -wait of a 3-round loop node, both
    equal to (a)'s round-3 centroids; job -list naming the 6 jobs; both
    daemons exit 0 on SIGTERM."""
    from tpumr_torch.pipeline import JobGraph
    repo = os.path.dirname(os.path.abspath(__file__))
    py = [sys.executable, "-m", "tpumr_torch.cli"]
    procs, logs, secs = [], [], {}

    def run(label: str, args: list, timeout: float = 600) -> str:
        t = time.monotonic()
        proc = subprocess.run(py + args, cwd=repo, capture_output=True,
                              text=True, timeout=timeout)
        secs[label] = time.monotonic() - t
        check(proc.returncode == 0, f"cli {label} exited {proc.returncode}:"
              f" {proc.stderr[-2000:]}")
        return proc.stdout

    def daemon(label: str, args: list):
        path = os.path.join(work, f"{label}.log")
        with open(path, "wb") as f:
            procs.append(subprocess.Popen(py + args, cwd=repo, stderr=f,
                                          stdout=subprocess.DEVNULL))
        logs.append(path)
        return procs[-1], path

    t_all = time.monotonic()
    try:
        jt, jt_log = daemon("jobtracker", ["jobtracker", "-port", "0"])
        addr = wait_for_line(jt_log, "JobMaster up at", jt, 120).split()[-1]
        tt, tt_log = daemon("tasktracker", [
            "-jt", addr, "-D", "mapred.tasktracker.map.tpu.tasks.maximum=1",
            "-D", "mapred.tasktracker.map.cpu.tasks.maximum=0",
            "-D", "tpumr.heartbeat.interval.ms=50", "tasktracker"])
        wait_for_line(tt_log, "NodeRunner up", tt, 120)
        secs["daemons_up"] = time.monotonic() - t_all
        jt_args = ["-jt", addr, "-D", "tpumr.tpu.split.cache.mb=8192"]
        run("examples_kmeans", jt_args + [
            "examples", "kmeans", f"file://{work}/points.npy",
            f"file://{work}/cli-out", "-k", str(K), "-i",
            str(PIPE_CLI_ROUNDS), "--split-rows", str(HYB_ROWS)])
        np.save(os.path.join(work, "cli-cents-r0.npy"),
                np.load(os.path.join(work, "pipe-cents-r0.npy")))
        graph = os.path.join(work, "graph.json")
        with open(graph, "w") as f:
            json.dump(JobGraph("cli-loop").loop(
                "km", pipe_round_conf(work, "cli-"),
                max_rounds=PIPE_CLI_ROUNDS).to_dict(), f)
        out = run("pipeline_submit", ["-jt", addr, "pipeline", "submit",
                                      graph, "-wait"])
        check(json.loads(out.split("\n", 1)[1])["state"] == "SUCCEEDED",
              f"pipeline submit: {out[-2000:]}")
        listed = run("job_list", ["-jt", addr, "job", "-list"])
        states = [ln.split("\t")[1] for ln in listed.splitlines()]
        check(states == ["SUCCEEDED"] * (2 * PIPE_CLI_ROUNDS),
              f"job -list: {listed!r}")
        reaper = daemons_reaper(addr, work, run)
        t = time.monotonic()
        for p in (tt, jt):
            p.send_signal(signal.SIGTERM)
        codes = [p.wait(timeout=120) for p in (tt, jt)]
        secs["sigterm_to_exit"] = time.monotonic() - t
        check(codes == [0, 0], f"daemons exited {codes} on SIGTERM")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
    want = np.load(os.path.join(work, f"pipe-cents-r{PIPE_CLI_ROUNDS}.npy"))
    for label, path in (("examples kmeans", "cli-out/centroids.npy"),
                        ("pipeline submit",
                         f"cli-cents-r{PIPE_CLI_ROUNDS}.npy")):
        got = np.load(os.path.join(work, path))
        check(got.dtype == want.dtype and np.array_equal(got, want),
              f"{label} through the daemons: centroids differ from round "
              f"{PIPE_CLI_ROUNDS}'s by up to "
              f"{float(np.abs(got - want).max()):.3g}")
    row = {"seconds": time.monotonic() - t_all, "steps_s": secs,
           "jobs_listed": len(states), "reaper": reaper}
    log("pipeline_cli " + json.dumps(row))
    return row


def daemons_reaper(addr: str, work: str, run) -> dict:
    """accel_fault (4), through the daemons: their jobs so far neither
    demoted nor reaped (5); then examples sleep -m 4 -r 1 --tpu --hang-map
    0 with mapred.task.timeout=ACCEL_SLEEP_TIMEOUT_MS sent with -jt. Map 0's
    first attempt hangs on the runner's one GPU slot: exactly one attempt
    is reaped (TASKS_REAPED_TIMEOUT 1, class timeout), map 0 succeeds on
    attempt 1, and the runner's task threads (its metrics, over RPC at its
    shuffle address) all end."""
    from tpumr_torch.ipc.rpc import RpcClient
    host, port = addr.rsplit(":", 1)
    master = RpcClient(host, int(port))
    try:
        before = master.call("get_metrics")
        check(not any(before[k] for k in FAULT_METRICS),
              f"the daemons' jobs were demoted or reaped: {before}")
        t = time.monotonic()
        run("examples_sleep", [
            "-jt", addr, "examples", "sleep", "-m", "4", "-r", "1", "--tpu",
            "--hang-map", "0", "--work", f"file://{work}/sleep",
            "-D", f"mapred.task.timeout={ACCEL_SLEEP_TIMEOUT_MS}"])
        secs = time.monotonic() - t
        job_id = master.call("list_jobs")[-1]
        counters = master.call("get_counters", job_id)
        maps = master.call("get_task_reports", job_id, "map")
        events = master.call("get_map_completion_events", job_id, 0)
        after = master.call("get_metrics")
    finally:
        master.close()
    reaped = counters.get("tpumr.JobCounter", {}).get("TASKS_REAPED_TIMEOUT")
    check(reaped == 1 and after["tasks_reaped_timeout"] == 1
          and after["tpu_demotions"] == 0, f"sleep --hang-map 0: "
          f"TASKS_REAPED_TIMEOUT {reaped}, master {after}")
    check(maps[0]["successful_attempt"].endswith("_1")
          and all(m["successful_attempt"].endswith("_0") for m in maps[1:]),
          f"sleep --hang-map 0: attempts "
          f"{[m['successful_attempt'] for m in maps]}")
    rhost, rport = events[0]["shuffle_addr"].rsplit(":", 1)
    runner = RpcClient(rhost, int(rport))
    try:
        deadline = time.monotonic() + 10
        while True:
            m = runner.call("metrics")
            if not m["task_threads"] or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        runner.close()
    check(not m["task_threads"] and m["tasks_reaped_timeout"] == 1,
          f"sleep --hang-map 0: the runner {m}")
    row = {"job_s": secs, "TASKS_REAPED_TIMEOUT": reaped,
           "attempts": [m["successful_attempt"] for m in maps],
           "runner": m}
    log("accel_fault_reaper " + json.dumps(row))
    return row


def terasort_graph(root: str, stream: bool):
    """tests/test_pipeline.py:353-398's chain for the port: teragen ->
    sort (partition sampling in the master's hook) -> validate."""
    from tpumr_torch.pipeline import JobGraph
    pkg = "tpumr_torch"
    seq_out = f"{pkg}.mapred.output_formats.SequenceFileOutputFormat"
    seq_in = f"{pkg}.mapred.input_formats.SequenceFileInputFormat"
    g = JobGraph(f"terasort-{'stream' if stream else 'dfs'}")
    g.node("gen", {
        "mapred.input.dir": f"{root}/rows.txt",
        "mapred.output.dir": f"{root}/gen",
        "mapred.input.format.class":
            f"{pkg}.mapred.input_formats.NLineInputFormat",
        "mapred.line.input.format.linespermap": 1,
        "mapred.mapper.class": f"{pkg}.examples.terasort.TeraGenMapper",
        "mapred.output.format.class": seq_out, "mapred.reduce.tasks": 0})
    g.node("sort", {
        "mapred.output.dir": f"{root}/sorted",
        "mapred.input.format.class": seq_in,
        "mapred.mapper.class": f"{pkg}.examples.terasort.TeraSortMapper",
        "mapred.reducer.class": f"{pkg}.mapred.api.IdentityReducer",
        "mapred.output.format.class": seq_out,
        "mapred.output.key.comparator.class":
            f"{pkg}.mapred.api.RawComparator",
        "mapred.reduce.tasks": PIPE_TERA_REDUCES,
    }, conf_hook=f"{pkg}.examples.terasort.pipeline_sort_hook")
    validate = {
        "mapred.output.dir": f"{root}/ok",
        "mapred.mapper.class": f"{pkg}.examples.terasort.TeraValidateMapper",
        "mapred.reducer.class":
            f"{pkg}.examples.terasort.TeraValidateReducer",
        "mapred.reduce.tasks": 1}
    if not stream:
        validate["mapred.input.format.class"] = seq_in
        validate["mapred.min.split.size"] = 1 << 60
    g.node("validate", validate)
    g.edge("gen", "sort").edge("sort", "validate", stream=stream)
    return g


def pipeline_terasort(work: str, rows: int) -> dict:
    """(c): TeraSort's chain as one pipeline on a mini cluster of CPU
    slots (the host shuffle), once with a dfs edge sort -> validate and
    once with a stream edge: the same sorted records part for part, the
    input's count and checksum, an empty validate output, and the streamed
    validate's splits all streamed."""
    from tpumr_torch.mapred.jobconf import JobConf
    from tpumr_torch.mapred.mini_cluster import MiniMRCluster
    from tpumr_torch.pipeline import PipelineClient
    from tpumr_torch.pipeline.handoff import (COUNTER_FALLBACK,
                                              COUNTER_GROUP,
                                              COUNTER_STREAMED)
    per = rows // PIPE_TERA_MAPS
    last = PIPE_TERA_MAPS - 1
    lines = "".join(f"{m * per} {per if m < last else rows - m * per}\n"
                    for m in range(PIPE_TERA_MAPS))
    base = JobConf()
    base.set("mapred.reduce.slowstart.completed.maps", 0.0)
    out = {}
    with MiniMRCluster(num_trackers=1, cpu_slots=PIPE_TERA_MAPS,
                       tpu_slots=0, conf=base) as c:
        client = PipelineClient(c.create_job_conf())
        try:
            for tag, stream in (("dfs", False), ("stream", True)):
                root = os.path.join(work, f"tera-{tag}")
                os.makedirs(root)
                with open(os.path.join(root, "rows.txt"), "w") as f:
                    f.write(lines)
                t = time.monotonic()
                st = client.submit(terasort_graph(f"file://{root}", stream)) \
                    .wait_for_completion(poll_s=0.1, timeout=PIPE_TIMEOUT_S)
                secs = time.monotonic() - t
                check(st["state"] == "SUCCEEDED",
                      f"terasort pipeline ({tag}): {st}")
                val = c.master.jobs[st["nodes"]["validate"]["job_id"]]
                ok = b"".join(open(p, "rb").read()
                              for p in seq_files(os.path.join(root, "ok")))
                out[tag] = {
                    "seconds": secs,
                    "stage_s": {nid: c.master.jobs[n["job_id"]].finish_time
                                - c.master.jobs[n["job_id"]].start_time
                                for nid, n in st["nodes"].items()},
                    "streamed_splits": val.counters.value(COUNTER_GROUP,
                                                          COUNTER_STREAMED),
                    "fallback_splits": val.counters.value(COUNTER_GROUP,
                                                          COUNTER_FALLBACK),
                    "validate_output_bytes": len(ok)}
                check(ok == b"", f"terasort pipeline ({tag}): validate "
                      f"reported {ok[:500]!r}")
                sums = rows_checksum(os.path.join(root, "sorted"))
                check(sums == rows_checksum(os.path.join(root, "gen"))
                      and sums["records"] == rows,
                      f"terasort pipeline ({tag}) lost or changed records")
            check_no_faults(c.master, "pipeline terasort")
        finally:
            client.close()
    same_parts(os.path.join(work, "tera-dfs", "sorted"),
               os.path.join(work, "tera-stream", "sorted"),
               "the dfs and streamed chains")
    check(out["stream"]["streamed_splits"] == PIPE_TERA_REDUCES
          and out["stream"]["fallback_splits"] == 0
          and out["dfs"]["streamed_splits"] == 0,
          f"terasort pipeline handoff counters: {out}")
    row = {"records": rows, "maps": PIPE_TERA_MAPS,
           "reduces": PIPE_TERA_REDUCES} | out
    log("pipeline_terasort " + json.dumps(row))
    return row


def pipeline_phase(km, n: int, tera_rows: int, points: str,
                   beside_chain=None) -> dict:
    """The pipeline engine on the card: (a) the K-Means loop node on a
    mini cluster with one GPU slot, (b) the command line's daemons, (c)
    TeraSort's chain as one pipeline. The hybrid phase's points, moved in
    from ``points``. ``beside_chain``, where given, runs in a Beside of its
    own beside (c), as (b) does (the hybrid phase's pipes steps)."""
    from tpumr_torch.examples.basic import load_npy_rows
    from tpumr_torch.fs.filesystem import FileSystem
    from tpumr_torch.mapred import gpu_runner
    from tpumr_torch.mapred.jobconf import JobConf
    from tpumr_torch.mapred.mini_cluster import MiniMRCluster
    from tpumr_torch.ops import devcache
    t_phase = time.monotonic()
    work = tempfile.mkdtemp(prefix="tpumr_torch-pipeline-")
    try:
        os.replace(points, os.path.join(work, "points.npy"))
        points = f"file://{work}/points.npy"
        seeds = load_npy_rows(FileSystem.get(points), points, K)
        for prefix in ("pipe-", "seq-"):
            np.save(os.path.join(work, f"{prefix}cents-r0.npy"),
                    seeds.astype(np.float32))
        gpu_runner.clear_split_caches()
        devcache.clear_device_cache()
        # master_state (b): the master writes history, and the one
        # started in its place recovers; cluster_shuffle (c) loses outputs
        # on purpose, so its one runner must not be blacklisted
        pconf = JobConf()
        pconf.set("tpumr.history.dir", os.path.join(work, "history"))
        pconf.set("mapred.jobtracker.restart.recover", True)
        pconf.set("mapred.jobtracker.restart.recovery.grace.ms", MS_GRACE_MS)
        pconf.set("tpumr.tracker.max.faults", MS_MAX_FAULTS)
        with MiniMRCluster(num_trackers=1, cpu_slots=0, tpu_slots=1,
                           conf=pconf) as c:
            loop = pipeline_loop(c, work, n, km)
            # cluster_shuffle (c), on this cluster and its points
            lost = lost_output_rounds(c, work, n, km)
            check_no_faults(c.master, "pipeline")
            restart = pipeline_restart(c, work, n, km)
        km.clear_pipeline_caches()
        gpu_runner.clear_split_caches()
        # (b)'s daemons and programs, processes of their own, beside (c)
        beside = Beside(pipeline_cli, work, km)
        pipes = Beside(beside_chain) if beside_chain is not None else None
        try:
            tera = pipeline_terasort(work, tera_rows)
        finally:
            try:
                cli = beside.join()
            finally:
                pipes_row = pipes.join() if pipes is not None else None
        check(not [th.name for th in threading.enumerate()
                   if th.name.startswith(("heartbeat-", "task-",
                                          "rpc-server", "jobmaster-"))],
              "a pipeline cluster left threads running")
        # the phase's seconds as before cluster_shuffle (c) and
        # master_state (b) joined it
        secs = (time.monotonic() - t_phase - lost["seconds"]
                - restart["seconds"])
        log("pipeline_phase " + json.dumps({"seconds": secs}))
        return {"loop": loop, "cli": cli, "terasort": tera,
                "seconds": secs, "lost_output": lost, "pipes": pipes_row,
                "restart": restart,
                "launches": sum(v["kmeans_assign_partials"]
                                for v in loop["launches"].values())}
    finally:
        gpu_runner.clear_split_caches()
        shutil.rmtree(work, ignore_errors=True)


def matmul_bound_ms(m: int, k: int, n: int, peak_flops: float
                    ) -> tuple[float, str]:
    """Least time for one map's product: the f32 operands read once and
    the f32 product written once, against 2mkn operations at
    ``peak_flops``."""
    t_bytes = 4 * (m * k + k * n + m * n) / PEAK_BYTES_PER_S
    t_ops = 2 * m * k * n / peak_flops
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


def matmul_phase() -> dict:
    """BASELINE config 4 through the port: the map-only blocked product
    (MM_N x MM_N f32 A and B from default_rng(2), splits of MM_ROWS rows)
    with DenseNpyOutputFormat, in f32 and in bf16 (f32 out), each against a
    float64 product; then D = C @ B over the f32 job's output, which must
    read every split from the card (output chain) and stage 0 bytes.
    Times each job and one map's product in f32 and bf16 beside their
    bounds."""
    from tpumr_torch.core.counters import BackendCounter
    from tpumr_torch.mapred import device_output, gpu_runner
    from tpumr_torch.mapred.input_formats import DenseInputFormat
    from tpumr_torch.mapred.jobconf import JobConf
    from tpumr_torch.mapred.local_runner import run_job
    from tpumr_torch.mapred.output_formats import DenseNpyOutputFormat
    from tpumr_torch.ops import matmul

    work = tempfile.mkdtemp(prefix="tpumr_torch-matmul-")
    real_lookup = device_output.lookup
    hits = []

    def counted_lookup(*args):
        got = real_lookup(*args)
        hits.append(got is not None)
        return got

    try:
        rng = np.random.default_rng(2)
        a = rng.standard_normal(size=(MM_N, MM_N), dtype=np.float32)
        b = rng.standard_normal(size=(MM_N, MM_N), dtype=np.float32)
        np.save(os.path.join(work, "a.npy"), a)
        np.save(os.path.join(work, "b.npy"), b)
        gpu_runner.clear_split_caches()
        matmul.clear_b_cache()
        device_output.lookup = counted_lookup

        def job(label: str, inp: str, out: str, bf16: bool) -> dict:
            conf = JobConf()
            conf.set_input_paths(f"file://{work}/{inp}")
            conf.set_output_path(f"file://{work}/{out}")
            conf.set_input_format(DenseInputFormat)
            conf.set_output_format(DenseNpyOutputFormat)
            conf.set("tpumr.dense.split.rows", MM_ROWS)
            conf.set("tpumr.matmul.b", f"file://{work}/b.npy")
            conf.set("tpumr.matmul.bf16", bf16)
            conf.set_map_kernel("matmul-block")
            conf.set_num_reduce_tasks(0)
            hits.clear()
            t = time.monotonic()
            result = run_job(conf)
            secs = time.monotonic() - t
            check(result.successful, f"matmul {label} job failed")
            maps = MM_N // MM_ROWS
            got = np.concatenate([
                np.load(os.path.join(work, out, f"part-{i:05d}.npy"))
                for i in range(maps)])
            row = {"job": label, "seconds": secs, "maps": result.num_maps,
                   "device_maps": result.counters.value(
                       BackendCounter.GROUP, BackendCounter.TPU_MAP_TASKS),
                   "bytes_staged": result.counters.value(
                       BackendCounter.GROUP,
                       BackendCounter.TPU_DEVICE_BYTES_STAGED),
                   "chain_hits": sum(hits), "dtype": str(got.dtype)}
            check(result.num_maps == maps and row["device_maps"] == maps,
                  f"matmul {label}: {row['device_maps']} of "
                  f"{result.num_maps} maps on the device, expected {maps}")
            check(got.dtype == np.float32 and got.shape == (MM_N, MM_N),
                  f"matmul {label}: output {got.dtype} {got.shape}")
            return row, got

        def held(label: str, row: dict, got: np.ndarray, want, scale):
            err = (torch.from_numpy(got).cuda().double() - want).abs()
            ratio = float((err / scale).max())
            row |= {"max_abs_err": float(err.max()),
                    "max_err_over_scale": ratio, "err_bound": MM_ERR}
            log("matmul " + json.dumps(row))
            check(ratio <= MM_ERR, f"matmul {label}: |C - C64| reaches "
                  f"{ratio:.3g} of the f32 error scale, over {MM_ERR}")

        a64 = torch.from_numpy(a).cuda().double()
        b64 = torch.from_numpy(b).cuda().double()
        ab64 = a64 @ b64
        scale_ab = a64.abs() @ b64.abs()

        row, c32 = job("f32", "a.npy", "c32", bf16=False)
        check(row["bytes_staged"] == a.nbytes and row["chain_hits"] == 0,
              f"matmul f32: staged {row['bytes_staged']} bytes")
        held("f32", row, c32, ab64, scale_ab)
        rows = [row]

        row, c16 = job("bf16", "a.npy", "c16", bf16=True)
        a16 = torch.from_numpy(a).cuda().bfloat16().double()
        b16 = torch.from_numpy(b).cuda().bfloat16().double()
        held("bf16", row, c16, a16 @ b16, a16.abs() @ b16.abs())
        rows.append(row)
        del a16, b16

        row, d = job("chain", "c32", "d", bf16=False)
        check(row["bytes_staged"] == 0 and
              row["chain_hits"] == MM_N // MM_ROWS,
              f"matmul chain: staged {row['bytes_staged']} bytes, "
              f"{row['chain_hits']} output-chain hits")
        held("chain", row, d, ab64 @ b64, scale_ab @ b64.abs())
        rows.append(row)
        del a64, b64, ab64, scale_ab

        blk = torch.from_numpy(a[:MM_ROWS]).cuda()
        bd = torch.from_numpy(b).cuda()
        product = {}
        for label, bf16, peak in (("f32", False, PEAK_F32_FLOP_PER_S),
                                  ("bf16", True, PEAK_BF16_FLOP_PER_S)):
            bound, bound_by = matmul_bound_ms(MM_ROWS, MM_N, MM_N, peak)
            product[label] = {
                "shape": [MM_ROWS, MM_N, MM_N],
                "ms": time_ms(lambda: matmul.block_matmul(blk, bd, bf16)),
                "bound_ms": bound, "bound_by": bound_by}
        log("matmul_product " + json.dumps(product))
        return {"jobs": rows, "product": product}
    finally:
        device_output.lookup = real_lookup
        gpu_runner.clear_split_caches()
        matmul.clear_b_cache()
        shutil.rmtree(work, ignore_errors=True)


def pi_sigma(samples: int) -> float:
    p = np.pi / 4
    return 4 * float(np.sqrt(p * (1 - p) / samples))


def check_pi(label: str, inside: int, total: int) -> float:
    est = 4.0 * inside / total
    check(abs(est - np.pi) <= PI_SIGMAS * pi_sigma(total),
          f"{label}: estimate {est} is {abs(est - np.pi):.3g} off pi, over "
          f"{PI_SIGMAS} sigma ({PI_SIGMAS * pi_sigma(total):.3g})")
    return est


def read_pairs(path: str) -> dict:
    """A text part file's key -> int value."""
    out = {}
    with open(path, "rb") as f:
        for line in f.read().decode().splitlines():
            k, _, v = line.partition("\t")
            out[k] = int(v)
    return out


def text_conf(work: str, inp: str, out: str, fmt: str, kernel: str,
              combine: bool = True):
    from tpumr_torch.mapred.jobconf import JobConf
    conf = JobConf()
    conf.set_input_paths(f"file://{work}/{inp}")
    conf.set_output_path(f"file://{work}/{out}")
    conf.set("mapred.input.format.class",
             f"tpumr_torch.mapred.input_formats.{fmt}")
    conf.set_map_kernel(kernel)
    conf.set("mapred.reducer.class",
             "tpumr_torch.examples.basic.LongSumReducer")
    if combine:
        conf.set("mapred.combiner.class",
                 "tpumr_torch.examples.basic.LongSumReducer")
    conf.set_num_reduce_tasks(1)
    return conf


def job_counters(result) -> dict:
    from tpumr_torch.core.counters import BackendCounter, TaskCounter
    return {name: result.counters.value(group, name) for group, name in (
        (TaskCounter.FRAMEWORK_GROUP, TaskCounter.MAP_INPUT_RECORDS),
        (TaskCounter.FRAMEWORK_GROUP, TaskCounter.MAP_OUTPUT_RECORDS),
        (TaskCounter.FRAMEWORK_GROUP, TaskCounter.COMBINE_OUTPUT_RECORDS),
        (TaskCounter.FRAMEWORK_GROUP, TaskCounter.REDUCE_OUTPUT_RECORDS),
        (BackendCounter.GROUP, BackendCounter.TPU_MAP_TASKS),
        (BackendCounter.GROUP, BackendCounter.CPU_MAP_TASKS),
        (BackendCounter.GROUP, BackendCounter.CPU_BATCH_MAP_TASKS),
        (BackendCounter.GROUP, BackendCounter.TPU_MAP_MILLIS),
        (BackendCounter.GROUP, BackendCounter.CPU_MAP_MILLIS),
        (BackendCounter.GROUP, BackendCounter.TPU_DEVICE_BYTES_STAGED))}


def pi_phase(work: str) -> dict:
    """bench.py's pi job on the card, cold then warm: every map on the
    device runner (NLineInputFormat has no read_batch, so no window), one
    count per map (pi.count_inside) and one device-to-host fetch per map;
    the total exact, the estimate within PI_SIGMAS sigma, the second run's
    count equal to the first's. Then the same job on the CPU batch runner
    (numpy), and one PI_SAMPLES block timed with CUDA events beside its
    bytes bound (the draws written and read once)."""
    from tpumr_torch.core.counters import BackendCounter
    from tpumr_torch.device import DEVICE_KEY
    from tpumr_torch.mapred.local_runner import run_job
    from tpumr_torch.ops import pi, registry

    with open(os.path.join(work, "seeds.txt"), "w") as f:
        f.write("".join(f"{m} {PI_SAMPLES}\n" for m in range(PI_MAPS)))
    real_fetch = registry.fetch_to_host
    fetches = []

    def counted_fetch(states):
        fetches.append(len(states))
        return real_fetch(states)

    def conf_for(out: str):
        conf = text_conf(work, "seeds.txt", out, "NLineInputFormat",
                         "pi-sampler", combine=False)
        conf.set("mapred.line.input.format.linespermap", 1)
        return conf

    rows, counts = [], []
    registry.fetch_to_host = counted_fetch
    try:
        for kind in ("cold", "warm"):
            conf = conf_for(f"pi-{kind}")
            conf.set("tpumr.local.run.on.tpu", True)
            fetches.clear()
            pi.count_inside.launches = 0     # this run's count starts
            t = time.monotonic()
            result = run_job(conf)
            secs = time.monotonic() - t
            check(result.successful, f"pi {kind} job failed")
            got = read_pairs(os.path.join(work, f"pi-{kind}", "part-00000"))
            row = {"kind": kind, "seconds": secs, "maps": result.num_maps,
                   "inside": got["inside"], "total": got["total"],
                   "fetches": len(fetches),
                   "blocks": pi.count_inside.launches,
                   "counters": job_counters(result)}
            row["estimate"] = check_pi(f"pi {kind}", got["inside"],
                                       got["total"])
            log("text_pi " + json.dumps(row))
            check(got["total"] == PI_MAPS * PI_SAMPLES,
                  f"pi {kind}: total {got['total']}")
            check(result.num_maps == PI_MAPS and
                  row["counters"][BackendCounter.TPU_MAP_TASKS] == PI_MAPS,
                  f"pi {kind}: {row['counters']} for {PI_MAPS} maps")
            check(row["fetches"] == PI_MAPS and row["blocks"] == PI_MAPS,
                  f"pi {kind}: {row['fetches']} fetches and {row['blocks']} "
                  f"blocks counted for {PI_MAPS} maps")
            rows.append(row)
            counts.append(got["inside"])
    finally:
        registry.fetch_to_host = real_fetch
    check(counts[0] == counts[1], f"pi: the warm run counted {counts[1]}, "
          f"the cold run {counts[0]}")

    conf = conf_for("pi-cpu")
    conf.set(DEVICE_KEY, "cpu")                  # the numpy batch maps
    conf.set("tpumr.local.run.on.tpu", False)
    t = time.monotonic()
    result = run_job(conf)
    cpu_secs = time.monotonic() - t
    check(result.successful, "pi CPU batch job failed")
    got = read_pairs(os.path.join(work, "pi-cpu", "part-00000"))
    cpu = {"seconds": cpu_secs, "inside": got["inside"],
           "total": got["total"], "counters": job_counters(result),
           "estimate": check_pi("pi CPU batch", got["inside"], got["total"])}
    log("text_pi_cpu " + json.dumps(cpu))
    check(got["total"] == PI_MAPS * PI_SAMPLES and
          cpu["counters"][BackendCounter.CPU_BATCH_MAP_TASKS] == PI_MAPS,
          f"pi CPU batch: {cpu}")

    dev = torch.device("cuda", 0)
    block = {"samples": PI_SAMPLES,
             "ms": time_ms(lambda: pi.count_inside(0, PI_SAMPLES, dev),
                           iters=10),
             "bound_ms": 16 * PI_SAMPLES / PEAK_BYTES_PER_S * 1e3,
             "bound_by": "bytes"}
    log("text_pi_block " + json.dumps(block))
    return {"jobs": rows, "cpu": cpu, "block": block}


def pi_cli_phase() -> dict:
    """python -m tpumr_torch.cli examples pi in a process of its own (its
    default mem:// work dir): the printed estimate within PI_SIGMAS sigma."""
    cmd = [sys.executable, "-m", "tpumr_torch.cli", "examples", "pi",
           str(PI_CLI_MAPS), str(PI_CLI_SAMPLES)]
    t = time.monotonic()
    proc = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(
        __file__)), capture_output=True, text=True, timeout=600)
    secs = time.monotonic() - t
    check(proc.returncode == 0, f"examples pi exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("Estimated value of Pi is ")]
    check(len(lines) == 1, f"examples pi printed {proc.stdout[-500:]!r}")
    est = float(lines[0].rsplit(" ", 1)[1])
    total = PI_CLI_MAPS * PI_CLI_SAMPLES
    check(abs(est - np.pi) <= PI_SIGMAS * pi_sigma(total),
          f"examples pi: estimate {est} is over {PI_SIGMAS} sigma off pi")
    row = {"seconds": secs, "estimate": est, "samples": total}
    log("text_pi_cli " + json.dumps(row))
    return row


def write_text(work: str) -> bytes:
    """bench.py:572-582's text, byte for byte: WC_MB MiB of lines of 12 of
    WC_WORDS words from default_rng(1), no final newline."""
    words = [f"word{i:04d}".encode() for i in range(WC_WORDS)]
    rng = np.random.default_rng(1)
    line = b" ".join(words[i] for i in rng.integers(0, WC_WORDS, 12)) + b"\n"
    reps = WC_MB * 1024 * 1024 // len(line)
    idx = rng.integers(0, WC_WORDS, size=(reps, 12))
    data = b"\n".join(b" ".join(words[j] for j in r) for r in idx)
    with open(os.path.join(work, "text.txt"), "wb") as f:
        f.write(data)
    return data


def text_splits(size: int, block: int = 64 << 20) -> int:
    """Splits of one local file of ``size`` bytes and one map hint: blocks
    of 64 MiB, a tail under 1.1 blocks riding with the last."""
    n, rest = 1, size
    while rest / block > 1.1:
        n, rest = n + 1, rest - block
    return n


def text_jobs_phase(work: str) -> dict:
    """The wordcount kernel over the text's RawTextInputFormat splits and
    the grep kernel over its TextInputFormat splits, on the card's device
    runner (host kernels: one by one, no window), each part file against an
    oracle over the whole file: collections.Counter(data.split()), and
    re.finditer line by line."""
    import re
    from collections import Counter

    from tpumr_torch.core.counters import BackendCounter
    from tpumr_torch.mapred.local_runner import run_job
    t = time.monotonic()
    data = write_text(work)
    log(f"data: {len(data)} bytes of text written in "
        f"{time.monotonic() - t:.3f}s")
    rows = {}
    for label, fmt in (("wordcount", "RawTextInputFormat"),
                       ("grep", "TextInputFormat")):
        conf = text_conf(work, "text.txt", f"{label}-out", fmt, label)
        conf.set("tpumr.grep.pattern", GREP_PATTERN)
        t = time.monotonic()
        result = run_job(conf)
        secs = time.monotonic() - t
        check(result.successful, f"{label} job failed")
        got = read_pairs(os.path.join(work, f"{label}-out", "part-00000"))
        t = time.monotonic()
        if label == "wordcount":
            want = {w.decode(): c for w, c in Counter(data.split()).items()}
        else:
            regex = re.compile(GREP_PATTERN.encode())
            want = Counter()
            for text_line in data.split(b"\n"):
                for m in regex.finditer(text_line):
                    want[m.group(0).decode()] += 1
        row = {"seconds": secs, "mb_per_s": len(data) / secs / 1e6,
               "bytes": len(data), "maps": result.num_maps,
               "distinct": len(got), "records": sum(got.values()),
               "oracle_seconds": time.monotonic() - t,
               "counters": job_counters(result)}
        log(f"text_{label} " + json.dumps(row))
        check(got == dict(want), f"{label}: the part file differs from the "
              f"oracle ({len(got)} keys, {len(want)} expected)")
        check(result.num_maps == text_splits(len(data)) and
              row["counters"][BackendCounter.TPU_MAP_TASKS]
              == result.num_maps, f"{label}: {result.num_maps} maps, "
              f"{row['counters']}")
        rows[label] = row
    return rows


def text_phase() -> dict:
    """pi on the card, then wordcount and grep over 200 MB with the CLI's
    pi beside them."""
    work = tempfile.mkdtemp(prefix="tpumr_torch-text-")
    try:
        out = pi_phase(work)
        # the CLI's pi, a process of its own, beside wordcount and grep
        beside = Beside(pi_cli_phase)
        try:
            out |= text_jobs_phase(work)
        finally:
            out["cli"] = beside.join()
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


#: the spill phase. Per-record wordcount: the first SPILL_WC_MB MiB split of
#: the text phase's text (its lines, whole) at io.sort.mb SPILL_WC_SORT_MB
#: and io.sort.spill.percent 0.8, 2 reduces. Hadoop's Sort benchmark pair:
#: randomwriter's SORT_GEN_MAPS maps of SORT_BYTES_PER_MAP bytes (upstream
#: writes 1 GB a map), then sort --total-order in 64 MiB splits with
#: SORT_REDUCES reduces at io.sort.mb SORT_IO_SORT_MB
SPILL_WC_MB, SPILL_WC_SORT_MB = 64, 100
SORT_GEN_MAPS, SORT_BYTES_PER_MAP = 6, 128 << 20
SORT_REDUCES, SORT_IO_SORT_MB = 2, 32
#: secondarysort's and join's seeded inputs: firsts x seconds, and keys of
#: each side (of JOIN_KEYS distinct)
SS_FIRSTS, SS_SECONDS = 50, 200
JOIN_LEFT, JOIN_RIGHT, JOIN_KEYS = 2_000, 1_500, 500


class SpillCount:
    """Spills per map task in a ``with`` block: MapOutputBuffer.sort_and_
    spill wrapped to count the calls that write a file, by the task's
    local dir."""

    def __enter__(self) -> "SpillCount":
        from tpumr_torch.mapred.map_task import MapOutputBuffer
        self.by_task: dict = {}
        self._cls = MapOutputBuffer
        self._real = real = MapOutputBuffer.sort_and_spill
        by_task = self.by_task

        def counted(buf) -> None:
            if buf._buf:
                by_task[buf.local_dir] = by_task.get(buf.local_dir, 0) + 1
            real(buf)

        MapOutputBuffer.sort_and_spill = counted
        return self

    def __exit__(self, *exc) -> None:
        self._cls.sort_and_spill = self._real


def spill_counters(result) -> dict:
    from tpumr_torch.core.counters import TaskCounter
    return {name: result.counters.value(TaskCounter.FRAMEWORK_GROUP, name)
            for name in (TaskCounter.MAP_OUTPUT_RECORDS,
                         TaskCounter.SPILLED_RECORDS,
                         TaskCounter.MERGE_PASSES,
                         TaskCounter.MERGE_PASS_SEGMENTS,
                         TaskCounter.COMBINE_INPUT_RECORDS,
                         TaskCounter.COMBINE_OUTPUT_RECORDS,
                         TaskCounter.REDUCE_INPUT_RECORDS,
                         TaskCounter.REDUCE_OUTPUT_RECORDS)}


def spill_job(label: str, conf, spills: SpillCount) -> tuple:
    """Run one job on the card's default device; print its JSON line."""
    from tpumr_torch.mapred.local_runner import run_job
    with RssPeak() as rss:
        t = time.monotonic()
        result = run_job(conf)
        secs = time.monotonic() - t
    check(result.successful, f"spill {label} job failed")
    row = {"spill_job": label, "seconds": secs, "maps": result.num_maps,
           "reduces": result.num_reduces, "map_s": result.map_seconds,
           "reduce_s": result.reduce_seconds,
           "spills_per_map": sorted(spills.by_task.values()),
           "rss_start_gb": rss.start / 1e9,
           "peak_rss_gb": rss.peak / 1e9} | spill_counters(result)
    log(json.dumps(row))
    return result, row


def per_record_wordcount(work: str) -> dict:
    """WordCountCpuMapper over TextInputFormat (one record per word) on the
    text phase's first 64 MiB split, LongSumReducer as combiner and
    reducer, 2 reduces, io.sort.mb 100 and io.sort.spill.percent 0.8: each
    map spills at least 3 times as the buffer reckons its bytes
    (len(k) + len(v) + 16 a record against the threshold) and merges. The
    counts must equal collections.Counter over the same bytes."""
    from collections import Counter

    from tpumr_torch.io.writable import serialize
    from tpumr_torch.mapred.jobconf import JobConf
    data = write_text(work)
    cut = data.index(b"\n", SPILL_WC_MB * 1024 * 1024 - 1)
    data = data[:cut]
    with open(os.path.join(work, "wc.txt"), "wb") as f:
        f.write(data)
    conf = JobConf()
    conf.set_input_paths(f"file://{work}/wc.txt")
    conf.set_output_path(f"file://{work}/wc-out")
    conf.set("mapred.mapper.class",
             "tpumr_torch.ops.wordcount.WordCountCpuMapper")
    conf.set("mapred.reducer.class",
             "tpumr_torch.examples.basic.LongSumReducer")
    conf.set("mapred.combiner.class",
             "tpumr_torch.examples.basic.LongSumReducer")
    conf.set("io.sort.mb", SPILL_WC_SORT_MB)
    conf.set("io.sort.spill.percent", 0.8)
    conf.set_num_reduce_tasks(2)
    with SpillCount() as spills:
        result, row = spill_job("per_record_wordcount", conf, spills)
    row["mb_per_s"] = len(data) / row["seconds"] / 1e6
    row["bytes"] = len(data)
    got = {}
    for r in range(2):
        got |= read_pairs(os.path.join(work, "wc-out", f"part-{r:05d}"))
    want = Counter(data.split())
    check(got == {w.decode(): c for w, c in want.items()},
          f"per-record wordcount: the counts differ from the oracle "
          f"({len(got)} words, {len(want)} expected)")
    # every word of the text is 8 bytes, so every record counts the same
    rec = len(serialize(next(iter(want)))) + len(serialize(1)) + 16
    threshold = int(SPILL_WC_SORT_MB * 1024 * 1024 * 0.8)
    per_spill = -(-threshold // rec)
    n = sum(want.values())
    reckoned = n // per_spill + (1 if n % per_spill else 0)
    row["spills_reckoned"] = reckoned
    log("spill_wordcount_check " + json.dumps(
        {"records": n, "record_bytes": rec, "threshold": threshold,
         "spills_reckoned": reckoned, "spills": row["spills_per_map"]}))
    check(result.num_maps == 1 and row["spills_per_map"] == [reckoned]
          and reckoned >= 3, f"per-record wordcount: spills "
          f"{row['spills_per_map']}, reckoned {reckoned}, want >= 3")
    check(row["COMBINE_INPUT_RECORDS"] >= row["MAP_OUTPUT_RECORDS"] == n,
          f"per-record wordcount: counters {row}")
    return row


def seq_records_checksum(path: str, inputs: bool = False) -> dict:
    """The record count and an order-independent checksum (the sums,
    mod 2**64, of two 64-bit blake2b digests of each serialized record) of
    every part of a SequenceFile directory; for output parts, whether the
    keys are non-decreasing across the parts in order."""
    import hashlib

    from tpumr_torch.io import sequencefile
    from tpumr_torch.io.writable import deserialize
    count, s1, s2, prev, ordered = 0, 0, 0, None, True
    names = sorted(n for n in os.listdir(path) if n.startswith("part-"))
    for name in names:
        with open(os.path.join(path, name), "rb") as f:
            for kb, vb in sequencefile.Reader(f).iter_raw():
                h = hashlib.blake2b(kb + b"\x00" + vb, digest_size=16,
                                    key=len(kb).to_bytes(4, "little"))
                d = h.digest()
                s1 = (s1 + int.from_bytes(d[:8], "little")) & (2**64 - 1)
                s2 = (s2 + int.from_bytes(d[8:], "little")) & (2**64 - 1)
                count += 1
                if not inputs:
                    key = deserialize(kb)
                    ordered &= prev is None or prev <= key
                    prev = key
    out = {"records": count, "sum1": s1, "sum2": s2}
    if not inputs:
        out["keys_non_decreasing"] = bool(ordered)
    return out


def sort_benchmark(work: str) -> dict:
    """Hadoop's Sort benchmark pair through the port: examples randomwriter
    (SORT_GEN_MAPS maps of SORT_BYTES_PER_MAP bytes, map-only), then
    examples sort --total-order over its SequenceFiles (64 MiB splits,
    SORT_REDUCES reduces, io.sort.mb SORT_IO_SORT_MB, io.sort.factor 10):
    each map spills about 3 times and merges, each reduce merges one
    segment a map in an intermediate pass and a final one. The output's
    records equal the input's (count and checksum) and its keys never
    decrease across the parts in order."""
    from tpumr_torch.examples import random_writer, sort
    data, out = f"{work}/rw", f"{work}/sorted"
    t = time.monotonic()
    check(random_writer.randomwriter(
        [f"file://{data}", "-m", str(SORT_GEN_MAPS), "--bytes-per-map",
         str(SORT_BYTES_PER_MAP)]) == 0, "randomwriter failed")
    gen_s = time.monotonic() - t
    size = sum(os.path.getsize(os.path.join(data, n))
               for n in os.listdir(data) if n.startswith("part-"))
    log("spill_randomwriter " + json.dumps(
        {"seconds": gen_s, "maps": SORT_GEN_MAPS, "bytes": size}))
    results = []
    real_run_job = sort.run_job
    sort.run_job = lambda conf: results.append(
        spill_job("sort", conf, spills)[0]) or results[-1]
    try:
        with SpillCount() as spills:
            t = time.monotonic()
            rc = sort.sort([f"file://{data}", f"file://{out}", "-r",
                            str(SORT_REDUCES), "--total-order",
                            "-D", f"io.sort.mb={SORT_IO_SORT_MB}"])
            prog_s = time.monotonic() - t
    finally:
        sort.run_job = real_run_job
    check(rc == 0 and len(results) == 1, "examples sort failed")
    result = results[0]
    c = spill_counters(result)
    t = time.monotonic()
    sums_in = seq_records_checksum(data, inputs=True)
    sums_out = seq_records_checksum(out)
    row = {"program_s": prog_s, "input_bytes": size,
           "checksum_s": time.monotonic() - t, "input": sums_in,
           "output": sums_out, "MERGE_PASSES": c["MERGE_PASSES"]}
    log("spill_sort_check " + json.dumps(row))
    check(c["MERGE_PASSES"] >= 2, f"sort: {c['MERGE_PASSES']} merge passes")
    check(sums_out.pop("keys_non_decreasing"), "sort: keys decrease "
          "across the parts in order")
    check(sums_in == sums_out and sums_out["records"] ==
          c["MAP_OUTPUT_RECORDS"], "sort: the output's records are not the "
          "input's")
    return {"randomwriter_s": gen_s, "sort_s": prog_s} | row


def cli_example(args: "list[str]") -> float:
    t = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "tpumr_torch.cli", "examples"] + args,
        cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"examples {args[0]} exited "
          f"{proc.returncode}: {proc.stderr[-2000:]}")
    return time.monotonic() - t


def read_text_parts(path: str) -> "list[str]":
    lines = []
    for name in sorted(os.listdir(path)):
        if name.startswith("part-"):
            with open(os.path.join(path, name)) as f:
                lines.extend(f.read().splitlines())
    return lines


def secondarysort_and_join(work: str) -> dict:
    """examples secondarysort and examples join (inner and outer) through
    python -m tpumr_torch.cli, each in a process of its own, on inputs
    from default_rng(9), against oracles computed here: one line per first
    with its seconds ascending; the cross product of each key's left and
    right payloads in input order."""
    rng = np.random.default_rng(9)
    pairs = [(f, int(s)) for f in range(SS_FIRSTS)
             for s in rng.permutation(SS_SECONDS)]
    order = rng.permutation(len(pairs))
    with open(f"{work}/ss.txt", "w") as f:
        f.write("".join(f"{pairs[i][0]} {pairs[i][1]}\n" for i in order))
    secs = {"secondarysort": cli_example(
        ["secondarysort", f"file://{work}/ss.txt", f"file://{work}/ss-out",
         "-r", "2"])}
    got = sorted(read_text_parts(f"{work}/ss-out"))
    want = sorted(f"{f}\t{list(range(SS_SECONDS))}"
                  for f in range(SS_FIRSTS))
    check(got == want, f"secondarysort: {len(got)} lines differ from the "
          "oracle")
    sides = {}
    for side, n in (("L", JOIN_LEFT), ("R", JOIN_RIGHT)):
        keys = rng.integers(0, JOIN_KEYS, size=n)
        sides[side] = [(f"k{int(k):04d}", f"{side.lower()}{i}")
                       for i, k in enumerate(keys)]
        with open(f"{work}/{side}.txt", "w") as f:
            f.write("".join(f"{k}\t{side}|{p}\n" for k, p in sides[side]))
    for outer in (False, True):
        name = "join-outer" if outer else "join"
        secs[name] = cli_example(
            ["join", f"file://{work}/L.txt", f"file://{work}/R.txt",
             f"file://{work}/{name}"] + (["--outer"] if outer else []))
        by_key: dict = {}
        for side in ("L", "R"):
            for k, p in sides[side]:
                by_key.setdefault(k, ({"L": [], "R": []}))[side].append(p)
        want = []
        for k, lr in by_key.items():
            lefts, rights = lr["L"], lr["R"]
            if outer:
                lefts, rights = lefts or [""], rights or [""]
            want.extend(f"{k}\t{lp}\t{rp}" for lp in lefts for rp in rights)
        got = read_text_parts(f"{work}/{name}")
        check(sorted(got) == sorted(want), f"{name}: {len(got)} lines, the "
              f"oracle {len(want)}")
        secs[f"{name}_lines"] = len(got)
    log("spill_examples " + json.dumps(secs))
    return secs


def spill_phase() -> dict:
    """The host shuffle's spills and merges on the card's machine, under
    the default cuda device and launching no kernel: the per-record
    wordcount at io.sort.mb 100 (at least 3 spills), randomwriter then
    sort --total-order (Hadoop's Sort benchmark pair, upstream 1 GB a map
    cut to 128 MiB a map: 6 maps, about 768 MiB), and secondarysort and
    join through the CLI (beside the first two). Each job prints one JSON
    line: its seconds,
    maps, reduces, spills per map, merge, spill and combine counters and
    peak RSS."""
    t_phase = time.monotonic()
    work = tempfile.mkdtemp(prefix="tpumr_torch-spill-")
    try:
        # the CLI's programs, processes of their own, beside the jobs here
        beside = Beside(secondarysort_and_join, work)
        try:
            out = {"wordcount": per_record_wordcount(work)}
            out["sort"] = sort_benchmark(work)
        finally:
            examples = beside.join()
        out["examples"] = examples
        out["seconds"] = time.monotonic() - t_phase
        log("spill_phase " + json.dumps({"seconds": out["seconds"]}))
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


#: BASELINE.json config 5, "TeraSort 10GB": 10^8 records of 100 bytes,
#: generated by 16 maps and sorted into 4 ranges (bench.py:749-752)
TERA_ROWS = 100_000_000
TERA_MAPS = 16
TERA_REDUCES = 4
#: bench.py:727's terasort_host_job_s / terasort_device_job_s size, its
#: teragen's 4 maps; and the CLI's size
TERA_BENCH_ROWS = 2_000_000
TERA_BENCH_MAPS = 4
TERA_CLI_ROWS = 1_000_000
#: the keys whose card permutation must equal np.lexsort's exactly
TERA_LEXSORT_ROWS = 10_000_000
#: scratch the phase needs at once: the input, the dense map outputs and
#: one sorted output (about 10.6, 10.0 and 10.6 GB at 10^8 rows)
TERA_DISK_BYTES_PER_ROW = 340
#: rows a checksum pass moves to the card at a time
CHECKSUM_ROWS = 10_000_000
#: the cluster_shuffle phase's mini cluster: one runner of TERA_CLUSTER_CPU
#: CPU map slots, one GPU map slot and one reduce slot
TERA_CLUSTER_CPU = 4
#: (b)'s second host-shuffle run: records, teragen maps, and an in-memory
#: shuffle budget (tpumr.shuffle.ram.mb) and merge factor small enough that
#: every segment (about 0.66 MB raw) goes to disk and the disk segments
#: merge in the background during the copy
TERA_SPILL_ROWS, TERA_SPILL_MAPS = 200_000, 8
TERA_SPILL_RAM_MB, TERA_SPILL_FACTOR = 2.0, 4


class RssPeak:
    """The process's resident set at the start of a ``with`` block and its
    peak over it, sampled from /proc/self/statm every 20 ms (getrusage's
    ru_maxrss is the whole process's lifetime peak, which earlier phases
    may have set; clear_refs, which would reset it, is refused there)."""

    def __enter__(self) -> "RssPeak":
        import threading
        self.peak = 0
        self._stop = threading.Event()
        self._page = os.sysconf("SC_PAGE_SIZE")
        self._sample()
        self.start = self.peak
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _sample(self) -> None:
        with open("/proc/self/statm") as f:
            self.peak = max(self.peak, int(f.read().split()[1]) * self._page)

    def _run(self) -> None:
        while not self._stop.wait(0.02):
            self._sample()

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()
        self._sample()


def ru_maxrss_gb() -> float:
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def seq_files(path: str) -> list:
    return sorted(os.path.join(path, n) for n in os.listdir(path)
                  if n.startswith("part-"))


def read_seq_batch(path: str):
    """A whole SequenceFile as (keys [n, 10], values [n, 90]) uint8."""
    from tpumr_torch.io import sequencefile
    with open(path, "rb") as f:
        b = sequencefile.Reader(f).read_batch_range(0, os.path.getsize(path))
    n = b.num_records
    return b.key_data.reshape(n, -1), b.value_data.reshape(n, -1)


def rows_checksum(path: str, keep_keys: bool = False,
                  per_part: bool = False) -> dict:
    """The record count and an order-independent checksum of every
    100-byte row of a SequenceFile directory, computed on the card: each
    row's 25 little-endian int32 words weighted by two fixed int64 vectors
    (w1, w2) give h1, h2; the sums of h1 and of h1 * h2 wrap in int64.
    With ``keep_keys`` also the keys [n, 10] in file order; with
    ``per_part`` the record count of each part file (``part_records``)."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(20260817)
    w = torch.randint(1, 2 ** 31 - 1, (2, 25), generator=gen,
                      dtype=torch.int64).to(dev)
    s1 = torch.zeros((), dtype=torch.int64, device=dev)
    s2 = torch.zeros((), dtype=torch.int64, device=dev)
    count, keys, part_records = 0, [], []
    for part in seq_files(path):
        k, v = read_seq_batch(part)
        part_records.append(int(k.shape[0]))
        if keep_keys:
            keys.append(np.ascontiguousarray(k))
        for lo in range(0, k.shape[0], CHECKSUM_ROWS):
            rows = torch.cat([torch.from_numpy(k[lo:lo + CHECKSUM_ROWS]),
                              torch.from_numpy(v[lo:lo + CHECKSUM_ROWS])],
                             1).to(dev)
            words = rows.view(torch.int32).to(torch.int64)
            h1 = (words * w[0]).sum(1)
            h2 = (words * w[1]).sum(1)
            s1 += h1.sum()
            s2 += (h1 * h2).sum()
        count += k.shape[0]
        del k, v
    out = {"records": count, "sum_h1": int(s1), "sum_h1h2": int(s2)}
    if per_part:
        out["part_records"] = part_records
    if keep_keys:
        out["keys"] = np.concatenate(keys) if keys else \
            np.zeros((0, 10), np.uint8)
    return out


def check_stable_sort(kcols: np.ndarray, n_lexsort: int) -> dict:
    """The card's permutation of ``kcols`` (device_sort.device_partition_
    sort, the gang reduce's sort): a permutation, keys non-decreasing
    along it, indices increasing within runs of equal keys; on the first
    ``n_lexsort`` keys equal to np.lexsort's."""
    from tpumr_torch.parallel.device_sort import device_partition_sort
    dev = torch.device("cuda")
    n = kcols.shape[0]
    stages = {}
    order, cols = device_partition_sort(kcols, dev, stages)
    perm = torch.from_numpy(order).to(dev)
    check(perm.shape[0] == n and int(perm.min()) == 0
          and int(perm.max()) == n - 1, "device sort: indices out of range")
    seen = torch.zeros(n, dtype=torch.bool, device=dev)
    seen[perm] = True
    check(bool(seen.all()), "device sort: not a permutation")
    del seen
    s = cols[perm]
    del cols
    gt = torch.zeros(n - 1, dtype=torch.bool, device=dev)
    eq = torch.ones(n - 1, dtype=torch.bool, device=dev)
    for c in range(s.shape[1]):
        a, b = s[:-1, c], s[1:, c]
        gt |= eq & (a > b)
        eq &= a == b
    check(not bool(gt.any()), "device sort: keys decrease along the "
          "permutation")
    check(not bool((eq & (perm[1:] < perm[:-1])).any()),
          "device sort: equal keys out of input order")
    equal_pairs = int(eq.sum())
    del s, gt, eq, perm
    t = time.monotonic()
    small = kcols[:n_lexsort]
    want = np.lexsort(tuple(small[:, c] for c in
                            range(small.shape[1] - 1, -1, -1)))
    lexsort_s = time.monotonic() - t
    got, _ = device_partition_sort(small, dev)
    check(np.array_equal(got, want), f"device sort: the first {n_lexsort} "
          "keys' permutation differs from np.lexsort's")
    row = {"keys": n, "equal_adjacent_keys": equal_pairs,
           "lexsort_keys": n_lexsort, "np_lexsort_s": lexsort_s,
           "argsort_device_ms": stages.get("argsort_device_ms")}
    log("terasort_sort_check " + json.dumps(row))
    return row


def tera_run(label: str, gen: str, out: str, rows: int,
             device_shuffle: bool = True) -> dict:
    """One terasort job through the port (make_terasort_conf, the local
    runner) with TERA_REDUCES ranges: its stage seconds, peak host and
    device memory and counters, printed as one JSON line."""
    from tpumr_torch.core.counters import BackendCounter
    from tpumr_torch.examples.terasort import make_terasort_conf
    from tpumr_torch.mapred.local_runner import run_job
    torch.cuda.reset_peak_memory_stats()
    with RssPeak() as rss:
        t = time.monotonic()
        conf = make_terasort_conf(f"file://{gen}", f"file://{out}",
                                  TERA_REDUCES, device_shuffle)
        conf_s = time.monotonic() - t
        t = time.monotonic()   # bench.py times run_job alone
        result = run_job(conf)
        job_s = time.monotonic() - t
    row = {"terasort_run": label, "records": rows,
           "device_shuffle": device_shuffle, "conf_s": conf_s,
           "job_s": job_s, "maps": result.num_maps, "map_s": result.map_seconds,
           "reduce_s": result.reduce_seconds} | result.reduce_stages | {
        "rss_start_gb": rss.start / 1e9, "peak_rss_gb": rss.peak / 1e9,
        "ru_maxrss_gb": ru_maxrss_gb(),
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    for name in ("TPU_SHUFFLE_RECORDS", "DEVICE_SORT_ON_ACCEL",
                 "SHUFFLE_HOST_FALLBACKS"):
        row[name] = result.counters.value(BackendCounter.GROUP, name)
    log(json.dumps(row))
    check(result.successful, f"terasort {label} failed")
    if device_shuffle:
        check(row["TPU_SHUFFLE_RECORDS"] == rows,
              f"terasort {label}: TPU_SHUFFLE_RECORDS "
              f"{row['TPU_SHUFFLE_RECORDS']} != {rows}")
        check(row["DEVICE_SORT_ON_ACCEL"] == 1,
              f"terasort {label}: the sort did not run on the card")
    check(len(seq_files(out)) == TERA_REDUCES,
          f"terasort {label}: {len(seq_files(out))} part files")
    return row


def teragen(out: str, rows: int, maps: int) -> float:
    from tpumr_torch.examples import terasort
    t = time.monotonic()
    check(terasort.teragen([str(rows), f"file://{out}", "-m", str(maps)])
          == 0, "teragen failed")
    secs = time.monotonic() - t
    log(f"terasort_teragen {json.dumps({'records': rows, 'maps': maps, 'seconds': secs})}")
    return secs


class ExampleProcess:
    """``python -m tpumr_torch.cli examples ARGS`` started at once in a
    process of its own, so that it runs beside this process's host work
    (each process has its interpreter lock). :meth:`finish` waits for it,
    logs one ``label`` line with its seconds (its start included) and
    checks that it exited 0 and printed ``expect``; :meth:`stop` kills it.
    As a context manager it finishes on a clean exit and stops otherwise.
    """

    def __init__(self, label: str, args: list, expect: str = "",
                 row: "dict | None" = None) -> None:
        self.label, self.args, self.expect = label, args, expect
        self.row = row or {}
        self.t = time.monotonic()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "tpumr_torch.cli", "examples"] + args,
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def finish(self) -> float:
        try:
            printed, err = self.proc.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            self.stop()
            fail(f"examples {' '.join(self.args)}: no end in 900 s")
        secs = time.monotonic() - self.t
        log(f"{self.label} " + json.dumps(self.row | {
            "rc": self.proc.returncode, "seconds": secs, "process": True,
            "printed": printed.strip()[-500:]}))
        check(self.proc.returncode == 0 and self.expect in printed
              and "FAILED" not in printed,
              f"examples {self.args[0]}: rc {self.proc.returncode}, "
              f"{printed[-500:]!r} {err[-2000:]!r}")
        return secs

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()

    def __enter__(self) -> "ExampleProcess":
        return self

    def __exit__(self, *exc) -> None:
        if exc[0] is None:
            self.finish()
        else:
            self.stop()


def teravalidate_process(out: str, report: str) -> ExampleProcess:
    return ExampleProcess("terasort_validate",
                          ["teravalidate", f"file://{out}",
                           f"file://{report}"],
                          expect="Output is globally sorted.")


def same_parts(a: str, b: str, what: str = "host and device shuffles"
               ) -> int:
    """Two output dirs hold the same record sequences, part for part."""
    pa, pb = seq_files(a), seq_files(b)
    check([os.path.basename(p) for p in pa] ==
          [os.path.basename(p) for p in pb], f"part files differ: {pa} {pb}")
    total = 0
    for x, y in zip(pa, pb):
        (kx, vx), (ky, vy) = read_seq_batch(x), read_seq_batch(y)
        check(np.array_equal(kx, ky) and np.array_equal(vx, vy),
              f"{os.path.basename(x)}: {what} differ")
        total += kx.shape[0]
    return total


def tera_cli_programs(work: str) -> list:
    """teragen, terasort --device-shuffle and teravalidate through
    python -m tpumr_torch.cli, each in a process of its own, one after
    another; their seconds."""
    base = f"file://{work}/cli"
    cmds = [["teragen", str(TERA_CLI_ROWS), f"{base}-gen", "-m", "4"],
            ["terasort", f"{base}-gen", f"{base}-out", "-r",
             str(TERA_REDUCES), "--device-shuffle"],
            ["teravalidate", f"{base}-out", f"{base}-report"]]
    secs = []
    for cmd in cmds:
        t = time.monotonic()
        proc = subprocess.run(
            [sys.executable, "-m", "tpumr_torch.cli", "examples"] + cmd,
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=600)
        secs.append(time.monotonic() - t)
        check(proc.returncode == 0, f"examples {cmd[0]} exited "
              f"{proc.returncode}: {proc.stderr[-2000:]}")
    check("Output is globally sorted." in proc.stdout,
          f"examples teravalidate printed {proc.stdout[-500:]!r}")
    return secs


def tera_cli(work: str, secs: list) -> dict:
    """The CLI's output against its input: the same records."""
    sums = rows_checksum(f"{work}/cli-out")
    check(sums == rows_checksum(f"{work}/cli-gen") and
          sums["records"] == TERA_CLI_ROWS, "examples terasort lost or "
          "changed records")
    row = {"records": TERA_CLI_ROWS, "teragen_s": secs[0],
           "terasort_s": secs[1], "teravalidate_s": secs[2]}
    log("terasort_cli " + json.dumps(row))
    return row


def tera_cluster():
    """The cluster_shuffle phase's MiniMRCluster: one node runner with
    TERA_CLUSTER_CPU CPU map slots, one GPU map slot and one reduce slot,
    on the card."""
    from tpumr_torch.mapred.jobconf import JobConf
    from tpumr_torch.mapred.mini_cluster import MiniMRCluster
    base = JobConf()
    base.set("mapred.tasktracker.reduce.tasks.maximum", 1)
    return MiniMRCluster(num_trackers=1, cpu_slots=TERA_CLUSTER_CPU,
                         tpu_slots=1, conf=base)


def on_cluster(conf, c):
    """``conf`` submitted to the cluster ``c``: its keys that the job
    does not set."""
    for k, v in c.create_job_conf():
        if conf.get(k) is None:
            conf.set(k, v)
    return conf


def task_span_s(reports: list) -> float:
    """First start to last finish of a job's tasks of one kind."""
    return (max(r["finish_time"] for r in reports)
            - min(r["start_time"] for r in reports))


def cluster_terasort(c, work: str, gen: str, rows: int, sums_in: dict,
                     local_parts: list, local_fetch_s: float) -> dict:
    """cluster_shuffle (a): BASELINE config 5 on the cluster. The
    device-shuffled terasort of ``gen`` (TERA_REDUCES ranges) sent through
    job_client.run_job to the cluster's master: the maps on the CPU slots,
    every dense map output fetched over RPC by the gang reduce on the
    runner (slow start 1.0, so that the fetch starts after the last map and
    its seconds compare with the local run's), sorted on the card. One
    cluster_terasort line: job and map seconds, the gang reduce's stages,
    the dense bytes fetched, peak RSS and card memory. Checks: success,
    TPU_SHUFFLE_RECORDS = rows, DEVICE_SORT_ON_ACCEL = 1, one device
    argsort, the local run's record count in each part, the input's
    checksum, teravalidate."""
    from tpumr_torch.core.counters import BackendCounter
    from tpumr_torch.examples.terasort import make_terasort_conf
    from tpumr_torch.mapred import device_shuffle, job_client
    from tpumr_torch.parallel.device_sort import argsort_keys
    out_dir = f"{work}/out-cluster"
    conf = on_cluster(make_terasort_conf(
        f"file://{gen}", f"file://{out_dir}", TERA_REDUCES, True), c)
    conf.set("mapred.reduce.slowstart.completed.maps", 1.0)
    stages, fetched = {}, [0, 0]
    run_reduce = device_shuffle.run_device_reduce
    parse = device_shuffle.parse_dense_bytes

    def recorded_reduce(*args, **kwargs):
        stages.update(run_reduce(*args, **kwargs))
        return stages

    def counted_parse(data):
        fetched[0] += len(data)
        fetched[1] += 1
        return parse(data)

    launches = argsort_keys.launches
    torch.cuda.reset_peak_memory_stats()
    device_shuffle.run_device_reduce = recorded_reduce
    device_shuffle.parse_dense_bytes = counted_parse
    try:
        with RssPeak() as rss:
            t = time.monotonic()
            result = job_client.run_job(conf)
            job_s = time.monotonic() - t
    finally:
        device_shuffle.run_device_reduce = run_reduce
        device_shuffle.parse_dense_bytes = parse
    maps = c.master.get_task_reports(str(result.job_id), "map")
    reduces = c.master.get_task_reports(str(result.job_id), "reduce")
    row = {"records": rows, "job_s": job_s, "maps": result.num_maps,
           "map_s": task_span_s(maps), "reduce_s": task_span_s(reduces),
           "local_fetch_s": local_fetch_s} | stages | {
        "dense_bytes_fetched": fetched[0], "dense_fetches": fetched[1],
        "rss_start_gb": rss.start / 1e9, "peak_rss_gb": rss.peak / 1e9,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "argsort_launches": argsort_keys.launches - launches}
    for name in ("TPU_SHUFFLE_RECORDS", "DEVICE_SORT_ON_ACCEL"):
        row[name] = result.counters.value(BackendCounter.GROUP, name)
    log("cluster_terasort " + json.dumps(row))
    check(result.successful, "cluster terasort failed")
    check(row["TPU_SHUFFLE_RECORDS"] == rows and
          row["DEVICE_SORT_ON_ACCEL"] == 1 and row["argsort_launches"] == 1,
          f"cluster terasort: TPU_SHUFFLE_RECORDS "
          f"{row['TPU_SHUFFLE_RECORDS']}, DEVICE_SORT_ON_ACCEL "
          f"{row['DEVICE_SORT_ON_ACCEL']}, {row['argsort_launches']} "
          "device argsorts")
    check(len(reduces) == 1 and row["dense_fetches"] == result.num_maps,
          f"cluster terasort: {len(reduces)} reduces, "
          f"{row['dense_fetches']} dense fetches of {result.num_maps} maps")
    with teravalidate_process(out_dir, f"{work}/report-cluster"):
        sums = rows_checksum(out_dir, per_part=True)
    parts = sums.pop("part_records")
    check(parts == local_parts, f"cluster terasort: part records {parts}, "
          f"the local run's {local_parts}")
    check(sums == sums_in, "cluster terasort: the output's records are "
          "not the input's")
    shutil.rmtree(out_dir)
    return row


def cluster_host_job(c, label: str, gen: str, out: str, rows: int,
                     extra: "dict | None" = None) -> dict:
    """One host-shuffled terasort (TERA_REDUCES reduces) on the cluster,
    submitted through JobClient: its seconds, map and reduce seconds, the
    copy phase's counters, and the runner's chunk calls."""
    from tpumr_torch.core.counters import TaskCounter
    from tpumr_torch.examples.terasort import make_terasort_conf
    from tpumr_torch.mapred.job_client import JobClient
    conf = on_cluster(make_terasort_conf(f"file://{gen}", f"file://{out}",
                                         TERA_REDUCES), c)
    for k, v in (extra or {}).items():
        conf.set(k, v)
    runner = c.trackers[0]
    serve = runner.get_map_output_chunk
    calls = [0]

    def counted(*args):
        calls[0] += 1
        return serve(*args)

    runner.get_map_output_chunk = counted
    client = JobClient(conf)
    try:
        t = time.monotonic()
        running = client.submit_job(conf)
        st = running.wait_for_completion(timeout=PIPE_TIMEOUT_S)
        job_s = time.monotonic() - t
        counters = running.counters()
        maps = running.task_reports("map")
        reduces = running.task_reports("reduce")
    finally:
        client.close()
        del runner.get_map_output_chunk
    check(st["state"] == "SUCCEEDED", f"cluster {label}: {st}")
    g = TaskCounter.FRAMEWORK_GROUP
    row = {"run": label, "records": rows, "job_s": job_s,
           "maps": len(maps), "map_s": task_span_s(maps),
           "reduce_s": task_span_s(reduces), "chunk_calls": calls[0]} | {
        name: counters.value(g, name) for name in (
            "REDUCE_SHUFFLE_SEGMENTS_MEM", "REDUCE_SHUFFLE_SEGMENTS_DISK",
            "SHUFFLE_INMEM_MERGES", "SHUFFLE_DISK_MERGES", "MERGE_PASSES",
            "REDUCE_SHUFFLE_BYTES", "REDUCE_FETCH_FAILURES")} | (extra or {})
    check(all(r["successful_attempt"].endswith("_0")
              for r in maps + reduces),
          f"cluster {label}: a task succeeded only after a failed attempt")
    return row


def cluster_host_shuffle(work: str, gen: str, local_out: str,
                         rows: int) -> dict:
    """cluster_shuffle (b): the host shuffle on the cluster. ``rows``
    records of ``gen`` sorted with TERA_REDUCES reduces at the default
    tpumr.shuffle.parallel.copies, part for part the records of the local
    run ``local_out`` of the same input; then TERA_SPILL_ROWS records at a
    budget where every segment goes to disk and the disk segments merge
    in the background, part for part the local run's. One cluster_shuffle
    line."""
    small = f"{work}/spill-gen"
    teragen(small, TERA_SPILL_ROWS, TERA_SPILL_MAPS)
    tera_run("spill_host", small, f"{work}/spill-host", TERA_SPILL_ROWS,
             device_shuffle=False)
    with tera_cluster() as c:
        big = cluster_host_job(c, "host", gen, f"{work}/host-cluster", rows)
        spill = cluster_host_job(
            c, "spill_host", small, f"{work}/spill-cluster",
            TERA_SPILL_ROWS, {"tpumr.shuffle.ram.mb": TERA_SPILL_RAM_MB,
                              "io.sort.factor": TERA_SPILL_FACTOR})
        check_no_faults(c.master, "cluster_shuffle (b)")
    check(same_parts(f"{work}/host-cluster", local_out,
                     "the cluster's and the local shuffles") == rows,
          "cluster host shuffle: records lost")
    check(same_parts(f"{work}/spill-cluster", f"{work}/spill-host",
                     "the cluster's spilled and the local host shuffles")
          == TERA_SPILL_ROWS, "cluster spilled shuffle: records lost")
    check(big["REDUCE_SHUFFLE_SEGMENTS_MEM"]
          == big["maps"] * TERA_REDUCES, f"cluster host: "
          f"{big['REDUCE_SHUFFLE_SEGMENTS_MEM']} segments in memory")
    check(spill["REDUCE_SHUFFLE_SEGMENTS_DISK"] > 0
          and spill["SHUFFLE_DISK_MERGES"] + spill["SHUFFLE_INMEM_MERGES"]
          >= 1, f"cluster spill_host: {spill['REDUCE_SHUFFLE_SEGMENTS_DISK']}"
          f" disk segments, {spill['SHUFFLE_DISK_MERGES']} disk and "
          f"{spill['SHUFFLE_INMEM_MERGES']} in-memory merges")
    row = {"runs": [big, spill]}
    log("cluster_shuffle " + json.dumps(row))
    return row


def lost_output_rounds(c, work: str, n: int, km) -> dict:
    """cluster_shuffle (c): a lost map output on the card. One K-Means
    round (the pipeline phase's round conf, k = 16 from the first 16
    rows) on the pipeline cluster of one GPU slot, without faults and
    then with tpumr.fi.shuffle.serve.a0.probability=1: no map's first
    output can be fetched, so the reduce reports each one (after one
    failure: tpumr.shuffle.fetch.retries.per.source=1, backoff 10 to 100
    ms, as tests/test_fetch_failure.py's chaos run) and the master
    re-executes every map while the reduce waits. Checks: byte-identical
    centroids, every faulted map's success its attempt 1, both reduces'
    their attempt 0, every map on the GPU slot, the fused kernel once per
    map attempt (n_maps and 2 n_maps)."""
    from tpumr_torch.mapred.job_client import JobClient
    from tpumr_torch.pipeline.graph import expand_round
    from tpumr_torch.utils import fi
    t_phase = time.monotonic()
    n_maps = -(-n // HYB_ROWS)
    seeds = np.load(os.path.join(work, "pipe-cents-r0.npy"))
    faults = {"tpumr.fi.shuffle.serve.a0.probability": 1.0,
              "tpumr.shuffle.fetch.retries.per.source": 1,
              "tpumr.shuffle.copy.backoff.ms": 10,
              "tpumr.shuffle.copy.backoff.max.ms": 100}
    runs = {}
    for tag, extra in (("clean", {}), ("lost", faults)):
        np.save(os.path.join(work, f"{tag}-cents-r0.npy"), seeds)
        km.clear_centroid_cache()
        conf = c.create_job_conf()
        for key, value in expand_round(pipe_round_conf(work, f"{tag}-"),
                                       0).items():
            conf.set(key, value)
        for key, value in extra.items():
            conf.set(key, value)
        fi.reset()
        zero_launch_counts(km)
        client = JobClient(conf)
        try:
            t = time.monotonic()
            running = client.submit_job(conf)
            st = running.wait_for_completion(timeout=HYB_JOB_TIMEOUT_S)
            secs = time.monotonic() - t
            maps = running.task_reports("map")
            reduces = running.task_reports("reduce")
        finally:
            client.close()
        runs[tag] = {"job_s": secs, "state": st["state"],
                     "launches": launch_counts(km),
                     "map_attempts": sorted(r["successful_attempt"][-1:]
                                            for r in maps),
                     "reduce_attempts": [r["successful_attempt"][-1:]
                                         for r in reduces],
                     "gpu_maps": sum(bool(r["run_on_tpu"]) for r in maps),
                     "serve_faults": fi.fired("shuffle.serve.a0")}
        fi.reset()
    finals = []
    for tag in ("clean", "lost"):
        with open(os.path.join(work, f"{tag}-cents-r1.npy"), "rb") as f:
            finals.append(f.read())
    row = {"maps": n_maps, "seconds": time.monotonic() - t_phase} | runs
    log("cluster_lost_output " + json.dumps(row))
    for tag, attempt, launched in (("clean", "0", n_maps),
                                   ("lost", "1", 2 * n_maps)):
        r = runs[tag]
        check(r["state"] == "SUCCEEDED", f"lost output, {tag}: {r}")
        check(r["map_attempts"] == [attempt] * n_maps,
              f"lost output, {tag}: map successes on attempts "
              f"{r['map_attempts']}")
        check(r["reduce_attempts"] == ["0"], f"lost output, {tag}: the "
              f"reduce succeeded on attempt {r['reduce_attempts']}")
        check(r["gpu_maps"] == n_maps, f"lost output, {tag}: "
              f"{r['gpu_maps']} of {n_maps} maps on the GPU slot")
        check(r["launches"] == {"kmeans_assign_partials": launched,
                                "kmeans_assign": 0},
              f"lost output, {tag}: launches {r['launches']}")
    check(runs["lost"]["serve_faults"] >= n_maps,
          f"lost output: {runs['lost']['serve_faults']} serving faults")
    check(finals[0] == finals[1], "lost output: the faulted round's "
          "centroids differ from the fault-free round's")
    row["launches"] = sum(runs[tag]["launches"]["kmeans_assign_partials"]
                          for tag in runs)
    return row


def teragen_process(work: str, rows: int) -> ExampleProcess:
    """The terasort phase's teragen of ``rows`` records (TERA_MAPS maps)
    into ``work``/gen, started in a process of its own so that it runs
    beside the text and spill phases; ``work`` must have TERA_DISK_BYTES_PER_ROW
    bytes free a record."""
    free = shutil.disk_usage(work).free
    need = TERA_DISK_BYTES_PER_ROW * rows
    check(free >= need, f"terasort: {free / 1e9:.1f} GB free under {work}, "
          f"the phase needs {need / 1e9:.1f} GB")
    return ExampleProcess("terasort_teragen",
                          ["teragen", str(rows), f"file://{work}/gen", "-m",
                           str(TERA_MAPS)],
                          row={"records": rows, "maps": TERA_MAPS})


def terasort_phase(rows: int, work: str, gen_proc: ExampleProcess) -> dict:
    """BASELINE config 5 through the port on the card: teragen of ``rows``
    records (16 maps, ``gen_proc``: started before the text phase, in a
    process of its own), the device-shuffled terasort cold (4 ranges), the
    card's sort held to its stable order and to np.lexsort, teravalidate
    and the checksums of input and output; the same job on the cluster
    (cluster_shuffle (a)); then bench.py's host shuffle beside the device
    shuffle at 2,000,000 records, the three programs through the CLI at
    1,000,000, and the CLI's input sorted by the host shuffle on the
    cluster (cluster_shuffle (b)). The local warm run of earlier PRs is
    cut (PERF.md §4): it repeated the cold run's path."""
    from tpumr_torch.parallel.device_sort import argsort_keys, key_columns
    t_phase = time.monotonic()
    out = {}
    try:
        gen = f"{work}/gen"
        out["teragen_s"] = gen_proc.finish()
        launches = argsort_keys.launches
        out["cold"] = tera_run("cold", gen, f"{work}/out", rows)
        out["argsort_launches"] = argsort_keys.launches - launches
        check(out["argsort_launches"] == 1, "terasort: "
              f"{out['argsort_launches']} device argsorts in one job")
        with teravalidate_process(f"{work}/out", f"{work}/report"):
            t = time.monotonic()
            sums_in = rows_checksum(gen, keep_keys=True)
            kcols = key_columns(sums_in.pop("keys"), 10)
            out["read_input_s"] = time.monotonic() - t
            out["sort_check"] = check_stable_sort(
                kcols, min(rows, TERA_LEXSORT_ROWS))
            del kcols
        sums_out = rows_checksum(f"{work}/out", per_part=True)
        local_parts = sums_out.pop("part_records")
        log("terasort_checksum " + json.dumps(
            {"input": sums_in, "output": sums_out,
             "part_records": local_parts}))
        check(sums_in == sums_out and sums_out["records"] == rows,
              "terasort: the output's records are not the input's")
        shutil.rmtree(f"{work}/out")
        # cluster_shuffle (a): the same input on the cluster
        t = time.monotonic()
        with tera_cluster() as c:
            out["cluster"] = cluster_terasort(c, work, gen, rows, sums_in,
                                              local_parts,
                                              out["cold"]["fetch_s"])
            check_no_faults(c.master, "cluster_shuffle (a)")
        out["cluster"]["seconds"] = time.monotonic() - t
        shutil.rmtree(gen)

        bench = f"{work}/bench-gen"
        teragen(bench, TERA_BENCH_ROWS, TERA_BENCH_MAPS)
        # the CLI's three programs, processes of their own, beside the
        # host and device shuffles at 2,000,000
        beside = Beside(tera_cli_programs, work)
        try:
            host = tera_run("bench_host", bench, f"{work}/bench-host",
                            TERA_BENCH_ROWS, device_shuffle=False)
            dev = tera_run("bench_device", bench, f"{work}/bench-device",
                           TERA_BENCH_ROWS)
        finally:
            cli_secs = beside.join()
        check(same_parts(f"{work}/bench-host", f"{work}/bench-device")
              == TERA_BENCH_ROWS, "terasort: the host shuffle's records "
              "are not the device shuffle's")
        out["bench"] = {"terasort_host_job_s": host["job_s"],
                        "terasort_device_job_s": dev["job_s"],
                        "terasort_records": TERA_BENCH_ROWS}
        log("terasort_bench " + json.dumps(out["bench"]))
        out["cli"] = tera_cli(work, cli_secs)
        # cluster_shuffle (b): the CLI's input, host-shuffled on the
        # cluster, against the CLI's sort of it (the same records as the
        # host shuffle's, part for part, as bench_host and bench_device
        # show above)
        t = time.monotonic()
        out["cluster_host"] = cluster_host_shuffle(
            work, f"{work}/cli-gen", f"{work}/cli-out", TERA_CLI_ROWS)
        out["cluster_host"]["seconds"] = time.monotonic() - t
        log("terasort_phase " + json.dumps(
            {"seconds": time.monotonic() - t_phase,
             "read_input_s": out["read_input_s"],
             "cluster_shuffle_s": out["cluster"]["seconds"]
             + out["cluster_host"]["seconds"]}))
        return out
    finally:
        gen_proc.stop()


# ------------------------------------------------------------ user_api

#: the user_api phase (b): the streaming wordcount's text (MiB, from a
#: vocabulary of UA_VOCAB words, default_rng(UA_SEED)), the typed-bytes
#: identity's records, the chain job's lines, the join's orders and users
#: lines, the database job's rows and pages; seconds the phase's process
#: and the JobControl of (a) may take
UA_SEED, UA_WC_MB, UA_VOCAB = 11, 32, 5000
UA_TB_RECORDS, UA_CHAIN_LINES = 10_000, 100_000
UA_ORDERS, UA_USERS, UA_USER_IDS = 10_000, 1_500, 2_000
UA_DB_ROWS, UA_DB_PAGES = 100_000, 100
UA_HOST_TIMEOUT_S, UA_JOBCONTROL_TIMEOUT_S = 900, 300


def user_api_card(work: str, n: int, km, main: dict) -> dict:
    """The user_api phase (a), on the main path's resident points: a
    new-API Job (DenseInputFormat, set_map_kernel("kmeans-assign"), a
    new-API Reducer folding the partials as ops/kmeans.CentroidReducer
    does, one reduce) as the first ControlledJob of a JobControl on a
    thread of its own, and a host job that depends on it
    (KeyValueTextInputFormat over its part file, mapreduce.lib's
    InverseMapper, no reduce). The first must launch the fused kernel once
    a split from the warm split cache and commit the old-API warm job's
    part file byte for byte; the second must start after it and write its
    lines with key and value swapped; the JobControl thread must end."""
    from tpumr_torch.core.counters import BackendCounter
    from tpumr_torch.mapred import gpu_runner
    from tpumr_torch.mapred.input_formats import (DenseInputFormat,
                                                  KeyValueTextInputFormat)
    from tpumr_torch.mapreduce import Job, Reducer
    from tpumr_torch.mapreduce.lib import (ControlledJob, InverseMapper,
                                           JobControl)

    class CentroidFold(Reducer):
        def reduce(self, key, values, context):
            total, cnt = None, 0
            for s, c in values:
                s = np.asarray(s, dtype=np.float64)
                total = s if total is None else total + s
                cnt += int(c)
            context.write(key, (total / max(1, cnt)).tolist())

    class TimedJob(Job):
        """A Job that keeps when it ran."""

        def wait_for_completion(self, verbose: bool = False) -> bool:
            self.started = time.monotonic()
            try:
                return super().wait_for_completion(verbose)
            finally:
                self.ended = time.monotonic()

    n_splits = -(-n // ROWS_PER_SPLIT)
    kmeans = TimedJob(name="kmeans-new-api")
    kmeans.add_input_path(f"file://{work}/points.npy")
    kmeans.set_output_path(f"file://{work}/out-new-api")
    kmeans.set_input_format(DenseInputFormat)
    kmeans.conf.set("tpumr.dense.split.rows", ROWS_PER_SPLIT)
    kmeans.conf.set("tpumr.kmeans.centroids", f"file://{work}/cents.npy")
    kmeans.conf.set("tpumr.tpu.split.cache.mb", 8192)
    kmeans.set_map_kernel("kmeans-assign")
    kmeans.set_reducer_class(CentroidFold)
    kmeans.set_num_reduce_tasks(1)
    inverse = TimedJob(name="inverse-new-api")
    inverse.add_input_path(f"file://{work}/out-new-api/part-00000")
    inverse.set_output_path(f"file://{work}/out-inverse")
    inverse.set_input_format(KeyValueTextInputFormat)
    inverse.set_mapper_class(InverseMapper)
    inverse.set_num_reduce_tasks(0)
    jc = JobControl("user_api")
    first = jc.add_job(ControlledJob(kmeans))
    second = jc.add_job(ControlledJob(inverse, depending=[first]))

    km.clear_centroid_cache()            # as before each warm job
    cache = gpu_runner.split_cache(torch.device("cuda", 0), 8192 << 20)
    hits0 = cache.hits
    zero_launch_counts(km)               # this path's count starts
    thread = threading.Thread(target=jc.run, name="jobcontrol", daemon=True)
    t = time.monotonic()
    thread.start()
    try:
        thread.join(UA_JOBCONTROL_TIMEOUT_S)
    finally:
        jc.stop()
        thread.join(60)
    secs = time.monotonic() - t
    launches = launch_counts(km)
    check(not thread.is_alive(), "user_api (a): the JobControl thread did "
          f"not end within {UA_JOBCONTROL_TIMEOUT_S} s")
    check(first.state == ControlledJob.SUCCESS, "user_api (a): the new-API "
          f"kernel job ended {first.state}: {kmeans.error}")
    check(second.state == ControlledJob.SUCCESS, "user_api (a): the "
          f"dependent job ended {second.state}: {inverse.error}")
    check(inverse.started >= kmeans.ended, "user_api (a): the dependent "
          "job started before the kernel job ended")
    check(launches == {"kmeans_assign_partials": n_splits,
                       "kmeans_assign": 0},
          f"user_api (a): launches {launches} for {n_splits} splits")
    tpu_maps = kmeans.counters.value(BackendCounter.GROUP,
                                     BackendCounter.TPU_MAP_TASKS)
    check(tpu_maps == n_splits, f"user_api (a): TPU_MAP_TASKS {tpu_maps} "
          f"for {n_splits} splits")
    with open(os.path.join(work, "out-new-api", "part-00000"), "rb") as f:
        part = f.read()
    check(part == main["part"], "user_api (a): the new-API job's part file "
          "differs from the old-API warm job's")
    got = read_centroids(os.path.join(work, "out-new-api", "part-00000"))
    got = np.stack([got[i] for i in range(K)])
    err = np.abs(got - main["oracle"])
    check(bool(np.all(err <= CENTROID_ATOL + CENTROID_RTOL *
                      np.abs(main["oracle"]))),
          f"user_api (a): centroids off the float64 oracle by {err.max()}")
    with open(os.path.join(work, "out-inverse", "part-00000"), "rb") as f:
        swapped = f.read().decode().splitlines()
    want = [f"{v}\t{k}" for k, _, v in
            (line.partition("\t") for line in part.decode().splitlines())]
    check(swapped == want, "user_api (a): the dependent job's lines are "
          "not the kernel job's with key and value swapped")
    row = {"seconds": secs, "new_api_job_s": kmeans.ended - kmeans.started,
           "old_api_warm_job_s": main["jobs"][-1]["seconds"],
           "dependent_job_s": inverse.ended - inverse.started,
           "launches": launches, "tpu_map_tasks": tpu_maps,
           "split_cache_hits": cache.hits - hits0,
           "bytes_staged": kmeans.counters.value(
               BackendCounter.GROUP, BackendCounter.TPU_DEVICE_BYTES_STAGED),
           "max_abs_err": float(err.max())}
    log("user_api_card " + json.dumps(row))
    return row


class ChainSplit:
    """The chain job's first mapper: "k<i> <n>" -> ("k<i>", n)."""

    def configure(self, conf) -> None:
        pass

    def map(self, key, value, output, reporter) -> None:
        k, n = str(value).split()
        output.collect(k, int(n))

    def close(self) -> None:
        pass


class ChainRoute(ChainSplit):
    """The chain's second mapper: multiples of 10 to the side output
    "tens" (MultipleOutputs), the rest on."""

    def configure(self, conf) -> None:
        from tpumr_torch.mapred.lib import MultipleOutputs
        self._mo = MultipleOutputs(conf)

    def map(self, key, value, output, reporter) -> None:
        if value % 10 == 0:
            self._mo.collector("tens").collect(key, value)
        else:
            output.collect(key, value)

    def close(self) -> None:
        self._mo.close()


class ChainSum(ChainSplit):
    def reduce(self, key, values, output, reporter) -> None:
        output.collect(key, sum(values))


class ChainUpper(ChainSplit):
    """The mapper after the chain's reducer: the key in capitals."""

    def map(self, key, value, output, reporter) -> None:
        output.collect(str(key).upper(), value)


class DbPages(ChainSplit):
    """The database job's mapper: (id, page, n) rows -> (page, n)."""

    def map(self, key, row, output, reporter) -> None:
        output.collect(row[1], row[2])


def _datajoin_classes() -> tuple:
    """The join's mappers and reducer, made here (their bases load the
    port) and put under their names in this module, where the job's conf
    finds them by name."""
    from tpumr_torch.contrib.datajoin import DataJoinMapper, DataJoinReducer

    class UserApiOrders(DataJoinMapper):
        def input_tag(self, conf):
            return "orders"

        def extract_key(self, key, value):
            return str(value).split(",")[0]

        def extract_value(self, key, value):
            return str(value).split(",", 1)[1]

    class UserApiUsers(UserApiOrders):
        def input_tag(self, conf):
            return "users"

    class UserApiInnerJoin(DataJoinReducer):
        required_tags = ("orders", "users")

        def combine(self, key, tags, values, output, reporter):
            by_tag = dict(zip(tags, values))
            return f"{by_tag['users']}|{by_tag['orders']}"

    classes = (UserApiOrders, UserApiUsers, UserApiInnerJoin)
    for cls in classes:
        cls.__qualname__ = cls.__name__
        globals()[cls.__name__] = cls
    return classes


def _step(name: str, t0: float, **counts) -> dict:
    row = {"step": name, "seconds": time.monotonic() - t0, **counts}
    log("user_api_host_step " + json.dumps(row))
    return row


def ua_streaming_wordcount(work: str) -> dict:
    """UA_WC_MB MiB of text through python -m tpumr_torch.cli streaming,
    a Python script mapper emitting LongValueSum:<word> 1 and -reducer
    aggregate, against a collections.Counter of the text."""
    from collections import Counter
    rng = np.random.default_rng(UA_SEED)
    vocab = np.frombuffer(b"".join(f"w{i:04d}".encode()
                                   for i in range(UA_VOCAB)),
                          np.uint8).reshape(UA_VOCAB, 5)
    words = (UA_WC_MB << 20) // 6
    rows = np.empty((words, 6), np.uint8)
    rows[:, :5] = vocab[rng.integers(0, UA_VOCAB, words)]
    rows[:, 5] = ord(" ")
    rows[11::12, 5] = ord("\n")
    rows[-1, 5] = ord("\n")
    text = rows.tobytes()
    with open(os.path.join(work, "wc.txt"), "wb") as f:
        f.write(text)
    mapper = os.path.join(work, "wc_map.py")
    with open(mapper, "w") as f:
        f.write("import sys\n"
                "out = sys.stdout\n"
                "for line in sys.stdin:\n"
                "    for w in line.split():\n"
                "        out.write(f'LongValueSum:{w}\\t1\\n')\n")
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "tpumr_torch.cli", "streaming",
         "-input", f"file://{work}/wc.txt", "-output", f"file://{work}/wc-out",
         "-mapper", f"{sys.executable} {mapper}", "-reducer", "aggregate",
         "-numReduceTasks", "1"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=UA_HOST_TIMEOUT_S)
    check(proc.returncode == 0, f"user_api (b): streaming exited "
          f"{proc.returncode}: {proc.stderr[-2000:]}")
    got = {}
    with open(os.path.join(work, "wc-out", "part-00000")) as f:
        for line in f:
            k, v = line.rstrip("\n").split("\t")
            got[k] = int(v)
    want = Counter(text.decode().split())
    check(got == dict(want), "user_api (b): the streaming wordcount "
          "differs from a Counter of the text")
    return _step("streaming_wordcount", t0, bytes=len(text), words=words,
                 distinct=len(got))


def ua_typedbytes_identity(work: str) -> dict:
    """UA_TB_RECORDS binary records (NULs, tabs, newlines) in a
    SequenceFile through -io typedbytes with cat as mapper and reducer:
    the records out equal the records in, in key order."""
    from tpumr_torch.cli import main as cli_main
    from tpumr_torch.io import sequencefile
    rng = np.random.default_rng(UA_SEED + 1)
    keys = sorted({rng.bytes(12) for _ in range(UA_TB_RECORDS)})
    recs = [(k, rng.bytes(int(rng.integers(0, 200))) + b"\n\x00\t")
            for k in keys]
    os.makedirs(os.path.join(work, "tb-in"))
    with open(os.path.join(work, "tb-in", "part-0"), "wb") as f:
        w = sequencefile.Writer(f)
        for k, v in recs:
            w.append(k, v)
        w.close()
    t0 = time.monotonic()
    rc = cli_main([
        "streaming", "-input", f"file://{work}/tb-in",
        "-output", f"file://{work}/tb-out", "-mapper", "cat",
        "-reducer", "cat", "-io", "typedbytes",
        "-D", "mapred.input.format.class="
              "tpumr_torch.mapred.input_formats.SequenceFileInputFormat",
        "-D", "mapred.output.format.class="
              "tpumr_torch.mapred.output_formats.SequenceFileOutputFormat"])
    check(rc == 0, f"user_api (b): the typed-bytes job exited {rc}")
    with open(os.path.join(work, "tb-out", "part-00000"), "rb") as f:
        out = list(sequencefile.Reader(f))
    check(out == recs, "user_api (b): the typed-bytes identity changed "
          "the records")
    return _step("typedbytes_identity", t0, records=len(out))


def ua_chain_multiple_outputs(work: str) -> dict:
    """ChainMapper (ChainSplit, ChainRoute) -> ChainReducer (ChainSum,
    then ChainUpper), one reduce, the map's MultipleOutputs side file
    "tens" committed beside the part file."""
    from tpumr_torch.mapred.jobconf import JobConf
    from tpumr_torch.mapred.lib import ChainMapper, ChainReducer
    from tpumr_torch.mapred.local_runner import run_job
    rng = np.random.default_rng(UA_SEED + 2)
    pairs = rng.integers(0, 1000, size=(UA_CHAIN_LINES, 2))
    with open(os.path.join(work, "chain.txt"), "w") as f:
        f.writelines(f"k{a} {b}\n" for a, b in pairs)
    conf = JobConf()
    conf.set_input_paths(f"file://{work}/chain.txt")
    conf.set_output_path(f"file://{work}/chain-out")
    ChainMapper.add_mapper(conf, ChainSplit)
    ChainMapper.add_mapper(conf, ChainRoute)
    ChainReducer.set_reducer(conf, ChainSum)
    ChainReducer.add_mapper(conf, ChainUpper)
    conf.set_num_reduce_tasks(1)
    t0 = time.monotonic()
    check(run_job(conf).successful, "user_api (b): the chain job failed")
    sums: dict = {}
    tens = []
    for a, b in pairs:
        if b % 10 == 0:
            tens.append(f"k{a}\t{b}")
        else:
            sums[f"K{a}"] = sums.get(f"K{a}", 0) + int(b)
    out = os.path.join(work, "chain-out")
    with open(os.path.join(out, "part-00000")) as f:
        main = dict(line.rstrip("\n").split("\t") for line in f)
    check({k: int(v) for k, v in main.items()} == sums,
          "user_api (b): the chain's sums differ from the oracle's")
    with open(os.path.join(out, "tens-00000")) as f:
        side = f.read().splitlines()
    check(side == tens, "user_api (b): the committed side file differs "
          "from the oracle's")
    return _step("chain_multiple_outputs", t0, lines=UA_CHAIN_LINES,
                 keys=len(main), side_records=len(side))


def ua_datajoin(work: str) -> dict:
    """The inner join of UA_ORDERS orders and UA_USERS users lines through
    contrib.datajoin, against a Python join."""
    from tpumr_torch.contrib.datajoin import make_datajoin_conf
    from tpumr_torch.mapred.local_runner import run_job
    orders_cls, users_cls, join_cls = _datajoin_classes()
    rng = np.random.default_rng(UA_SEED + 3)
    orders = [(f"u{u}", f"o{i}") for i, u in
              enumerate(rng.integers(0, UA_USER_IDS, UA_ORDERS))]
    users = [(f"u{u}", f"name{u}") for u in
             rng.choice(UA_USER_IDS, UA_USERS, replace=False)]
    for name, rows in (("orders", orders), ("users", users)):
        os.makedirs(os.path.join(work, name))
        with open(os.path.join(work, name, "part-0"), "w") as f:
            f.writelines(f"{a},{b}\n" for a, b in rows)
    conf = make_datajoin_conf(
        [("orders", f"file://{work}/orders", orders_cls),
         ("users", f"file://{work}/users", users_cls)],
        join_cls, f"file://{work}/join-out")
    conf.set_num_reduce_tasks(1)
    t0 = time.monotonic()
    result = run_job(conf)
    check(result.successful, "user_api (b): the join failed")
    names = dict(users)
    want = sorted(f"{u}\t{names[u]}|{o}" for u, o in orders if u in names)
    with open(os.path.join(work, "join-out", "part-00000")) as f:
        got = sorted(f.read().splitlines())
    check(got == want, "user_api (b): the join differs from the oracle's")
    return _step("datajoin", t0, orders=UA_ORDERS, users=UA_USERS,
                 joined=len(got), tuples_joined=result.counters.value(
                     "tpumr.DataJoin", "TUPLES_JOINED"))


def ua_sqlite(work: str) -> dict:
    """UA_DB_ROWS rows of a sqlite table through DBInputFormat (4 ordered
    splits), summed a page, INSERTed by DBOutputFormat into another table
    of the database, against sums taken here."""
    import sqlite3
    from tpumr_torch.mapred.jobconf import JobConf
    from tpumr_torch.mapred.lib_db import DBInputFormat, DBOutputFormat
    from tpumr_torch.mapred.local_runner import run_job
    rng = np.random.default_rng(UA_SEED + 4)
    pages = rng.integers(0, UA_DB_PAGES, UA_DB_ROWS)
    ns = rng.integers(0, 1000, UA_DB_ROWS)
    path = os.path.join(work, "store.db")
    conn = sqlite3.connect(path)
    conn.execute("CREATE TABLE clicks (id INTEGER, page TEXT, n INTEGER)")
    conn.executemany("INSERT INTO clicks VALUES (?, ?, ?)",
                     [(i, f"page{p}", int(v))
                      for i, (p, v) in enumerate(zip(pages, ns))])
    conn.execute("CREATE TABLE totals (page TEXT, total INTEGER)")
    conn.commit()
    conn.close()
    conf = JobConf()
    conf.set("tpumr.db.connect", path)
    conf.set("tpumr.db.input.table", "clicks")
    conf.set("tpumr.db.input.order.by", "id")
    conf.set("tpumr.db.output.table", "totals")
    conf.set("tpumr.db.output.fields", "page,total")
    conf.set_input_format(DBInputFormat)
    conf.set_output_format(DBOutputFormat)
    conf.set("mapred.map.tasks", 4)
    conf.set_mapper_class(DbPages)
    conf.set_reducer_class(ChainSum)
    conf.set_num_reduce_tasks(1)
    conf.set_output_path(f"file://{work}/db-scratch")
    t0 = time.monotonic()
    result = run_job(conf)
    check(result.successful, "user_api (b): the database job failed")
    conn = sqlite3.connect(path)
    got = dict(conn.execute("SELECT page, total FROM totals"))
    conn.close()
    want: dict = {}
    for p, v in zip(pages, ns):
        want[f"page{p}"] = want.get(f"page{p}", 0) + int(v)
    check(got == want, "user_api (b): the database totals differ from the "
          "oracle's")
    return _step("sqlite", t0, rows=UA_DB_ROWS, maps=result.num_maps,
                 totals=len(got))


def user_api_host(work: str) -> None:
    """The user_api phase (b), the main of this script's --user-api-host
    process: the host tiers under the default cuda device, each step
    against its oracle, one line a step and one for the whole."""
    t0 = time.monotonic()
    steps = [step(work) for step in (ua_streaming_wordcount,
                                     ua_typedbytes_identity,
                                     ua_chain_multiple_outputs,
                                     ua_datajoin, ua_sqlite)]
    log("user_api_host " + json.dumps({
        "seconds": time.monotonic() - t0,
        "steps": {s["step"]: s["seconds"] for s in steps}}))


def user_api_host_process() -> dict:
    """The user_api phase (b) in a process of its own (this script with
    --user-api-host), its lines passed on; what its last line says."""
    work = tempfile.mkdtemp(prefix="tpumr_torch-userapi-")
    try:
        t = time.monotonic()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--user-api-host",
             work], cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=UA_HOST_TIMEOUT_S)
        secs = time.monotonic() - t
        lines = [line for line in proc.stdout.splitlines()
                 if line.startswith("user_api_host")]
        for line in lines:
            log(line)
        check(proc.returncode == 0 and lines and
              lines[-1].startswith("user_api_host {"),
              f"user_api (b) exited {proc.returncode}: "
              f"{proc.stderr[-3000:]}")
        out = json.loads(lines[-1].split(" ", 1)[1])
        out["process_s"] = secs
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def profile_warm_job(work: str) -> None:
    """One more warm job under torch.profiler: device time by kernel
    against the job's wall time, written under chiprun_out/."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpumr_torch.mapred.local_runner import run_job
    from tpumr_torch.ops.kmeans import clear_centroid_cache
    clear_centroid_cache()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.monotonic()
        run_job(job_conf(work, "out-profiled"))
        wall = time.monotonic() - t
    table = prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=25)
    # device-side events only (kernels, copies, memsets): an aten op's
    # device time is its kernels' time again
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    summary = {"wall_s": wall, "device_self_time_s": busy_us / 1e6,
               "device_idle_share": 1 - busy_us / 1e6 / wall}
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/profile_warm_job.txt", "w") as f:
        f.write(json.dumps(summary) + "\n" + table)
    log("profile " + json.dumps(summary))
    profile_host(work)


#: the job's host-side stages, as functions of tpumr_torch
HOST_STAGES = ("submit_job", "get_splits", "prelaunch_device_maps",
               "fetch_to_host", "run_map_task", "flush", "run_reduce_task",
               "commit_task", "commit_job", "rmtree")


def profile_host(work: str) -> None:
    """One more warm job under cProfile: cumulative host seconds of each
    stage in HOST_STAGES (cProfile's own cost inflates Python-heavy
    stages), written under chiprun_out/."""
    import cProfile
    import io
    import pstats

    from tpumr_torch.mapred.local_runner import run_job
    from tpumr_torch.ops.kmeans import clear_centroid_cache
    clear_centroid_cache()
    prof = cProfile.Profile()
    prof.enable()
    run_job(job_conf(work, "out-host-profiled"))
    prof.disable()
    stats = pstats.Stats(prof)
    stages = {name: 0.0 for name in HOST_STAGES}
    for (_file, _line, func), (_cc, _nc, _tt, ct, _callers) in \
            stats.stats.items():
        if func in stages:
            stages[func] += ct
    text = io.StringIO()
    pstats.Stats(prof, stream=text).sort_stats("cumulative").print_stats(40)
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/profile_warm_job_host.txt", "w") as f:
        f.write(json.dumps(stages) + "\n" + text.getvalue())
    log("host_profile " + json.dumps(stages))


def log_registers(build_log: str) -> dict:
    """One line per compiled kernel from ptxas's report: its (mangled)
    name, registers and spills. Returns each name's spill line."""
    import re
    name = spill = None
    spills = {}
    with open(build_log) as f:
        for line in f:
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                name = m.group(1)
            elif "spill" in line:
                spill = line.strip()
            elif "Used" in line and name:
                used = re.search(r"Used \d+ registers", line)
                log(f"nvcc {name}: {used.group(0) if used else line.strip()}"
                    f", {spill}")
                spills[name] = spill
                name = None
    return spills


def check_no_spills(spills: dict, instance: str) -> None:
    """Every compiled kernel whose mangled name holds ``instance`` (the
    fused kernel's instance for the main path's rows) spills no byte."""
    found = {name: line for name, line in spills.items() if instance in name}
    check(bool(found), f"ptxas reported no kernel named like {instance}")
    for name, line in found.items():
        check(line is not None and "0 bytes spill stores, 0 bytes spill "
              "loads" in line, f"{name} spills: {line}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--points", type=int, default=100_000_000,
                    help="K-Means points in the main-path job")
    ap.add_argument("--tera-rows", type=int, default=TERA_ROWS,
                    help="records of the terasort phase's 10 GB job")
    ap.add_argument("--hybrid-points", type=int, default=HYB_N,
                    help="K-Means points of the hybrid and pipeline "
                         "phases' jobs")
    ap.add_argument("--pipeline-tera-rows", type=int, default=PIPE_TERA_ROWS,
                    help="records of the pipeline phase's TeraSort chain")
    ap.add_argument("--profile", action="store_true",
                    help="also profile two more warm jobs, device and host "
                         "(chiprun_out/)")
    ap.add_argument("--user-api-host", metavar="DIR", default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    t_script = time.monotonic()
    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py runs on an NVIDIA GPU")
    if args.user_api_host:
        # the user_api phase's (b), in the process main() starts for it
        user_api_host(args.user_api_host)
        return

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    log(smi[0])
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, card "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    from tpumr_torch.ops import kmeans as km
    from tpumr_torch.ops import native
    log(f"kernel build: {native.build():.3f}s ("
        + ", ".join(os.path.basename(src) for src in native.SOURCES) + ")")
    check_no_spills(log_registers(native.BUILD_LOG),
                    f"assign_partials_kernelILi{D}ELb1E")

    shapes = kernel_phase(km)
    fused = fused_phase(km)
    real_faults = accel_fault_real(km)
    work = tempfile.mkdtemp(prefix="tpumr_torch-smoke-")
    try:
        main = main_path(work, args.points, km, args.profile)
        user_api = user_api_card(work, args.points, km, main)
        rounds = rounds_phase(work, args.points, km)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # the hybrid points, written once for the hybrid and pipeline phases
    points_dir = tempfile.mkdtemp(prefix="tpumr_torch-points-")
    try:
        hyb_points = os.path.join(points_dir, "points.npy")
        hybrid = hybrid_phase(km, args.hybrid_points, hyb_points)
        # pipes_isolation (b) and (c), on the hybrid cluster, beside the
        # pipeline phase's TeraSort chain
        try:
            pipeline = pipeline_phase(km, args.hybrid_points,
                                      args.pipeline_tera_rows, hyb_points,
                                      beside_chain=hybrid["pipes"].run)
        finally:
            hybrid["pipes"].close()
    finally:
        shutil.rmtree(points_dir, ignore_errors=True)
    job2 = second_job(km)
    job3 = third_job(km)
    matmul_phase()
    tera_work = tempfile.mkdtemp(prefix="tpumr_torch-terasort-")
    try:
        # teragen of 10^8 in a process of its own, beside the text and
        # spill phases' host work
        gen_proc = teragen_process(tera_work, args.tera_rows)
        try:
            text_phase()
            # the user_api phase's host tiers, a process of its own, beside
            # the spill phase's host jobs
            host_tiers = Beside(user_api_host_process)
            try:
                spill_phase()
            finally:
                user_api_host_out = host_tiers.join()
        except BaseException:
            gen_proc.stop()
            raise
        tera = terasort_phase(args.tera_rows, tera_work, gen_proc)
    finally:
        shutil.rmtree(tera_work, ignore_errors=True)
    accel, reaper = hybrid["accel"], pipeline["cli"]["reaper"]
    log("accel_fault_phase " + json.dumps({
        "seconds": real_faults["seconds"] + accel["seconds"],
        "real_s": real_faults["seconds"], "cluster_s": accel["seconds"],
        "quarantine_job_s": accel["quarantine"]["job_s"],
        "quarantine_to_restore_s":
            accel["quarantine"]["quarantine_to_restore_s"],
        "demotion_job_s": accel["demotion"]["job_s"],
        "clean_hybrid_job_s": [r["job_s"] for r in hybrid["runs"]],
        "reaper_job_s": reaper["job_s"]}))
    log("user_api_phase " + json.dumps({
        "seconds": user_api["seconds"] + user_api_host_out["process_s"],
        "a_s": user_api["seconds"], "b_s": user_api_host_out["process_s"],
        "new_api_job_s": user_api["new_api_job_s"],
        "old_api_warm_job_s": user_api["old_api_warm_job_s"]}))
    ms_a, ms_b = pipeline["pipes"]["master_state"], pipeline["restart"]
    ms_c = hybrid["master_state_c"]
    ms_launches = sum(r["launches"]["kmeans_assign_partials"]
                      for r in (ms_a["a"], ms_b, ms_c))
    log("master_state_phase " + json.dumps({
        "seconds": ms_a["a_s"] + ms_b["seconds"] + ms_c["seconds"],
        "a_s": ms_a["a_s"], "b_s": ms_b["seconds"], "c_s": ms_c["seconds"],
        "a_stop_to_succeeded_s": ms_a["a"]["stop_to_succeeded_s"],
        "a_placement_before_stop": ms_a["a"]["placement_before_stop"],
        "b_stop_to_succeeded_s": ms_b["stop_to_succeeded_s"],
        "c_job_s": ms_c["job_s"], "c_twin_on": ms_c["twin_on"],
        "launches": ms_launches}))
    lost = pipeline["lost_output"]
    log("cluster_shuffle_phase " + json.dumps({
        "seconds": tera["cluster"]["seconds"]
        + tera["cluster_host"]["seconds"] + lost["seconds"],
        "a_s": tera["cluster"]["seconds"],
        "b_s": tera["cluster_host"]["seconds"], "c_s": lost["seconds"]}))
    f, a = fused["main"], shapes["job2"]
    kernels = [{
        "name": "kmeans_assign_partials", "route": "cuda",
        "source": "tpumr_torch/csrc/kmeans_assign_partials.cu",
        "replaces": "tpumr/ops/kmeans.py:57",
        "launches": main["launches"]["kmeans_assign_partials"]
        + rounds["launches"]["kmeans_assign_partials"]
        + hybrid["launches"] + pipeline["launches"] + lost["launches"]
        + pipeline["pipes"]["launches"]
        + user_api["launches"]["kmeans_assign_partials"]
        + ms_launches,
        "max_abs_err": max(max(r["max_abs_err"], r["sums_max_abs_err"])
                           for r in fused.values()),
        "ms": f["kernel_ms"], "plain_ms": f["plain_ms"],
        "bound_ms": f["bound_ms"], "bound_by": f["bound_by"],
        "library_ms": None, "unfused_route_ms": f["unfused_route_ms"],
        "checked": True}, {
        "name": "kmeans_assign", "route": "cuda",
        "source": "tpumr_torch/csrc/kmeans_assign.cu",
        "replaces": "tpumr/ops/kmeans.py:57",
        "launches": job2["launches"]["kmeans_assign"]
        + job3["launches"]["kmeans_assign"],
        "max_abs_err": max(r["max_abs_err"] for r in shapes.values()),
        "ms": a["kernel_ms"], "plain_ms": a["plain_ms"],
        "bound_ms": a["bound_ms"], "bound_by": a["bound_by"],
        "library_ms": a["library_ms"], "checked": True}]
    check(all(kn["launches"] > 0 for kn in kernels),
          "a kernel never launched on the path that drives it")
    # the run's seconds on this script's clock, against the 1,200 s limit
    log("chip_smoke " + json.dumps({"seconds": time.monotonic() - t_script}))
    log(smi[0])   # again, beside the results at the end of the output
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
