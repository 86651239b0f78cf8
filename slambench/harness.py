"""One run of one cell: set-up, the measured window, the traced extras, the
check against the reference, and the result line.

The window runs sequence after sequence, each one call of
``rgbd_slam_tpu_torch.runner.run_frames`` from ``engine.init_state(cam, cfg,
seed=<the realisation's state seed>)``, through the mix's realisations in the
order the run's seed draws (:mod:`slambench.traffic`), until ``--seconds`` have
passed and every realisation has run once; a sequence started in the window
runs to its end, and the window closes on its last pose.  A frame's pull from
its source and its ``on_frame`` call are stamped on the host clock; the
callback reads nothing from the device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from . import check, measure, registry, traffic

#: top-level module names that may not be loaded in the process that prints
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "rgbd_slam_tpu")
#: the program's package, beside ``slambench/`` in the checkout
PROGRAM = "rgbd_slam_tpu_torch"
#: frames of the profiled part of the traced run: from the pull of the first
#: to the pull of the second, in the second timed sequence (one summary batch,
#: with the backend's refine at its start in a cell with the backend)
PROFILE_FRAMES = (24, 32)
#: frames of the device-only trace of the traced run that the idle share is
#: read from: from the pull of the first to the end of the third timed
#: sequence (past its capture; the profiler traces the card alone, with no
#: host events and no ranges, which slow the host)
IDLE_FRAMES = (8, None)
#: eager frames before and under the profiler for the stage metrics
STAGE_WARMUP_FRAMES, STAGE_FRAMES = 6, 4
#: cache directories of the program's builds, inside the checkout
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
              "CUDA_CACHE_PATH": "cuda"}


class RunFailed(Exception):
    """The run cannot measure: no result line is printed."""


def say(*parts):
    print(*parts, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Sequence:
    """One timed ``run_frames`` call: its stamps, and what the check reads."""
    realization: int = 0
    keep: bool = False                 # keep every frame's state and outputs
    capture: frozenset = frozenset()   # frames whose decoded arrays are kept
    pulls: list = dataclasses.field(default_factory=list)
    waits: list = dataclasses.field(default_factory=list)
    done: list = dataclasses.field(default_factory=list)
    kept: list = dataclasses.field(default_factory=list)
    decoded: dict = dataclasses.field(default_factory=dict)
    traj: object = None
    stats: object = None

    def on_frame(self, i, state, out, dt):
        self.done.append(time.perf_counter())
        if self.keep:
            self.kept.append((state, out))


@dataclasses.dataclass
class RunData:
    """What the per-layer metrics read (``slambench/metrics``)."""
    sequences: list
    window: tuple
    syncs: int | None = None
    sync_frames: int = 0
    profile: dict | None = None
    idle: dict | None = None
    stages: dict | None = None
    frame_hw: tuple = (0, 0)
    patch_px: int = 0


def _set_cache_dirs(root: Path):
    for var, sub in CACHE_DIRS.items():
        path = root / ".slambench_cache" / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


class Program:
    """The system under test, imported from the checkout."""

    def __init__(self, tf32: bool):
        import torch

        import rgbd_slam_tpu_torch  # noqa: F401  (pins TF32 off)
        from rgbd_slam_tpu_torch import cli, config, engine, runner, step_graph
        from rgbd_slam_tpu_torch.features import primitives
        from rgbd_slam_tpu_torch.io import datasets
        from rgbd_slam_tpu_torch.parallel import keyframes, pose_graph

        self.cli, self.config, self.engine, self.runner = cli, config, engine, runner
        self.step_graph, self.primitives, self.datasets = step_graph, primitives, datasets
        self.keyframes, self.pose_graph = keyframes, pose_graph
        set_tf32(tf32)

    def run_kw(self, conf: dict) -> dict:
        """``run_frames``' keywords of a configuration, after checking the
        backend's capacities it states against the program's."""
        kw = {"with_planes": conf["with_planes"], "with_lines": conf["with_lines"]}
        backend = conf.get("backend")
        if backend:
            window = self.keyframes.KeyframeWindow()
            graph = self.pose_graph.PoseGraph()
            stated = {"ba_max_landmarks": window.max_landmarks,
                      "pose_graph_max_nodes": graph.max_nodes,
                      "pose_graph_max_edges": graph.max_edges}
            for key, have in stated.items():
                if backend[key] != have:
                    raise RunFailed(f"the configuration states {key}={backend[key]}; "
                                    f"the program runs {have}")
            kw.update(ba_every=backend["ba_every"], ba_window=backend["ba_window"],
                      ba_iterations=backend["ba_iterations"],
                      with_pose_graph=backend["with_pose_graph"])
        return kw

    def stage_targets(self):
        e, p = self.engine, self.primitives
        return {"pose_opt": [(e, "compute_optimized_pose")],
                "plane_extract": [(p, "find_primitives")]}

    def range_targets(self):
        """The program's calls the benchmark's ranges open around in the
        profiled part of a traced run."""
        sg, kf, pg, rn = self.step_graph, self.keyframes, self.pose_graph, self.runner
        return [(sg.StepGraph, "step", "step"), (sg.StepGraph, "_record", "capture"),
                (sg, "clone_tree", "clone"), (kf.KeyframeWindow, "refine", "refine"),
                (pg.PoseGraph, "solve", "graph_solve"), (rn, "_pack_summary", "summary")]


def set_tf32(on: bool):
    """TF32 products on (the check's control: the nearest precision below the
    configuration's float32) or off (as the configuration states)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    torch.set_float32_matmul_precision("high" if on else "highest")


def make_source(seq: Sequence, frames_fn, profiler=None, span=PROFILE_FRAMES):
    """The frames of one sequence with the stamps of their pulls.  With
    ``profiler``, it traces from the pull of frame ``span[0]`` to the pull of
    ``span[1]`` (None: to the sequence's end)."""
    import torch

    tracing = [False]

    def stop():
        if tracing[0]:
            torch.cuda.synchronize()
            profiler.stop()
            tracing[0] = False

    def source():
        it = iter(frames_fn())
        i = 0
        while True:
            if profiler is not None and i == span[0]:
                profiler.start()
                tracing[0] = True
            if i == span[1]:
                stop()
            t0 = time.perf_counter()
            try:
                frame = next(it)
            except StopIteration:
                stop()
                return
            seq.waits.append(time.perf_counter() - t0)
            seq.pulls.append(t0)
            if i in seq.capture:
                seq.decoded[i] = (np.array(frame[0]), np.array(frame[1]))
            i += 1
            yield frame

    return source()


def run(args, t_start: float, root: Path = registry.ROOT, device=None, body=None) -> int:
    """One run of ``args.workload``; returns the exit code.  ``device`` is
    the card (None) or, for the CPU tests of the harness, ``"cpu"``; ``body``
    takes the place of the measured run after the set-up (:func:`readings`)."""
    args.t_start = t_start
    try:
        return _run(args, root, device, body)
    except RunFailed as e:
        say(f"slambench: {e}")
        return 2


def _run(args, root: Path, device, body) -> int:
    bench = registry.Benchmark(root)
    cell = bench.workload(args.workload)
    conf = bench.config(cell["config"])
    mix = bench.traffic(cell["traffic"])
    traffic.check_mix(mix)
    if not (root / PROGRAM / "__init__.py").exists():
        raise RunFailed(f"no {PROGRAM}/ beside slambench/ in {root}: nothing to measure")
    _set_cache_dirs(root)
    workdir = tempfile.mkdtemp(prefix="slambench-") if mix["delivery"] == "tum_files" else None
    try:
        return _run_rendering(args, bench, cell, conf, mix, device, workdir, body)
    finally:
        if workdir is not None:
            shutil.rmtree(workdir, ignore_errors=True)


def _run_rendering(args, bench, cell, conf, mix, device, workdir, body) -> int:
    n_frames = conf["sequence_frames"]
    cam_values = {k: conf["camera"][k] for k in traffic.Camera._fields}
    # the frames render while torch loads and the card's context starts
    job = traffic.render(mix, traffic.Camera(**cam_values), n_frames,
                         traffic.workers_for(mix), workdir)
    try:
        return _run_rendered(args, bench, cell, conf, mix, device, job, n_frames, cam_values,
                             body)
    finally:
        job.close()


@dataclasses.dataclass
class SetUp:
    """What the set-up made, which the measured run and the check read."""
    program: object
    cam: object
    cfg: object
    cam_values: dict
    conf: dict
    mix: dict
    run_kw: dict
    n_frames: int
    frames_fn: object
    expected: list | None
    gt: object
    device: object
    staged: list | None


def _run_rendered(args, bench, cell, conf, mix, device, job, n_frames, cam_values,
                  body=None) -> int:
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RunFailed("no CUDA device: the benchmark runs on an NVIDIA card only")
        if torch.cuda.device_count() < cell["chips"]:
            raise RunFailed(f"{torch.cuda.device_count()} CUDA devices; the cell asks for "
                            f"{cell['chips']}")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    marks = [("torch", time.perf_counter())]
    torch.zeros(1, device=device)          # the context, while the frames render
    marks.append(("context", time.perf_counter()))
    program = Program(tf32=args.tf32)
    marks.append(("program", time.perf_counter()))
    if args.tf32:
        say("slambench: control run, TF32 on in the program")
    cam = program.config.CameraIntrinsics(**cam_values)
    cfg = check.build_dataclass(program.config.SlamConfig, conf["slam_config"])
    run_kw = program.run_kw(conf)
    frames, gt, poses, datasets = job.wait()
    marks.append(("frames", time.perf_counter()))
    setup = SetUp(program=program, cam=cam, cfg=cfg, cam_values=cam_values, conf=conf,
                  mix=mix, run_kw=run_kw, n_frames=n_frames, frames_fn=None, expected=None,
                  gt=gt, device=device, staged=None)
    if mix["delivery"] == "staged":
        setup.staged = [program.runner.stage_frames(f, device=device) for f in frames]

        def frames_fn(r, n=n_frames):
            return iter(setup.staged[r][:n])
        expected = frames
    else:
        indexes = []
        for dataset in datasets:
            indexes.append(program.datasets.index_tum(dataset))
            if len(indexes[-1]) != n_frames:
                raise RunFailed(f"{len(indexes[-1])} frames indexed of the {n_frames} "
                                "written")

        def frames_fn(r, n=n_frames):
            return program.cli.open_frames(indexes[r][:n], cam,
                                           native=mix["loader"] == "native")
        expected = [traffic.expected_decode(mix, f) for f in frames]
    setup.frames_fn, setup.expected = frames_fn, expected
    pool = Pool(mix, traffic.order(mix, args.seed))
    marks.append(("delivery", time.perf_counter()))

    # set-up: the kernels' libraries, the libraries' handles, the captures
    program.runner.run_frames(frames_fn(pool.realization(0), mix["warmup_frames"]), cam, cfg,
                              seed=pool.state_seed(0), device=device, **run_kw)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
    marks.append(("warm-up", time.perf_counter()))
    say("slambench: set-up s " + json.dumps(
        {name: t - before for (name, t), (_, before) in
         zip(marks, [("start", args.t_start)] + marks)}))
    return (body or _measure)(args, bench, setup)


def _measure(args, bench, setup: SetUp) -> int:
    """The measured window, the traced extras, the check and the result line."""
    import torch

    device, mix = setup.device, setup.mix
    readers = bench.readers(args.workload) if args.trace else {}
    needs = {n for r in readers.values() for n in r.NEEDS}
    if args.trace:
        needs.add("idle")      # busy_s and window_s
    pool = Pool(mix, traffic.order(mix, args.seed))
    checked = check.checked_frames(args.seed, setup.n_frames, mix["checked_frames"])
    first = pool.realization(0)
    data, seqs = _window(args, setup, pool, checked, needs)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    data.frame_hw = (setup.cam.height, setup.cam.width)
    data.patch_px = setup.cfg.detection.depth_patch_size_px
    if "stages" in needs:
        data.stages = _stage_profile(setup.program, setup.frames_fn, first, setup.cam,
                                     setup.cfg, device, pool.state_seed(0))
    setup.staged = None          # the staged frames, before the reference runs
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    limits = bench.limits(args.workload)
    ok, shown = _check(setup, pool, seqs, checked, limits)
    result = _result(args, bench, readers, data, seqs, setup.gt, peak, device, ok)
    card = card_line()
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))
    if loaded:
        say(f"slambench: the process holds {loaded}: the port may not load them")
        return 3
    result["card"] = card
    result["checks"] = shown
    print(json.dumps(result), flush=True)
    say(f"slambench: card {card}; {result['attempted']} frames in "
        f"{len(seqs)} sequences, {result['failed']} failed; correct={ok}")
    say(f"slambench: {time.perf_counter() - args.t_start:.3f} s in all")
    for name, pair in shown.items():
        say(f"check {name} = {pair['value']!r} (limit {pair['limit']!r})")
    return 0


def _check(setup: SetUp, pool, seqs, checked, limits, found_out=None):
    """The reference's run over the first sequence's realisation, following
    the first sequence, and the numbers of every sequence of that realisation
    beside their limits.  Returns (correct, {number: value and limit})."""
    t_check = time.perf_counter()
    first = pool.realization(0)
    followed = [s for s in seqs if s.realization == first]
    leaf_limits = limits.get("leaves", {})
    ref_traj, ref_stats, found = check.run_reference(
        setup.expected[first], setup.cam_values, setup.conf["slam_config"], setup.run_kw,
        pool.state_seed(0), checked, seqs[0].kept, setup.device)
    numbers = check.compare_sequences([(s.traj, s.stats) for s in followed], ref_traj,
                                      ref_stats, found, checked, leaf_limits)
    if setup.mix["delivery"] == "tum_files":
        numbers["frame_gap"] = check.frame_gap(seqs[0].decoded, setup.expected[first])
    say(f"slambench: reference checked {found.steps_checked} steps {checked} of "
        f"realisation {first} and {len(followed)} sequences of it in "
        f"{time.perf_counter() - t_check:.3f} s")
    say("slambench: steps (frame, mm, deg, plane mm) " + json.dumps(found.steps))
    say("slambench: leaves farthest past their limits, a step " + json.dumps(
        check.worst_leaves(found, leaf_limits)))
    say("slambench: sequences (frame of the largest gap off the checked steps, its mm, "
        "mm from the first) " + json.dumps(found.sequences))
    if found_out is not None:
        found_out.append(found)
    return check.judge(numbers, limits)


def _window(args, setup: SetUp, pool, checked, needs):
    """The measured window: sequence after sequence, through the mix's
    realisations in the run's order, until ``--seconds`` have passed and every
    realisation has run once; it closes when the last sequence's last pose
    reaches the host.  Returns (RunData, the timed sequences)."""
    import torch

    from . import tracing as trace

    program, mix = setup.program, setup.mix
    seqs = []
    sync = trace.SyncCounter() if "syncs" in needs else None
    profiler = None
    if "profile" in needs:
        profiler = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                      torch.profiler.ProfilerActivity.CUDA])
    idle = None
    if "idle" in needs:
        idle = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    capture = frozenset(checked) if mix["delivery"] == "tum_files" else frozenset()
    ranges = trace.Ranges(program.range_targets()) if profiler is not None else None

    def one_sequence(k):
        traced = {1: (profiler, PROFILE_FRAMES), 2: (idle, IDLE_FRAMES)}.get(k, (None,))
        r = pool.realization(k)
        seq = Sequence(realization=r, keep=k == 0,
                       capture=capture if k == 0 else frozenset())
        source = make_source(seq, lambda: setup.frames_fn(r), *traced)
        _, seq.traj, seq.stats = program.runner.run_frames(
            source, setup.cam, setup.cfg, seed=pool.state_seed(k), on_frame=seq.on_frame,
            device=setup.device, **setup.run_kw)
        return seq

    t0 = time.perf_counter()
    deadline = t0 + args.seconds
    with sync or contextlib.nullcontext(), ranges or contextlib.nullcontext():
        while time.perf_counter() < deadline or len(seqs) < max(pool.size, 3 if idle else 0):
            seqs.append(one_sequence(len(seqs)))
    data = RunData(sequences=seqs, window=(t0, seqs[-1].done[-1]))
    if sync is not None:
        data.syncs = sync.count
        data.sync_frames = sum(len(s.pulls) for s in seqs)
    if profiler is not None:
        data.profile = trace.read_slice(profiler, PROFILE_FRAMES[1] - PROFILE_FRAMES[0])
    if idle is not None:
        pulls = seqs[2].pulls[IDLE_FRAMES[0]:]
        data.idle = trace.read_idle(idle, len(pulls))
        # what the trace costs the host: the traced frames' time a frame beside
        # the untraced sequences'
        plain = [(s.pulls[-1] - s.pulls[IDLE_FRAMES[0]]) / (len(s.pulls) - 1 - IDLE_FRAMES[0])
                 for k, s in enumerate(seqs) if k not in (1, 2)]
        data.idle["ms_a_frame"] = 1e3 * (pulls[-1] - pulls[0]) / (len(pulls) - 1)
        data.idle["ms_a_frame_untraced"] = 1e3 * float(np.median(plain))
    return data, seqs


def readings(args, bench, setup: SetUp) -> int:
    """The check's readings in one process: for each of ``args.seeds`` the
    program as the configuration states, and for each of
    ``args.control_seeds`` the control (TF32 products), one timed sequence of
    the seed's first realisation, checked as a run checks it.  Writes every
    number and each checked step's leaf gaps to ``args.out``."""
    import torch

    mix = setup.mix
    limits = bench.limits(args.workload)
    records = []
    for seed, control in ([(s, False) for s in args.seeds]
                          + [(s, True) for s in args.control_seeds]):
        pool = Pool(mix, traffic.order(mix, seed))
        checked = check.checked_frames(seed, setup.n_frames, mix["checked_frames"])
        r = pool.realization(0)
        seq = Sequence(realization=r, keep=True,
                       capture=frozenset(checked) if mix["delivery"] == "tum_files"
                       else frozenset())
        set_tf32(control)
        try:
            _, seq.traj, seq.stats = setup.program.runner.run_frames(
                make_source(seq, lambda: setup.frames_fn(r)), setup.cam, setup.cfg,
                seed=pool.state_seed(0), on_frame=seq.on_frame, device=setup.device,
                **setup.run_kw)
        finally:
            set_tf32(False)
        found = []
        ok, shown = _check(setup, pool, [seq], checked, limits, found)
        records.append({"seed": seed, "control": control, "realization": r,
                        "correct": ok, "checks": {k: v["value"] for k, v in shown.items()},
                        "steps": found[0].steps, "leaves": found[0].leaves})
        say(f"readings: seed {seed} control={control} correct={ok} " + json.dumps(
            records[-1]["checks"]))
        del seq, found
        gc.collect()
        if setup.device.type == "cuda":
            torch.cuda.empty_cache()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"workload": args.workload, "card": card_line(),
                                          "records": records}))
    return 0


class Pool:
    """The mix's realisations in the run's order: sequence ``k`` runs
    realisation ``order[k % size]`` from its state seed."""

    def __init__(self, mix: dict, order: list):
        self.pairs = mix["realizations"]
        self.order = order
        self.size = len(order)

    def realization(self, k: int) -> int:
        return self.order[k % self.size]

    def state_seed(self, k: int) -> int:
        return self.pairs[self.realization(k)][1]


def _stage_profile(program, frames_fn, realization, cam, cfg, device, seed) -> dict:
    """Device µs a frame by stage over ``STAGE_FRAMES`` eager steps (ranges
    cannot live in a CUDA graph) after ``STAGE_WARMUP_FRAMES``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from . import tracing as trace

    frames = list(frames_fn(realization, STAGE_WARMUP_FRAMES + STAGE_FRAMES))
    state = program.engine.init_state(cam, cfg, seed=seed, device=device)

    def step(frame):
        gray = torch.as_tensor(frame[0], dtype=torch.float32, device=device)
        depth = torch.as_tensor(frame[1], dtype=torch.float32, device=device)
        return program.engine.step(state, gray, depth, cam, cfg)[0]

    for frame in frames[:STAGE_WARMUP_FRAMES]:
        state = step(frame)
    torch.cuda.synchronize()
    with trace.StageRanges(program.stage_targets()):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for frame in frames[STAGE_WARMUP_FRAMES:]:
                state = step(frame)
            torch.cuda.synchronize()
    per_frame, total = trace.device_breakdown(prof, STAGE_FRAMES)
    return {"stages_us": per_frame, "device_us": total, "step": "eager"}


def _result(args, bench, readers, data: RunData, seqs, gt, peak, device, ok) -> dict:
    import torch

    t0, t1 = data.window
    done = [t for s in seqs for t in s.done]
    pulls = [t for s in seqs for t in s.pulls]
    counted = measure.frames_in_window(done, t1)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    device = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
              "count": 1, "memory_peak_bytes": int(peak)}
    attempted = sum(s.stats.frame_count for s in seqs)
    failed = sum(s.stats.frame_count - s.stats.success_count for s in seqs)
    if counted == 0:
        raise RunFailed("no frame's pose reached the host in the window")
    say("slambench: sequences (realisation, s, first frame s) " + json.dumps(
        [(s.realization, s.done[-1] - s.pulls[0], s.stats.compile_s) for s in seqs]))
    if not args.trace:
        lat = measure.latencies_s(pulls, done, t1)
        say(f"slambench: {counted} frames in the {t1 - t0:.3f} s window; latency median "
            f"{1e3 * measure.percentile(lat, 50)!r} ms, p95 over {lat.size} frames; "
            f"lost {sum(s.stats.lost_count for s in seqs)}")
        values = {"fps": measure.fps(done, t0, t1),
                  "frame_latency_p95_ms": 1e3 * measure.percentile(lat, 95),
                  "ate_mm": measure.ate_over_sequences(
                      [s.traj.positions_array() for s in _one_of_each(seqs)], gt),
                  "setup_s": t0 - args.t_start}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in bench.end_to_end(args.workload)}
        out = {"correct": ok, "attempted": attempted, "failed": failed, "metrics": metrics,
               "device": device}
        return out
    metrics = {}
    for m in bench.per_layer(args.workload):
        value = readers[m["name"]].read(data)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device["busy_s"] = data.idle["busy_s"]
    device["window_s"] = data.idle["window_s"]
    say(f"slambench: profiled {json.dumps({k: v for k, v in data.profile.items() if k != 'breakdown'})}")
    say(f"slambench: device-only trace {json.dumps(data.idle)}")
    if data.stages is not None:
        say(f"slambench: eager stages {json.dumps(data.stages)}")
    return {"correct": ok, "attempted": attempted, "failed": failed, "metrics": metrics,
            "device": device, "breakdown": data.profile["breakdown"]}


def _one_of_each(seqs):
    """The first sequence of each realisation (the later ones repeat it)."""
    firsts = {}
    for seq in seqs:
        firsts.setdefault(seq.realization, seq)
    return [firsts[r] for r in sorted(firsts)]

