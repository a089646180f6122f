"""The benchmark's harness: one cell, one run.

Everything that belongs to one configuration, traffic mix, tier or metric
sits in a file of its own, found by its name in ``BENCHMARK.json``:

* a configuration: the JSON file its entry names (generator, its
  parameters, R, the limits of the comparison);
* a traffic mix: ``traffic/<name>.json`` (the tier the window drives and
  the loop);
* a tier: ``tiers/<name>.py``, with ``COUNTERS`` (the program's launch
  counters), ``setup(csr, R, device, span)``, ``solve(state)`` and
  ``traced_solve(state, layer)``, and optionally ``build()``, which builds
  or loads the host libraries the tier's set-up uses (timed with the
  kernels, so a checkout's first build is not charged to its planner);
* a metric: ``metrics/<name>.py``, whose ``read(rec)`` takes the number from
  the run's record or returns None where it finds nothing to read.

A run makes the cell's graph from the seed, sets the tier up (its plan
and ship, and one warm solve: ``setup_s``), then solves in a closed loop,
one solve in flight, for the window's seconds. Once the window has closed
and the peak memory is read, the program's state is freed and the plain
reference (``reference.py``) judges the solves.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import itertools
import json
import os
import random
import sys
import time

import numpy as np
import torch

import devtrace
import inputs
import reference

HERE = os.path.dirname(os.path.abspath(__file__))
# the modules no process of the benchmark may hold once the window closes,
# compared by whole top-level names
FORBIDDEN = ("jax", "jaxlib", "flax", "dipgenie_tpu")
SAMPLE, SAMPLE_FROM = 3, 16  # solves whose transitions are judged


def load_bench(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_parts(bench: dict, root: str, name: str, bench_dir: str = HERE):
    """``(cell, config, traffic)`` of workload ``name``."""
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, entry["file"])) as fh:
        config = json.load(fh)
    with open(os.path.join(bench_dir, "traffic",
                           cell["traffic"] + ".json")) as fh:
        traffic = json.load(fh)
    return cell, config, traffic


def load_tier(name: str, bench_dir: str = HERE):
    return _load_module(os.path.join(bench_dir, "tiers", name + ".py"),
                        f"bench_tier_{name}")


def metric_reader(name: str, bench_dir: str = HERE):
    return _load_module(os.path.join(bench_dir, "metrics", name + ".py"),
                        "bench_metric_" + name.replace(".", "_"))


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics with
    ``--trace 0``, its per-layer metrics with ``--trace 1``."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list[str]:
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


class Record(dict):
    """What a run saw; the metric readers read it."""

    def __init__(self, device: torch.device, **kw):
        super().__init__(spans={}, layers={}, trace=None, **kw)
        self.device = device

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = False):
        """Host clock around a set-up step (``sync``: ended by a
        synchronise)."""
        t = time.perf_counter()
        yield
        if sync:
            self.sync()
        self["spans"][name] = time.perf_counter() - t


class Layers:
    """The traced solve's brackets: a profiler range ``bench.<span>``
    around each part, CUDA events around device parts and the host clock
    after a synchronise around host parts; ``close()`` adds a solve's ms
    to each layer metric's list."""

    def __init__(self, rec: Record):
        self.rec = rec
        self.open = []

    @contextlib.contextmanager
    def __call__(self, metric, span: str, host: bool = False):
        cuda = self.rec.device.type == "cuda"
        with torch.profiler.record_function("bench." + span):
            if host or not cuda:
                self.rec.sync()
                t = time.perf_counter()
                yield
                self.rec.sync()
                part = ("host", (time.perf_counter() - t) * 1e3)
            else:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                yield
                b.record()
                part = ("events", (a, b))
        if metric is not None:
            self.open.append((metric, part))

    def close(self):
        self.rec.sync()
        per = {}
        for metric, (kind, x) in self.open:
            ms = x if kind == "host" else x[0].elapsed_time(x[1])
            per[metric] = per.get(metric, 0.0) + ms
        for metric, ms in per.items():
            self.rec["layers"].setdefault(metric, []).append(ms)
        self.open = []


def _array(transitions) -> np.ndarray:
    """A solve's transitions as one int64 array, ``[T, 7]``."""
    return np.fromiter(itertools.chain.from_iterable(transitions), np.int64,
                       count=7 * len(transitions)).reshape(-1, 7)


def _counts(tier) -> int:
    return sum(w.launches for w in tier.COUNTERS)


def run_cell(bench: dict, root: str, name: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t_start: float | None = None,
             bench_dir: str = HERE) -> Record:
    """One run of cell ``name``: set-up, the window, the judgement. The
    cell's files are read from ``bench_dir``."""
    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    cell, config, traffic = cell_parts(bench, root, name, bench_dir)
    tier = load_tier(traffic["tier"], bench_dir)
    R = int(config["R"])
    if traffic["loop"] != "closed" or traffic["in_flight"] != 1:
        raise ValueError("the harness runs a closed loop, one solve in "
                         "flight")
    rec = Record(dev, cell=name, seed=seed, R=R, config=config,
                 traffic=traffic, tier=traffic["tier"],
                 device_kind=(torch.cuda.get_device_name(dev)
                              if dev.type == "cuda" else "cpu"))
    with rec.span("kernels"):
        if dev.type == "cuda":
            from dipgenie_tpu_torch import kernels
            kernels.lib()
        if hasattr(tier, "build"):
            tier.build()
    with rec.span("graph"):
        csr = inputs.make_graph(config, seed)
    rec["csr"] = csr
    rec["states"] = inputs.dp_states(csr[0], R)
    state = tier.setup(csr, R, dev, rec.span)
    with rec.span("warm", sync=True):
        tier.solve(state)
    layers = Layers(rec)
    if trace:
        # the profiler's first start (CUPTI) is set-up, not window
        with devtrace.profiler(dev):
            with layers(None, "warm"):
                tier.traced_solve(state, layers)
            layers.open = []
    rec.sync()
    rec["setup_s"] = time.perf_counter() - t_start

    sinks, shets = [], []
    # the solves whose transitions are judged: SAMPLE drawn from the seed
    # among the first SAMPLE_FROM, kept as arrays (the benchmark holds no
    # Python object of a solve into the next), and the last
    picks = set(random.Random(seed).sample(range(SAMPLE_FROM), SAMPLE))
    sample = {}
    gc.collect()
    before = _counts(tier)
    prof = devtrace.profiler(dev) if trace else contextlib.nullcontext()
    with prof as p:
        with torch.profiler.record_function("bench.window"):
            t0 = time.perf_counter()
            n = 0
            ends = []
            while True:
                if trace:
                    with torch.profiler.record_function("bench.solve"):
                        res = tier.traced_solve(state, layers)
                    layers.close()
                else:
                    res = tier.solve(state)
                sinks.append(res[0])
                shets.append(res[1])
                if n in picks:
                    sample[n] = _array(res[2])
                n += 1
                ends.append(time.perf_counter() - t0)
                if ends[-1] >= seconds:
                    break
                res = None
            rec["window_s"] = time.perf_counter() - t0
    rec["solve_s"] = np.diff(ends, prepend=0.0).tolist()
    sample[n - 1] = _array(res[2])
    rec["solves"] = n
    rec["launches"] = _counts(tier) - before
    rec["memory_peak_bytes"] = (
        int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda"
        else 0)
    if trace:
        rec["trace"] = devtrace.read(p, dev)
    del state, res
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    rec["checks"], rec["failed"] = judge(rec, csr, R, dev, sinks, shets,
                                         sample)
    return rec


def judge(rec, csr, R, dev, sinks, shets, sample):
    """The comparison with the plain reference: every solve's sink value
    and ``s_het``, the sampled solves' transitions. Returns ``(checks,
    failed)``: each number with its limit, and the solves found wrong."""
    t = time.perf_counter()
    ref = reference.forward(csr, R, dev)
    sink = ref.sink_key() >> 32
    steps = {i: reference.judge(ref, sinks[i], shets[i], tr)
             for i, tr in sample.items()}
    # the reference's s_het along the first sampled path: the reference's
    # own wherever that path is the reference's (its steps_off is 0)
    ref_shet = steps[min(steps)]["path_s_het"]
    bad = {i for i, s in enumerate(sinks) if s != sink}
    bad |= {i for i, s in enumerate(shets) if s != ref_shet}
    bad |= {i for i, j in steps.items() if j["steps_off"]}
    limits = rec["config"]["limits"]
    numbers = {
        "sink_off": sum(s != sink for s in sinks),
        "s_het_off": sum(s != ref_shet for s in shets),
        "steps_off": max(j["steps_off"] for j in steps.values()),
    }
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    rec["reference_s"] = time.perf_counter() - t
    del ref
    return checks, len(bad)


def result_line(bench: dict, rec: Record, trace: bool,
                bench_dir: str = HERE) -> dict:
    """The run's last line: the contract's keys, the checks last."""
    metrics = {}
    for m in cell_metrics(bench, rec["cell"], trace):
        v = metric_reader(m["name"], bench_dir).read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = rec.device
    device = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": rec["device_kind"],
        "count": 1,
        "memory_peak_bytes": rec["memory_peak_bytes"],
    }
    out = {"correct": all(c["value"] <= c["limit"]
                          for c in rec["checks"].values())
           and rec["failed"] == 0,
           "attempted": rec["solves"], "failed": rec["failed"],
           "metrics": metrics, "device": device}
    if trace and rec["trace"] is not None:
        device["busy_s"] = rec["trace"]["busy_s"]
        device["window_s"] = rec["trace"]["window_s"]
        out["breakdown"] = {"device_ops": rec["trace"]["device_ops"],
                            "idle_gaps": rec["trace"]["idle_gaps"]}
    out["checks"] = rec["checks"]
    return out
