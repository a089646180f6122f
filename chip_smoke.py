#!/usr/bin/env python3
"""Smoke run of dipgenie_tpu_torch's main path on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure raises, so the script exits non-zero and prints no
result line):

  A. build the CUDA kernels (csrc/*.cu, nvcc, sm_90a) and the native
     runtime the comparisons use;
  B. every kernel against its plain PyTorch version on the card, exact
     integer equality, on every segment of the three real MHC slices
     (tests/data) and of the random instances of the JAX package's tests;
     then the DP results against the slices' baked exact-tier oracles and
     the random instances' native-tier results;
  C. the DP at MHC scale (R = 18, ~4.7e8 states, synthetic MHC-shaped
     graph): launch counts of the main path, forward and traceback times,
     states/s and peak memory, equality with the native C++ tier, and
     each kernel's time beside its plain version's on a plan prefix;
  D. the port's CLI on a synthetic 1 Mbp pangenome, byte-identical FASTA
     and stdout (apart from the timing line) against the JAX package's
     CLI on its native tier.

Before the last line it prints the card's name and power limit
(nvidia-smi) and one JSON object of per-kernel results; the last line is
the JSON status object. Logs and tables go to build/chip_smoke/.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "build", "chip_smoke")
SEED = 0
R = 18
PREFIX_TRANSITIONS = 5000

NPZ = ("mhc_slice_csr", "mhc_slice500_csr", "mhc_slice_wide_csr")
CSR_KEYS = ("level_ptr", "adj_ptr", "adj_v", "adj_w", "hom_ptr",
            "hom_colors", "het_ptr", "het_colors")
KERNELS = {
    "narrow_run": ("dipgenie_tpu_torch/csrc/narrow_run.cu",
                   "dipgenie_tpu/ops/diploid_pallas.py:861"),
    "wide_dense_run": ("dipgenie_tpu_torch/csrc/wide_dense_run.cu",
                       "dipgenie_tpu/ops/diploid_pallas.py:1388"),
    "trace": ("dipgenie_tpu_torch/csrc/trace.cu",
              "dipgenie_tpu/ops/diploid_pallas.py:1914"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        from dipgenie_tpu_torch.ops import narrow, trace, wide

        self.fns = {
            "narrow_run": (narrow.narrow_run, narrow.narrow_run_ref),
            "wide_dense_run": (wide.wide_dense_run, wide.wide_dense_run_ref),
            "trace": (trace.trace, trace.trace_ref),
        }
        self.err = {k: 0 for k in KERNELS}
        self.compared = {k: 0 for k in KERNELS}
        self.launches = {}
        self.ms = {}
        self.plain_ms = {}

    def counts(self):
        return {k: f[0].launches for k, f in self.fns.items()}

    def reset_counts(self):
        for f, _ in self.fns.values():
            f.launches = 0

    def compare(self, name, got, want):
        """Exact equality of kernel and plain outputs (tuples of int
        tensors); records the max abs difference."""
        torch = self.torch
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            check(g.shape == w.shape and g.dtype == w.dtype,
                  f"{name}: {tuple(g.shape)} {g.dtype} vs "
                  f"{tuple(w.shape)} {w.dtype}")
            if g.numel():
                d = int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                self.err[name] = max(self.err[name], d)
        self.compared[name] += 1
        check(self.err[name] == 0, f"{name} differs from its plain version "
              f"(max abs err {self.err[name]})")

    # ---------------- phase B ----------------
    def run_checked(self, dplan):
        """The forward and traceback with every kernel call checked
        against its plain version on the same inputs."""
        from dipgenie_tpu_torch.ops.diploid_pair import assemble
        from dipgenie_tpu_torch.ops.plan import initial_v

        torch = self.torch
        V = initial_v(dplan.R, "cuda")
        bps = []
        for seg in dplan.segments:
            name = "narrow_run" if seg.kind == "narrow" else "wide_dense_run"
            kern, plain = self.fns[name]
            got = kern(seg, V)
            self.compare(name, got, plain(seg, V))
            V = got[0]
            bps.append(got[1:])
        kern, plain = self.fns["trace"]
        recs = kern(dplan, bps)
        self.compare("trace", recs, plain(dplan, bps))
        torch.cuda.synchronize()
        return assemble(int(V[dplan.R, 0]), recs.cpu().numpy())

    def phase_b(self):
        import numpy as np

        from dipgenie_tpu_torch.ops.plan import plan_pairs, plan_to_device
        from dipgenie_tpu_torch.solver.diploid import native_forward_csr
        from dipgenie_tpu_torch.utils.synth import CASES, random_leveled_csr

        t0 = time.time()
        n_seg = 0
        for name in NPZ:
            d = np.load(os.path.join(REPO, "tests", "data", name + ".npz"))
            plan = plan_pairs(*[d[k] for k in CSR_KEYS], int(d["R"]))
            n_seg += len(plan.segments)
            got = self.run_checked(plan_to_device(plan, "cuda"))
            want = (int(d["oracle_value"]), int(d["oracle_shet"]),
                    [tuple(int(x) for x in r) for r in d["oracle_transitions"]])
            check(got == want, f"{name}: DP result differs from its oracle")
            log(f"B {name}: {plan.L} levels, {len(plan.segments)} segments, "
                f"value {got[0]} s_het {got[1]} == oracle")
        for seed, L, kmax, r, nc in CASES:
            arrs = random_leveled_csr(seed, L, kmax, nc)
            plan = plan_pairs(*arrs, r)
            n_seg += len(plan.segments)
            got = self.run_checked(plan_to_device(plan, "cuda"))
            check(got == native_forward_csr(arrs, r),
                  f"case {seed}: DP result differs from the native tier")
        log(f"B random cases: {len(CASES)} instances == native tier")
        log(f"B kernels == plain on {n_seg} segments "
            f"(calls compared: {self.compared}) in {time.time() - t0:.1f}s")

    # ---------------- phase C ----------------
    def phase_c(self):
        import numpy as np

        from dipgenie_tpu_torch.ops.diploid_pair import (
            PairDiploidDP, assemble,
        )
        from dipgenie_tpu_torch.ops.plan import (
            DevPlan, initial_v, plan_pairs, plan_to_device,
        )
        from dipgenie_tpu_torch.solver.diploid import native_forward_csr
        from dipgenie_tpu_torch.utils.synth import dp_states, mhc_shaped_csr

        torch = self.torch
        arrs = mhc_shaped_csr(L=120_000, seed=SEED)
        states = dp_states(arrs[0], R)
        widths = np.diff(arrs[0])
        log(f"C workload: synthetic MHC-shaped graph, {len(widths)} levels, "
            f"{int((widths > 32).sum())} wide levels, {states} DP states "
            f"(R={R})")
        t0 = time.time()
        plan = plan_pairs(*arrs, R)
        plan_s = time.time() - t0
        kinds = [type(s).__name__ for s in plan.segments]
        nbs = [s.NB for s in plan.segments if hasattr(s, "NB")]
        t0 = time.time()
        dplan = plan_to_device(plan, "cuda")
        torch.cuda.synchronize()
        ship_s = time.time() - t0
        log(f"C plan {plan_s:.3f}s ({kinds.count('_NarrowRun')} narrow, "
            f"{kinds.count('_WideRun')} wide runs, NB <= {max(nbs)}); "
            f"ship {ship_s:.3f}s")
        dp = PairDiploidDP(dplan, "cuda")
        dp.forward()  # warm pass
        torch.cuda.synchronize()

        # the main path, counted: forward + traceback + assembly
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.reset_peak_memory_stats()
        self.reset_counts()
        ev[0].record()
        V, bps = dp.forward()
        ev[1].record()
        from dipgenie_tpu_torch.ops.trace import trace

        recs = trace(dplan, bps)
        ev[2].record()
        torch.cuda.synchronize()
        got = assemble(int(V[R, 0]), recs.cpu().numpy())
        self.launches = self.counts()
        fwd_s = ev[0].elapsed_time(ev[1]) / 1e3
        tb_s = ev[1].elapsed_time(ev[2]) / 1e3
        peak = torch.cuda.max_memory_allocated()
        log(f"C forward {fwd_s:.4f}s, traceback {tb_s:.4f}s (CUDA events), "
            f"{states / fwd_s:.4e} DP states/s, peak memory {peak} B, "
            f"launches {self.launches}, card {torch.cuda.get_device_name(0)}")
        for k, n in self.launches.items():
            check(n > 0, f"{k} was not launched on the main path")
        del bps, recs
        self.profile_forward(dp)

        t0 = time.time()
        want = native_forward_csr(arrs, R)
        log(f"C native C++ tier {time.time() - t0:.1f}s (host)")
        check(got == want, "MHC-scale DP differs from the native tier: "
              f"{got[:2]} vs {want[:2]}")
        log(f"C value {got[0]} s_het {got[1]} and {len(got[2])} transitions "
            "== native tier")

        # kernels against their plain versions on a plan prefix
        prefix = []
        for seg in dplan.segments:
            if seg.t0 >= PREFIX_TRANSITIONS:
                break
            prefix.append(seg)
        v_ins, bps, V = [], [], initial_v(R, "cuda")
        for seg in prefix:
            v_ins.append(V)
            fn = self.fns["narrow_run" if seg.kind == "narrow"
                          else "wide_dense_run"][0]
            V, *bp = fn(seg, V)
            bps.append(tuple(bp))
        sub = DevPlan(R=R, L=prefix[-1].t1 + 1, device=dplan.device,
                      segments=prefix)

        def timed(fn):
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn()
            b.record()
            torch.cuda.synchronize()
            return a.elapsed_time(b), out

        def loop(name, which):
            fn = self.fns[name][which]
            kind = "narrow" if name == "narrow_run" else "wide"
            return [fn(s, v) for s, v in zip(prefix, v_ins) if s.kind == kind]

        n_tr = {"narrow_run": sum(s.t1 - s.t0 for s in prefix
                                  if s.kind == "narrow"),
                "wide_dense_run": sum(s.t1 - s.t0 for s in prefix
                                      if s.kind == "wide"),
                "trace": sub.L - 1}
        for name in KERNELS:
            if name == "trace":
                run = {0: lambda: self.fns["trace"][0](sub, bps),
                       1: lambda: self.fns["trace"][1](sub, bps)}
            else:
                run = {w: (lambda w=w, n=name: loop(n, w)) for w in (0, 1)}
            times = {0: [], 1: []}
            outs = {}
            for which in (1, 0, 0, 1):  # plain, kernel, kernel, plain
                ms, outs[which] = timed(run[which])
                times[which].append(ms)
            if name == "trace":
                self.compare(name, outs[0], outs[1])
            else:
                for g, w in zip(outs[0], outs[1]):
                    self.compare(name, g, w)
            self.ms[name] = min(times[0])
            self.plain_ms[name] = min(times[1])
            log(f"C {name} on the first {n_tr[name]} transitions of the "
                f"plan: kernel {times[0]} ms, plain {times[1]} ms")

    def profile_forward(self, dp):
        """Device busy and idle share of one more forward pass, from a
        torch.profiler trace (kernel rows only); the table goes to
        build/chip_smoke/profile_forward.txt."""
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            a.record()
            out = dp.forward()
            b.record()
            torch.cuda.synchronize()
        del out
        wall_us = a.elapsed_time(b) * 1e3
        avg = prof.key_averages()
        with open(os.path.join(OUT_DIR, "profile_forward.txt"), "w") as fh:
            fh.write(avg.table(sort_by="self_device_time_total", row_limit=30))
        rows = sorted(
            ((e.key, e.self_device_time_total, e.count) for e in avg
             if str(e.device_type).endswith("CUDA")
             and e.self_device_time_total > 0),
            key=lambda x: -x[1])
        busy = sum(t for _, t, _ in rows)
        if not busy:
            log("C profile: no device time in the trace; idle share not "
                "measured")
            return
        log(f"C profiled forward {wall_us / 1e6:.4f}s: device busy "
            f"{busy / 1e6:.4f}s, idle share {1 - busy / wall_us:.4f}; "
            + "; ".join(f"{k[:48]} {t / 1e3:.2f} ms x{n}"
                        for k, t, n in rows[:5]))

    # ---------------- phase D ----------------
    def phase_d(self):
        from dipgenie_tpu_torch.utils.synth import pangenome

        work = os.path.join(REPO, "build", "chip_smoke_e2e")
        t0 = time.time()
        n_bp = 1_000_000
        gfa, reads = pangenome(work, n_bp=n_bp, n_walks=8, seed=SEED)
        log(f"D synthetic pangenome: {n_bp} bp, 8 walks, reads from 2 "
            f"walks at 2x ({time.time() - t0:.1f}s)")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
        runs = {}
        for tag, cmd in (
            ("port", ["-m", "dipgenie_tpu_torch", "--dp-backend", "torch",
                      "--device", "cuda"]),
            ("native", ["-m", "dipgenie_tpu", "--dp-backend", "native"]),
        ):
            cwd = os.path.join(work, tag)
            os.makedirs(cwd, exist_ok=True)
            t0 = time.time()
            p = subprocess.run(
                [sys.executable, *cmd, "-p2", "-R18", "-g", gfa, "-r", reads,
                 "-o", "out.fa"],
                cwd=cwd, env=env, capture_output=True, text=True,
            )
            with open(os.path.join(OUT_DIR, f"d_{tag}.log"), "w") as fh:
                fh.write(p.stdout + "\n---- stderr ----\n" + p.stderr)
            check(p.returncode == 0, f"D {tag} CLI exited {p.returncode}: "
                  f"{p.stderr[-2000:]}")
            with open(os.path.join(cwd, "out.fa"), "rb") as fh:
                runs[tag] = (p.stdout, p.stderr, fh.read())
            log(f"D {tag} CLI {time.time() - t0:.1f}s")
        (po, pe, pf), (no, _, nf) = runs["port"], runs["native"]
        check(pf == nf, "D FASTA differs between the port and native tier")

        def lines(s):
            return [x for x in s.splitlines() if " took " not in x]

        check(lines(po) == lines(no), "D stdout differs")
        plan_line = [x for x in pe.splitlines() if "pair plan ready" in x]
        launch_line = [x for x in pe.splitlines() if "kernel launches" in x]
        check(bool(plan_line) and bool(launch_line), "D torch tier not run")
        log("D " + plan_line[0].split("] ", 1)[1])
        log("D " + launch_line[0].split("] ", 1)[1])
        counts = {k: int(v) for k, v in (
            kv.split("=") for kv in
            launch_line[0].split("launches ", 1)[1].split())}
        runs = re.search(r"(\d+) narrow and (\d+) wide runs", plan_line[0])
        check(counts == {"narrow_run": int(runs[1]),
                         "wide_dense_run": int(runs[2]), "trace": 1},
              f"D launches {counts} do not match the plan's runs")
        if int(runs[2]) == 0:
            log("D note: this graph has no wide level; K2 did not run here")
        log(f"D FASTA byte-identical ({len(pf)} B) and stdout identical "
            "apart from the timing line")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from dipgenie_tpu_torch import kernels
    from dipgenie_tpu_torch.utils.native_build import ensure_native

    os.makedirs(OUT_DIR, exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.time()
    path, build_log = kernels.build()
    log(f"A kernels built in {time.time() - t0:.1f}s: "
        f"{os.path.relpath(path, REPO)}")
    with open(os.path.join(OUT_DIR, "nvcc.log"), "w") as fh:
        fh.write(build_log)
    kernels.lib()
    t0 = time.time()
    check(ensure_native(), "native runtime did not build")
    log(f"A native runtime ready in {time.time() - t0:.1f}s")

    smoke = Smoke(torch)
    smoke.phase_b()
    smoke.phase_c()
    smoke.phase_d()

    result = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": smoke.launches[name], "max_abs_err": smoke.err[name],
         "ms": smoke.ms[name], "plain_ms": smoke.plain_ms[name]}
        for name, (src, rep) in KERNELS.items()
    ]}
    print(smi)
    print(json.dumps(result))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
