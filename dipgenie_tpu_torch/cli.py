"""Command-line entry point of the port, with the flag surface of
``dipgenie_tpu``'s CLI (``dipgenie_tpu/cli.py``, the reference's
``src/main.cpp:24-209``), and

* ``--dp-backend auto|torch|fused|jax|native|exact``: ``auto`` (the
  default) is the torch tier (the pair DP) on ``--device``, and runs a
  graph with a level wider than 512, past the pair planner's window limit,
  on the fused tier (under a tp mesh, the chunked tier over the mesh) with
  one ``[W::diploid_dp]`` line; ``fused`` is the
  fused tier (one forward keeping every backpointer, then one traceback),
  ``jax`` the chunked tier (checkpoints, then a replay and a walk a span;
  the JAX CLI's flag name), both on ``--device`` for levels up to 4,096
  wide; ``pallas`` is a TPU tier and is rejected with a message;
* ``--device cuda|cpu`` (default ``cuda``): ``cpu`` runs the kernels'
  plain PyTorch versions. With ``cuda`` and no card the run stops with
  exit code 1 before any host work;
* ``--sketch-backend host|device`` (default ``host``): ``device`` sketches
  haplotypes and reads with K10 (``ops/sketch.py``) on ``--device``, with
  the same exit code 1 before any host work where the card is missing,
  and takes ``-k`` up to 32.

A graph past a tier's limits (``ops/pair_plan.py:PlanLimit``, raised by
the pair planner and by the vertex tiers' planner and memory counts) ends
the run with one ``[E::main]`` line naming ``--dp-backend native`` and
exit code 1.

Parsed-but-unused flags, for parity (each is equally dead in the
reference binary): -H, -c, -N, -l.
"""

from __future__ import annotations

import argparse
import sys

from . import PHI_VERSION
from .device import NoCudaDevice, resolve_device
from .ops.pair_plan import PlanLimit
from .solver.pipeline import Pipeline, PipelineConfig
from .utils import timing

_TPU_TIERS = ("pallas",)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="dipgenie-tpu-torch",
        usage="dipgenie-tpu-torch -g <target.gfa> -r <reads.fa> "
              "-o <haplotype.fasta>",
        add_help=False,
    )
    ap.add_argument("-a", type=int, default=0, help="DP approximation mode")
    ap.add_argument("-k", type=int, default=31, help="K-mer size [31]")
    ap.add_argument("-w", type=int, default=25, help="Minimizer window size [25]")
    ap.add_argument("-R", type=int, default=18, help="Recombination limit [18]")
    ap.add_argument("-P", type=int, default=100,
                    help="Recombination penality for ILP [100]")
    ap.add_argument("-H", dest="top_k", type=int, default=15,
                    help="Top H haplotypes [15]")
    ap.add_argument("-q", type=int, default=1,
                    help="Mode QP/ILP (default IQP i.e q1, use q0 for ILP) [1]")
    ap.add_argument("-N", type=int, default=0, help="Naive expanded graph mode")
    ap.add_argument("-m", type=int, default=1,
                    help="Mixed/Integer programming (default Mixed -m1) [1]")
    ap.add_argument("-p", type=int, default=2,
                    help="Ploidy (default diploid -p2, -p1 for haploid) [2]")
    ap.add_argument("-l", type=int, default=0, help="Low coverage mode [0]")
    ap.add_argument("-T", type=float, default=1.0,
                    help="Threshold for minimizer filtering [1.000]")
    ap.add_argument("-t", type=int, default=4, help="Threads [4]")
    ap.add_argument("-g", type=str, default="", help="GFA file")
    ap.add_argument("-r", type=str, default="", help="Read file")
    ap.add_argument("-o", type=str, default="", help="Output haplotype file")
    ap.add_argument("-c", type=int, default=5000, help="Max k-mer occurrence")
    ap.add_argument("-d", type=int, default=0, help="Debug mode [0]")
    ap.add_argument("-h", action="store_true", help="Show help")
    ap.add_argument("--version", action="store_true")
    ap.add_argument("--dp-backend", type=str, default="auto",
                    choices=["auto", "torch", "fused", "jax", "native",
                             "exact", *_TPU_TIERS],
                    help="DP tier: auto (the torch tier, the fused tier "
                         "past its window limit), torch, fused, jax (the "
                         "chunked tier), native, exact [auto]")
    ap.add_argument("--device", type=str, default="cuda",
                    choices=["cuda", "cpu"],
                    help="device of the device DP tiers and of device "
                         "sketching [cuda]")
    ap.add_argument("--sketch-backend", type=str, default="host",
                    choices=["host", "device"],
                    help="minimizer sketching on the host or the device "
                         "[host]")
    ap.add_argument("--progress", action="store_true")
    ap.add_argument("--checkpoint-dir", type=str, default="",
                    help="Resume the anchor stage from DIR on rerun")
    return ap


def _reject(args) -> str | None:
    if args.dp_backend in _TPU_TIERS:
        return (f"--dp-backend {args.dp_backend} is a TPU tier of "
                "dipgenie_tpu; use --dp-backend torch (or auto, fused, jax, "
                "native, exact)")
    if args.sketch_backend == "device" and not 1 <= args.k <= 32:
        return (f"--sketch-backend device takes -k up to 32 (a k-mer is two "
                f"16-base lanes), not {args.k}; use --sketch-backend host")
    return None


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    ap = build_parser()
    args = ap.parse_args(argv)

    if args.version:
        print(f"PHI version: {PHI_VERSION}", file=sys.stderr)
        return 0

    if not argv or not args.g or not args.r or not args.o or args.h:
        ap.print_help(sys.stderr)
        return 0 if args.h else 1

    msg = _reject(args)
    if msg:
        print(f"[E::main] {msg}", file=sys.stderr)
        return 2

    timing.set_start()

    try:
        if args.a:
            # -a1 selects the ILP branch (main.cpp:167-199)
            print(
                "[M::main] -a1: exact ILP solver (HiGHS); note the stock "
                "reference build compiles this branch out.",
                file=sys.stderr,
            )
            from .io.fastx import read_fastx
            from .solver.anchors import compute_and_classify_anchors
            from .solver.ilp import ilp_solve
            from .solver.pipeline import get_hap_name

            cfg = PipelineConfig(
                k=args.k, w=args.w, recombination_penalty=args.P,
                ploidy=args.p, threshold=args.T, num_threads=args.t,
                debug=bool(args.d), device=args.device,
                sketch_backend=args.sketch_backend,
            )
            if cfg.sketch_backend == "device":
                resolve_device(cfg.device)  # fail before any host work
            pipe = Pipeline(args.g, args.r, args.o, cfg)
            pipe.load()
            reads = read_fastx(args.r)
            anchors = compute_and_classify_anchors(
                pipe.index, reads, cfg.k, cfg.w, cfg.threshold,
                sketch_backend=cfg.sketch_backend, device=cfg.device,
            )
            ilp_solve(
                pipe.index, anchors, args.o, get_hap_name(args.g, args.r),
                ploidy=args.p, recombination_penalty=args.P,
                is_mixed=bool(args.m),
            )
        else:
            if args.p not in (1, 2):
                print("Current approximator support is only for ploidy = 1 "
                      "or ploidy = 2")
                return 0
            cfg = PipelineConfig(
                k=args.k, w=args.w, recombination_limit=args.R,
                recombination_penalty=args.P, ploidy=args.p,
                threshold=args.T, num_threads=args.t, debug=bool(args.d),
                progress=args.progress, dp_backend=args.dp_backend,
                device=args.device, sketch_backend=args.sketch_backend,
                checkpoint_dir=args.checkpoint_dir or None,
            )
            Pipeline(args.g, args.r, args.o, cfg).run()
    except (NoCudaDevice, PlanLimit) as e:
        print(f"[E::main] {e}", file=sys.stderr)
        return 1

    print(f"[M::main] PHI Version: {PHI_VERSION}", file=sys.stderr)
    print("[M::main] CMD: dipgenie-tpu-torch " + " ".join(argv), file=sys.stderr)
    rt = timing.realtime()
    print(
        f"[M::main] Real time: {rt:.3f} sec; CPU: {timing.cputime():.3f} sec; "
        f"Peak RSS: {timing.peakrss_bytes() / 1024**3:.3f} GB",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
