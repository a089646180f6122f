"""Command-line entry point of the port: the flag surface of ``dipgenie_tpu``'s
CLI (``dipgenie_tpu/cli.py``), with

* ``--dp-backend auto|torch|native|exact``: ``jax``, ``fused`` and
  ``pallas`` are TPU tiers and are rejected with a message;
* ``--device cuda|cpu`` (default ``cuda``): ``cpu`` runs the kernels'
  plain PyTorch versions;
* ``--sketch-backend host`` only: device sketching is not ported yet.

``-p1`` and ``-a1`` run the shared host code.
"""

from __future__ import annotations

import sys

from dipgenie_tpu.cli import build_parser as _jax_parser
from dipgenie_tpu.utils import timing

from . import PHI_VERSION
from .device import NoCudaDevice, resolve_device
from .solver.pipeline import TorchPipeline, TorchPipelineConfig

_TPU_TIERS = ("jax", "fused", "pallas")


def build_parser():
    ap = _jax_parser()
    ap.prog = "dipgenie-tpu-torch"
    ap.usage = ("dipgenie-tpu-torch -g <target.gfa> -r <reads.fa> "
                "-o <haplotype.fasta>")
    for action in ap._actions:
        if action.dest == "dp_backend":
            action.choices = ["auto", "torch", "native", "exact",
                              *_TPU_TIERS]
    ap.add_argument("--device", type=str, default="cuda",
                    choices=["cuda", "cpu"],
                    help="device of the torch DP tier [cuda]")
    return ap


def _reject(args) -> str | None:
    if args.dp_backend in _TPU_TIERS:
        return (f"--dp-backend {args.dp_backend} is a TPU tier of "
                "dipgenie_tpu; use --dp-backend torch (or auto, native, "
                "exact)")
    if args.sketch_backend != "host":
        return ("--sketch-backend device is not ported to the GPU yet; "
                "use --sketch-backend host")
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

    if args.a:
        # -a1 selects the ILP branch (main.cpp:167-199): shared host code
        print(
            "[M::main] -a1: exact ILP solver (HiGHS); note the stock "
            "reference build compiles this branch out.",
            file=sys.stderr,
        )
        from dipgenie_tpu.io.fastx import read_fastx
        from dipgenie_tpu.solver.anchors import compute_and_classify_anchors
        from dipgenie_tpu.solver.ilp import ilp_solve
        from dipgenie_tpu.solver.pipeline import get_hap_name

        cfg = TorchPipelineConfig(
            k=args.k, w=args.w, recombination_penalty=args.P, ploidy=args.p,
            threshold=args.T, num_threads=args.t, debug=bool(args.d),
        )
        pipe = TorchPipeline(args.g, args.r, args.o, cfg)
        pipe.load()
        reads = read_fastx(args.r)
        anchors = compute_and_classify_anchors(
            pipe.index, reads, cfg.k, cfg.w, cfg.threshold,
        )
        ilp_solve(
            pipe.index, anchors, args.o, get_hap_name(args.g, args.r),
            ploidy=args.p, recombination_penalty=args.P,
            is_mixed=bool(args.m),
        )
    else:
        if args.p not in (1, 2):
            print("Current approximator support is only for ploidy = 1 or ploidy = 2")
            return 0
        cfg = TorchPipelineConfig(
            k=args.k, w=args.w, recombination_limit=args.R,
            recombination_penalty=args.P, ploidy=args.p, threshold=args.T,
            num_threads=args.t, debug=bool(args.d), progress=args.progress,
            dp_backend=args.dp_backend, device=args.device,
            checkpoint_dir=args.checkpoint_dir or None,
        )
        try:
            if cfg.dp_backend == "torch":
                resolve_device(cfg.device)  # fail before any host work
            TorchPipeline(args.g, args.r, args.o, cfg).run()
        except NoCudaDevice as e:
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
