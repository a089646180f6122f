"""Run one cell of the benchmark and print its result as the last line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. ``BENCHMARK.json`` names the cells; ``harness.py`` says how a run
goes. Exits non-zero, printing no result, without a card, or when a
module of JAX or of the JAX package is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()  # set-up counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _caches() -> None:
    """Every build cache inside the checkout, at fixed paths. The program
    builds its kernels into ``build/`` itself; these hold what PyTorch's
    extension builder and Triton would build, should the program come to
    use them (a later change to the program cannot set them here)."""
    build = os.path.join(ROOT, "build", "benchmark")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path[:0] = [p for p in (HERE, ROOT) if p not in sys.path]
    import torch

    import harness

    bench = harness.load_bench(os.path.join(ROOT, "BENCHMARK.json"))
    cell = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell["chips"]):
        print(f"the cell needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 1
    rec = harness.run_cell(bench, ROOT, args.workload, args.seed,
                           args.seconds, bool(args.trace), "cuda",
                           t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded after the window: {', '.join(bad)}", file=sys.stderr)
        return 3
    out = harness.result_line(bench, rec, bool(args.trace))
    spans = " ".join(f"{k} {v:.3f}" for k, v in rec["spans"].items())
    print(f"set-up {rec['setup_s']:.3f} s ({spans}); window "
          f"{rec['window_s']:.3f} s, {rec['solves']} solves (s each: min "
          f"{min(rec['solve_s']):.4f} median "
          f"{statistics.median(rec['solve_s']):.4f} max "
          f"{max(rec['solve_s']):.4f}); reference {rec['reference_s']:.3f} s",
          file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
