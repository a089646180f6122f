"""The control of the comparison that decides ``correct``, at a
configuration's own size: the plain reference with the tie rule reversed,
put in the program's place through the harness, has to come out not
correct on every seed.

    python3 benchmark/control.py --config mhc4_r18 --seeds 1 2 3

Prints one JSON line a seed (the numbers compared, each with its limit,
and ``correct``) and exits 1 if any seed came out correct. The
benchmark's own runs never run it.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def control_bench(bench: dict, config: str) -> dict:
    """``bench`` with one cell more, ``<config>.control``."""
    out = dict(bench)
    out["workloads"] = bench["workloads"] + [
        {"name": config + ".control", "config": config,
         "traffic": "control", "chips": 1, "why": "the control"}]
    return out


def run_control(bench: dict, root: str, config: str, seed: int,
                device: str, bench_dir: str = HERE) -> dict:
    import harness

    cb = control_bench(bench, config)
    rec = harness.run_cell(cb, root, config + ".control", seed, 0.0, False,
                           device, bench_dir=bench_dir)
    out = harness.result_line(cb, rec, False, bench_dir=bench_dir)
    return {"config": config, "seed": seed, "correct": out["correct"],
            "checks": out["checks"], "control_s": rec["spans"][
                "control.solve"], "reference_s": rec["reference_s"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [p for p in (HERE, ROOT) if p not in sys.path]
    import harness

    bench = harness.load_bench(os.path.join(ROOT, "BENCHMARK.json"))
    failed_to_fail = 0
    for seed in args.seeds:
        res = run_control(bench, ROOT, args.config, seed, args.device)
        failed_to_fail += res["correct"]
        print(json.dumps(res), flush=True)
    return 1 if failed_to_fail else 0


if __name__ == "__main__":
    sys.exit(main())
