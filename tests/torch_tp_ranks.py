"""Gloo ranks on the CPU for the tp tests (``tests/test_torch_tp.py``).

Not a test module: the spawned ranks import this module, torch and the
port only (no JAX), and each joins a file-initialised gloo group (no TCP
port, so parallel test files cannot collide), builds a ``(1, world)``
mesh, runs its job and writes its result to ``<tmp>/rank<r>.pkl``.
"""

from __future__ import annotations

import io
import os
import pickle

import torch
import torch.distributed as dist


def run_ranks(world: int, job: dict, tmp: str) -> list:
    """Spawn ``world`` ranks on ``job`` and return their results, in rank
    order. A failing rank raises here."""
    import torch.multiprocessing as mp

    mp.spawn(_rank, args=(world, job, tmp), nprocs=world, join=True)
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as fh:
            out.append(pickle.load(fh))
    return out


def _rank(rank: int, world: int, job: dict, tmp: str) -> None:
    """``job["dps"]``: ``{name: (CSR arrays, R)}``, each run through the
    port's tp DP on the CPU; ``job["pipeline"]``: ``(gfa, reads)`` through
    the port's pipeline with the mesh, writing ``<tmp>/rank<r>.fa``."""
    from dipgenie_tpu_torch.ops.diploid_pair import PairDiploidDP
    from dipgenie_tpu_torch.ops.plan import plan_pairs
    from dipgenie_tpu_torch.parallel.mesh import make_mesh
    from dipgenie_tpu_torch.solver.pipeline import Pipeline, PipelineConfig

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg",
                            world_size=world, rank=rank)
    try:
        mesh = make_mesh(n_dp=1, n_tp=world)
        out = {"tp_rank": mesh.tp_rank}
        for name, (arrs, R) in job.get("dps", {}).items():
            out[name] = PairDiploidDP(plan_pairs(*arrs, R), "cpu",
                                      mesh=mesh).run()
        if "pipeline" in job:
            gfa, reads = job["pipeline"]
            cfg = PipelineConfig(device="cpu", mesh=mesh, verbose=False)
            Pipeline(gfa, reads, os.path.join(tmp, f"rank{rank}.fa"),
                     cfg).run(out=io.StringIO())
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(out, fh)
    finally:
        dist.destroy_process_group()
