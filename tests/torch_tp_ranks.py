"""Gloo ranks on the CPU for the mesh tests (``tests/test_torch_tp.py``,
``tests/test_torch_sketch.py``, ``tests/test_torch_entry.py``,
``tests/test_torch_chunked_tp.py``, ``tests/test_torch_cli.py``).

Not a test module: the spawned ranks import this module, torch and the
port only (no JAX), and each joins a file-initialised gloo group (no TCP
port, so parallel test files cannot collide), builds a ``job["mesh"]``
mesh (``(n_dp, n_tp)``, default ``(1, world)``), runs its job and writes
its result to ``<tmp>/rank<r>.pkl``.
"""

from __future__ import annotations

import contextlib
import functools
import io
import os
import pickle
import sys
from unittest import mock

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
    the port's pipeline with the mesh (and ``job["config"]``'s fields),
    writing ``<tmp>/rank<r>.fa``; ``job["sketch_count"]``: the arguments
    of ``sharded_sketch_count_step`` after the mesh; ``job["sketch_reads"]``:
    ``(seqs, k, w)`` of ``sketch_reads_device`` with the mesh;
    ``job["dryrun"]``: ``n`` of ``entry.dryrun_multichip``;
    ``job["chunked"]``: ``{name: (CSR arrays, R)}``, each through the
    port's chunked tier over the mesh on the CPU, with its share and
    gather counts; ``job["level_step"]``: ``(CSR arrays, R, t)``, the
    chunked state before transition ``t`` then ``sharded_dp_level_step``;
    ``job["cli"]``: ``{tag: argv}``, each through the port's CLI with the
    mesh in its ``PipelineConfig``, writing ``<tmp>/rank<r>_<tag>.fa``,
    its exit code and stderr kept; ``job["auto"]``: ``{name: (CSR
    arrays, R)}``, each through ``device_forward(..., "auto", "cpu",
    mesh)``, its stderr kept."""
    from dipgenie_tpu_torch import cli
    from dipgenie_tpu_torch.entry import dryrun_multichip
    from dipgenie_tpu_torch.ops import chunked
    from dipgenie_tpu_torch.ops.vertex_plan import plan_vertices
    from dipgenie_tpu_torch.solver.diploid import device_forward
    from dipgenie_tpu_torch.ops.diploid_pair import PairDiploidDP
    from dipgenie_tpu_torch.ops.plan import plan_pairs
    from dipgenie_tpu_torch.ops.sketch import sketch_reads_device
    from dipgenie_tpu_torch.parallel.mesh import (
        make_mesh, sharded_sketch_count_step,
    )
    from dipgenie_tpu_torch.solver.pipeline import Pipeline, PipelineConfig

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg",
                            world_size=world, rank=rank)
    try:
        n_dp, n_tp = job.get("mesh", (1, world))
        mesh = make_mesh(n_dp=n_dp, n_tp=n_tp)
        out = {"tp_rank": mesh.tp_rank, "dp_rank": mesh.dp_rank}
        for name, (arrs, R) in job.get("dps", {}).items():
            out[name] = PairDiploidDP(plan_pairs(*arrs, R), "cpu",
                                      mesh=mesh).run()
        if "pipeline" in job:
            gfa, reads = job["pipeline"]
            cfg = PipelineConfig(device="cpu", mesh=mesh, verbose=False,
                                 **job.get("config", {}))
            Pipeline(gfa, reads, os.path.join(tmp, f"rank{rank}.fa"),
                     cfg).run(out=io.StringIO())
        if "sketch_count" in job:
            out["sketch_count"] = tuple(
                t.numpy() for t in sharded_sketch_count_step(
                    mesh, *job["sketch_count"], device="cpu"))
        if "sketch_reads" in job:
            out["sketch_reads"] = sketch_reads_device(
                *job["sketch_reads"], mesh=mesh, device="cpu")
        if "dryrun" in job:
            dryrun_multichip(job["dryrun"], device="cpu")
            out["dryrun"] = True
        for name, (arrs, R) in job.get("chunked", {}).items():
            dp = chunked.DeviceDiploidDP(plan_vertices(*arrs), R, "cpu",
                                         mesh=mesh)
            out.setdefault("chunked", {})[name] = (dp.run(), dp.stats)
        if "level_step" in job:
            out["level_step"] = _level_step(mesh, *job["level_step"])
        err = os.path.join(tmp, f"rank{rank}.err")
        for tag, argv in job.get("cli", {}).items():
            with mock.patch.object(cli, "PipelineConfig", functools.partial(
                    PipelineConfig, mesh=mesh)), _stderr_to(err), \
                    contextlib.redirect_stdout(io.StringIO()):
                rc = cli.main([*argv, "-o", os.path.join(
                    tmp, f"rank{rank}_{tag}.fa")])
            with open(err) as fh:
                out.setdefault("cli", {})[tag] = (rc, fh.read())
        for name, (arrs, R) in job.get("auto", {}).items():
            with _stderr_to(err):
                got = device_forward(arrs, R, "auto", "cpu", mesh)
            with open(err) as fh:
                out.setdefault("auto", {})[name] = (got, fh.read())
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(out, fh)
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _stderr_to(path: str):
    """File descriptor 2 into ``path`` (the log lines write to the
    ``sys.stderr`` bound when their module was imported)."""
    sys.stderr.flush()
    saved = os.dup(2)
    with open(path, "w") as fh:
        os.dup2(fh.fileno(), 2)
        try:
            yield
        finally:
            sys.stderr.flush()
            os.dup2(saved, 2)
            os.close(saved)


def _level_step(mesh, arrs, R, t):
    """``(V, SH, V', SH', words)`` as numpy: the chunked tier's state
    before transition ``t`` (plain, on the CPU) and
    ``sharded_dp_level_step`` from it."""
    from dipgenie_tpu_torch.ops import chunked
    from dipgenie_tpu_torch.ops.vertex_plan import (
        initial_state, plan_vertices, ship,
    )
    from dipgenie_tpu_torch.parallel.mesh import sharded_dp_level_step

    plan = plan_vertices(*arrs)
    dev = ship(plan, "cpu")
    V = initial_state(R, int(plan.widths[0]), "cpu")
    V, SH = chunked.chunk_step_ref(dev, 0, t, V, torch.zeros_like(V))
    got = sharded_dp_level_step(mesh, dev, t, V, SH)
    return tuple(x.numpy() for x in (V, SH, *got))
