"""Driver entry points of the port, the counterparts of
``__graft_entry__.py``:

* ``entry(device)`` returns ``(fn, args)``: ``fn(*args)`` is one pair-DP
  step on the port's main path, one K1 launch (``ops/narrow.py``) on the
  first narrow run of the plan of ``tests/data/mhc_slice_csr.npz``. The JAX
  entry runs one level of its chunked tier (``_step_body``), whose
  counterpart is K15 (``ops/chunked.py``); the port's main path is the
  pair DP;
* ``dryrun_multichip(n)`` runs in each of ``n`` ranks of an initialised
  process group, factors ``n`` into ``n_dp × n_tp`` as the JAX dry run does
  (``n_tp = 2`` where ``n`` is even) and runs: stage 1, the dp sketch-count
  step (``parallel.mesh.sharded_sketch_count_step``: K10 and K11, a sum
  over dp) on reads cut from a haplotype whose sketch is the table,
  against a one-rank run of the same reads, with some matches; stage 2,
  one tp-sharded transition of the chunked tier
  (``parallel.mesh.sharded_dp_level_step``: K15's per-transition kernel
  on each tp rank's share of the destination pairs, one all-gather) on
  the widest level of ``mhc_slice_wide_csr.npz``, against the unshared
  transition (``chunked.chunk_step``) on this rank; stage 3, the chunked
  tier over all ``n`` ranks (``chunked.DeviceDiploidDP(mesh=)``) on
  ``mhc_slice_csr.npz`` against its baked exact-tier oracle, as the JAX
  dry run's stage 3; stages 4 and 5, the tp pair DP over all ``n`` ranks
  on ``mhc_slice_csr.npz`` and on ``mhc_slice_wide_csr.npz`` (15 wide
  levels through K4), against the same oracles.

The slices are read from the checkout's ``tests/data``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .device import resolve_device

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tests", "data")
CSR_KEYS = ("level_ptr", "adj_ptr", "adj_v", "adj_w", "hom_ptr",
            "hom_colors", "het_ptr", "het_colors")


def load_slice(name: str):
    """``(CSR arrays, R, (value, s_het, transitions))`` of a baked slice."""
    d = np.load(os.path.join(DATA, f"{name}.npz"))
    oracle = (int(d["oracle_value"]), int(d["oracle_shet"]),
              [tuple(int(x) for x in row) for row in d["oracle_transitions"]])
    return [d[k] for k in CSR_KEYS], int(d["R"]), oracle


def entry(device="cuda"):
    """``(fn, args)``: ``fn(*args)`` is K1 on the first narrow run of the
    MHC slice's plan from the initial state; it returns ``(V_out, bp256,
    bp1024)``."""
    from .ops.narrow import narrow_run
    from .ops.plan import initial_v, plan_pairs, plan_to_device

    dev = resolve_device(device)
    arrs, R, _ = load_slice("mhc_slice_csr")
    dplan = plan_to_device(plan_pairs(*arrs, R), dev)
    seg = next(s for s in dplan.segments if s.kind == "narrow")
    return narrow_run, (seg, initial_v(R, dev))


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """One dp × tp step of the pipeline in each of ``n_devices`` ranks (see
    the module docstring); raises where a stage disagrees."""
    import torch.distributed as dist

    from .ops import chunked
    from .ops.diploid_pair import PairDiploidDP
    from .ops.plan import plan_pairs
    from .ops.sketch import encode_reads
    from .ops.vertex_plan import K2, initial_state, plan_vertices, ship
    from .parallel.mesh import (
        make_mesh, sharded_dp_level_step, sharded_sketch_count_step,
    )
    from .sketch.minimizers import sketch_sequence

    dev = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) needs a process "
                           f"group of {n_devices} ranks, not {world}")
    n_tp = 2 if n_devices % 2 == 0 else 1
    n_dp = n_devices // n_tp
    mesh = make_mesh(n_dp=n_dp, n_tp=n_tp)

    # ---- stage 1: dp-sharded read sketching + a summed anchor count,
    # reads cut from a haplotype whose sketch is the table ----
    rng = np.random.default_rng(0)
    k, w = 11, 5
    hap = "".join(rng.choice(list("ACGT"), 2000))
    reads = [hap[s:s + 64] for s in rng.integers(0, 2000 - 64, 4 * n_dp)]
    codes, lens, _ = encode_reads(reads, 64)
    table = np.unique(sketch_sequence(hap, k, w).hashes)  # (hi, lo) order
    table_hi = (table >> np.uint64(32)).astype(np.uint32)
    table_lo = (table & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    counts, per_read = sharded_sketch_count_step(
        mesh, codes, lens, table_hi, table_lo, k, w, device=dev)
    one = sharded_sketch_count_step(None, codes, lens, table_hi, table_lo, k,
                                    w, device=dev)
    if per_read.shape != (len(reads),) or not (
            torch.equal(counts, one[0]) and torch.equal(per_read, one[1])):
        raise AssertionError("stage 1: the dp sketch count differs from one "
                             "rank's")
    if not 0 < int(counts.sum()) == int(per_read.sum()):
        raise AssertionError("stage 1: no read minimizer matched the table "
                             "(or the counts and per-read sums disagree)")

    # ---- stage 2: one tp-sharded chunked transition, the widest of the
    # wide slice, from the chunked state before it ----
    arrs, R, _ = load_slice("mhc_slice_wide_csr")
    plan = plan_vertices(*arrs)
    dev_t = ship(plan, dev)
    t = int(np.argmax(plan.desc[:, K2]))
    V0 = initial_state(R, int(plan.widths[0]), dev)
    V, SH = chunked.chunk_step(dev_t, 0, t, V0, torch.zeros_like(V0))
    V, SH = V.clone(), SH.clone()
    got = sharded_dp_level_step(mesh, dev_t, t, V, SH)
    k2 = int(plan.desc[t, K2])
    words = torch.empty((R + 1) * k2 * k2, dtype=torch.int32, device=dev)
    want = (*chunked.chunk_step(dev_t, t, t + 1, V, SH, words, [0]),
            words.view(R + 1, k2, k2))
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"stage 2: the tp-sharded transition {t} "
                             "differs from the unshared one")
    if not int((got[0] >= 0).sum()):
        raise AssertionError(f"stage 2: transition {t} reaches no state")

    # ---- stage 3: the chunked tier over all ranks; stages 4 and 5: the
    # tp pair DP; each against the baked exact-tier oracle ----
    tp_mesh = make_mesh(n_dp=1, n_tp=n_devices)
    arrs, R, oracle = load_slice("mhc_slice_csr")
    got = chunked.DeviceDiploidDP(plan_vertices(*arrs), R, dev,
                                  mesh=tp_mesh).run()
    if got != oracle:
        raise AssertionError(f"tp chunked tier on mhc_slice_csr: {got[:2]} "
                             f"differs from the exact tier's {oracle[:2]}")
    for name in ("mhc_slice_csr", "mhc_slice_wide_csr"):
        arrs, R, oracle = load_slice(name)
        got = PairDiploidDP(plan_pairs(*arrs, R), dev, mesh=tp_mesh).run()
        if got != oracle:
            raise AssertionError(f"tp pair DP on {name}: {got[:2]} differs "
                                 f"from the exact tier's {oracle[:2]}")
