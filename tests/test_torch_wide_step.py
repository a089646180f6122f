"""dipgenie_tpu_torch K4 (one tp rank's partial of a wide transition)
against the JAX package's ``_wide_step_kernel`` (Pallas, interpret mode on
the CPU).

For each wide run of the corpus and each n_tp, both sides shard the run's
window-split chunks (``_shard_wide_tables`` / the port's
``shard_to_device``) and compute every (transition, device) partial from
the same state; the state then advances by the JAX package's merge (max
over devices, presence commit; ``_sharded_jit``). The input state of each
run is the JAX chain's. Exact equality (integers): the partial V on every
lane of rows 0..R, its backpointers wherever the partial V is not NEG. On
CPU tensors ``wide_step`` is its plain PyTorch version.
"""

import functools

import numpy as np
import pytest
import torch

from dipgenie_tpu.ops.diploid_pallas import (
    NEG, REACH_T, _r1p, _shard_wide_tables, _wide_step_call,
)
from dipgenie_tpu.solver.diploid import csr_arrays
from dipgenie_tpu_torch.ops.plan import shard_to_device
from dipgenie_tpu_torch.ops.wide_step import wide_step
from tests.test_torch_narrow import jax_segments, plans
from tests.test_torch_wide import HAND, WIDE_CASES, _csr_of
from tests.test_torch_wide_split import _dense


def _arrs(case):
    """(CSR arrays, R) of a case."""
    if case == "width140":
        g, chb = _dense(140)
        return list(csr_arrays(g, chb)), 2
    return _csr_of(case)


@functools.cache
def _jax_step(NB, C, R1):
    import jax

    return jax.jit(_wide_step_call(NB, C, R1, interpret=True))


def _jax_partials(seg, tabs, ti, V, R1):
    """The JAX kernel's (vpart, bppart) of every device for transition
    ``ti`` from the state ``V [R1P, NB * 1024]``."""
    sbits, swin, sbase, sgmask, tbl, _ = tabs[ti]
    call = _jax_step(seg.NB, sbits.shape[1], R1)
    return [[np.asarray(o) for o in call(sbits[d], swin[d], sbase[d],
                                         sgmask[d], tbl[d], V)]
            for d in range(sbits.shape[0])]


@pytest.mark.parametrize("case", WIDE_CASES + list(HAND)
                         + ["mhc_slice_wide_csr", "width140"])
def test_wide_step_matches_jax_kernel(case):
    arrs, R = _arrs(case)
    R1 = R + 1
    jplan, plan = plans(arrs, R)
    n_tps = (2,) if case == "width140" else (1, 2, 3, 8)
    n_steps = 0
    for i, seg, v_in, _ in jax_segments(jplan, split=True):
        if type(seg).__name__ != "_WideRun":
            continue
        for n_tp in n_tps:
            tabs = _shard_wide_tables(seg, n_tp)
            dsegs = [shard_to_device(plan.segments[i], n_tp, d, "cpu")
                     for d in range(n_tp)]
            V = np.full((_r1p(R1), seg.NB * 1024), NEG, np.int32)
            V[:, :1024] = v_in
            for ti in range(seg.t1 - seg.t0):
                jparts = _jax_partials(seg, tabs, ti, V, R1)
                for d, (jv, jbp) in enumerate(jparts):
                    part = wide_step(dsegs[d], ti,
                                     torch.from_numpy(V[:R1].copy())).numpy()
                    assert np.array_equal(part[0], jv[:R1]), (n_tp, ti, d)
                    live = part[0] != NEG
                    assert np.array_equal(part[1][live], jbp[:R1][live])
                    n_steps += 1
                # the JAX package's merge (_sharded_jit): max, commit
                vm = np.max([jv for jv, _ in jparts], axis=0)
                V = np.where((tabs[ti][5] > 0) & (vm > REACH_T), vm,
                             NEG).astype(np.int32)
    assert n_steps

