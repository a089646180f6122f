"""dipgenie_tpu_torch K1 (narrow runs) against the JAX package's
``_narrow_kernel`` (Pallas, interpret mode on the CPU).

Every segment gets the same input state (the JAX chain's) on both sides;
on CPU tensors ``narrow_run`` is its plain PyTorch version. All values are
integers, so the tolerance is exact equality: V over rows 0..R and the
destination level's live extent (lanes past it are stale by design), and
backpointers at reachable states (elsewhere the JAX kernel's are
arbitrary). Reachability comes from an independent numpy propagation.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dipgenie_tpu.ops.diploid_pallas import (
    NEG, _narrow_call, _NarrowRun, _r1p, _wide_call, _wide_split_call,
)
from dipgenie_tpu.ops.diploid_pallas import plan_pairs as jax_plan_pairs
from dipgenie_tpu_torch.ops.narrow import (
    SHARED_LIMIT, narrow_run, narrow_run_global, narrow_run_ref, smem_bytes,
    state_in_shared,
)
from dipgenie_tpu_torch.ops.plan import initial_v, plan_pairs, plan_to_device
from dipgenie_tpu_torch.utils.synth import (
    CASES, GLOBAL_STATE_CASE, random_leveled_csr,
)
from tests.test_torch_kernels_gpu import case_csr

# the CASES whose plans hold narrow runs only (seeds 400-501 have wide
# levels)
NARROW_CASES = [c for c in CASES if not 400 <= c[0] < 600]


def assert_same_plan(jplan, plan):
    """The JAX planner's plan and the port's are equal field for field:
    same segment classes (by name), scalars and arrays (dtype and value)."""
    assert (jplan.R, jplan.L, jplan.max_abs_value) == (
        plan.R, plan.L, plan.max_abs_value)
    assert len(jplan.segments) == len(plan.segments)
    for js, ps in zip(jplan.segments, plan.segments):
        assert type(js).__name__ == type(ps).__name__
        names = [f.name for f in dataclasses.fields(ps)]
        assert names == [f.name for f in dataclasses.fields(js)]
        for name in names:
            a, b = getattr(js, name), getattr(ps, name)
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b), name
            else:
                assert a == b, name


def plans(arrs, R):
    """(JAX plan, port plan) of the same CSR arrays, asserted equal."""
    jplan, plan = jax_plan_pairs(*arrs, R), plan_pairs(*arrs, R)
    assert_same_plan(jplan, plan)
    return jplan, plan


def jax_segments(jplan, split=False):
    """Each segment of a JAX plan through the JAX kernels (interpret
    mode), chained: yields (segment index, segment, V_in [R1P, 1024], JAX
    outputs). ``split`` runs every wide run through the window-split
    kernel, whatever its NB (every wide run has window-split tables)."""
    import jax

    R1 = jplan.R + 1
    V = np.full((_r1p(R1), 1024), NEG, np.int32)
    V[:, 0] = 0
    for i, seg in enumerate(jplan.segments):
        if isinstance(seg, _NarrowRun):
            out = jax.jit(_narrow_call(seg, R1, interpret=True))(
                seg.sbits, seg.sbase, seg.r256, seg.r1024, seg.tbl, V)
        elif split:
            out = jax.jit(_wide_split_call(seg, R1, interpret=True))(
                seg.wbits, seg.wwin, seg.wpmask, seg.wbase, seg.wgmask,
                seg.wrow, seg.tbl, V)
        else:
            out = jax.jit(_wide_call(seg, R1, interpret=True))(
                seg.dbits, seg.dfmask, seg.dcmask, seg.dgmask, seg.dpmask,
                seg.dtrans, seg.dwbase, seg.dtbl, V)
        out = [np.asarray(o) for o in out]
        yield i, seg, V, out
        V = out[-1]


def reach_masks(seg, reach, R1):
    """Per transition of a segment, the reachable states [R1, lanes] after
    it, from the reachable input states [R1, 1024] (numpy, independent of
    both DP implementations; wide runs are read from their dense
    tables)."""
    narrow = type(seg).__name__ == "_NarrowRun"
    if narrow:
        tbl, bounds = seg.tbl, np.append(seg.tb_chunkbase,
                                         np.count_nonzero(seg.sbits & 16))
        state = reach.copy()
    else:
        tbl, bounds = seg.dtbl, np.append(seg.tb2_chunkbase,
                                          np.count_nonzero(seg.dbits & 4))
        state = np.zeros((R1, seg.NB * 1024), bool)
        state[:, :1024] = reach
    masks = []
    for ti in range(seg.t1 - seg.t0):
        c0, c1 = bounds[ti], bounds[ti + 1]
        packed = tbl[c0:c1, 0].ravel().astype(np.int64)
        if narrow:
            dst = ((packed >> 2) & 2047) - 1
            real = dst >= 0
            gidx = packed >> 13
            out = 256 * (((int(seg.sbits[c0]) >> 7) & 3) + 1)
        else:
            real = tbl[c0:c1, 1].ravel() != -(2**22)
            dst = (packed >> 2) & 32767
            gidx = (packed >> 17) & 32767
            out = state.shape[1]
        wsum = packed & 3
        nxt = np.zeros((R1, out), bool)
        for w in range(3):
            sel = real & (wsum == w)
            for r in range(w, R1):
                np.logical_or.at(nxt[r], dst[sel], state[r - w, gidx[sel]])
        state[:, :out] = nxt
        masks.append(nxt)
    return masks, state[:, :1024]


@pytest.mark.parametrize("case", NARROW_CASES + ["mhc_slice_csr"])
def test_narrow_run_matches_jax_kernel(case):
    arrs, R = case_csr(case)
    R1 = R + 1
    widths = np.diff(arrs[0])
    jplan, plan = plans(arrs, R)
    dplan = plan_to_device(plan, "cpu")
    reach = np.zeros((R1, 1024), bool)
    reach[:, 0] = True
    n_narrow = 0
    for i, seg, v_in, out in jax_segments(jplan):
        masks, reach_next = reach_masks(seg, reach, R1)
        if isinstance(seg, _NarrowRun):
            n_narrow += 1
            jb256, jb1024, jv = out
            V, pb256, pb1024 = narrow_run(
                dplan.segments[i], torch.from_numpy(v_in[:R1].copy()))
            ext = int(widths[seg.t1]) ** 2
            assert np.array_equal(V.numpy()[:, :ext], jv[:R1, :ext])
            assert np.array_equal(V.numpy()[:, :ext] > -(2**18),
                                  reach_next[:, :ext])
            for ti, m in enumerate(masks):
                row = int(seg.tb_bprow[ti])
                out_l = m.shape[1]
                jb, pb = ((jb1024, pb1024) if seg.tb_bits[ti] & 2
                          else (jb256, pb256))
                assert np.array_equal(jb[row, :R1, :out_l][m],
                                      pb.numpy()[row, :, :out_l][m]), ti
        reach = reach_next
    assert n_narrow


def desc_of(seg):
    """K1's per-transition descriptors of a narrow run, computed
    transition by transition from the plan's arrays: (rows, lanes)."""
    nreal = int(np.count_nonzero(seg.sbits & 16))
    bounds = np.append(seg.tb_chunkbase, nreal)
    rows, lanes = [], 256
    for ti in range(seg.t1 - seg.t0):
        c0, c1 = int(bounds[ti]), int(bounds[ti + 1])
        dst = ((seg.tbl[c0:c1, 0].ravel() >> 2) & 2047) - 1
        n = int(np.count_nonzero(dst >= 0))
        assert (dst[:n] >= 0).all() and (dst[n:] < 0).all()  # pads last
        out = 256 * (((int(seg.sbits[c0]) >> 7) & 3) + 1)
        src = 256 * ((int(seg.sbits[c0]) & 3) + 1)
        assert bool(int(seg.tb_bits[ti]) & 2) == (out > 256)
        ndst = int(seg.tb_bout[ti]) ** 2  # real destination pair lanes
        assert n == 0 or ((dst[:n] >= 0) & (dst[:n] < ndst)).all()
        rows.append([c0, n, out + ndst * 65536, int(seg.tb_bprow[ti])])
        lanes = max(lanes, out, src)
    return rows, lanes


@pytest.mark.parametrize("case", [(0, 12, 5, 5, 8), (401, 10, 40, 4, 8),
                                  "mhc_slice_wide_csr", (700, 8, 32, 5, 8)])
def test_plan_to_device_round_trips_every_array(case):
    """Every numpy array of every segment arrives on the device unchanged;
    a narrow run also carries K1's descriptors (``tb_desc``) and its widest
    extent (``lanes``), which the planner does not make."""
    arrs, R = case_csr(case)
    plan = plan_pairs(*arrs, R)
    dplan = plan_to_device(plan, "cpu")
    assert (dplan.R, dplan.L) == (plan.R, plan.L)
    for seg, dseg in zip(plan.segments, dplan.segments):
        assert dseg.host is seg
        names = [f for f, v in vars(seg).items() if isinstance(v, np.ndarray)]
        made = ["tb_desc"] if dseg.kind == "narrow" else []
        assert sorted(names + made) == sorted(dseg.t)
        for name in names:
            a, t = getattr(seg, name), dseg.t[name]
            assert t.numpy().dtype == a.dtype and np.array_equal(t.numpy(), a)
        if made:
            rows, lanes = desc_of(seg)
            desc = dseg.t["tb_desc"].numpy()
            assert desc.dtype == np.int32 and desc.tolist() == rows
            assert dseg.lanes == lanes


def most_pairs_into_one_destination(seg):
    """(pairs, whether they span more than one chunk, pairs of that
    transition) of the destination that takes the most pairs in a narrow
    run."""
    nreal = int(np.count_nonzero(seg.sbits & 16))
    bounds = np.append(seg.tb_chunkbase, nreal)
    best = (0, False, 0)
    for ti in range(seg.t1 - seg.t0):
        dst = ((seg.tbl[bounds[ti]:bounds[ti + 1], 0].ravel() >> 2)
               & 2047) - 1
        real = dst[dst >= 0]
        if not len(real):
            continue
        d = int(np.bincount(real).argmax())
        lanes = np.flatnonzero(dst == d)
        assert np.array_equal(lanes, np.arange(lanes[0], lanes[-1] + 1))
        best = max(best, (len(lanes), bool(lanes[0] // 256 != lanes[-1] // 256),
                          len(real)))
    return best


def test_a_case_sends_more_than_a_chunk_into_one_destination():
    """CASES holds a narrow-only instance where one destination takes more
    than 256 pairs, one contiguous range that crosses a chunk boundary, in a
    transition of more than the 2,048 pairs K1 stages in shared memory."""
    case = (700, 8, 32, 5, 8)
    assert case in CASES and case in NARROW_CASES
    arrs, R = case_csr(case)
    plan = plan_pairs(*arrs, R)
    assert {type(s).__name__ for s in plan.segments} == {"_NarrowRun"}
    pairs, crosses, n = max(most_pairs_into_one_destination(s)
                            for s in plan.segments)
    assert pairs > 256 and crosses and n > 2048


def test_k1_keeps_v_in_global_memory_only_where_shared_cannot_hold_it():
    """K1's state path by shape: the run of GLOBAL_STATE_CASE (widths to
    30, so 1,024 lanes) keeps V [61, 1024] in global memory; at the R of
    the JAX tests, and at R = 18 on 1,024 lanes, V is in shared memory."""
    seed, L, kmax, R, nc = GLOBAL_STATE_CASE
    arrs = random_leveled_csr(seed, L, kmax, nc)
    for r, want in ((R, False), (4, True), (18, True)):
        dplan = plan_to_device(plan_pairs(*arrs, r), "cpu")
        narrow = [s for s in dplan.segments if s.kind == "narrow"]
        assert max(s.lanes for s in narrow) == 1024
        assert min(state_in_shared(s, r + 1) for s in narrow) is want
    assert smem_bytes(19, 1024, True) <= SHARED_LIMIT < smem_bytes(
        61, 1024, True)
    # on CPU tensors both wrappers are the plain version
    seg = narrow[0]
    v = initial_v(18, "cpu")
    for got in (narrow_run(seg, v), narrow_run_global(seg, v)):
        for g, w in zip(got, narrow_run_ref(seg, v)):
            assert torch.equal(g, w)


def test_random_leveled_csr_matches_test_generator():
    """synth.random_leveled_csr draws the instances of the JAX package's
    tests (graph + colour split) and emits their csr_arrays."""
    from dipgenie_tpu_torch.solver.diploid import csr_arrays
    from tests.test_device_kernels import _random_leveled_graph

    for seed, L, kmax, _, nc in NARROW_CASES[::3] + [(401, 10, 40, 4, 8)]:
        rng = np.random.default_rng(seed)
        g = _random_leveled_graph(rng, L=L, kmax=kmax, ncolors=nc)
        chb = [bool(x) for x in rng.random(nc) < 0.4]
        for a, b in zip(csr_arrays(g, chb), random_leveled_csr(seed, L, kmax, nc)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
