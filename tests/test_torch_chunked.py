"""The port's chunked tier (``ops/chunked.py``, ``--dp-backend jax``)
against the JAX package's (``dipgenie_tpu/ops/diploid_jax.py``) on the
CPU: the program against ``_build_program``, K15's plain version against
``_step_body`` on single transitions (P <= 4 unrolled, P > 4 through the
``fori_loop``): V, SH and the packed backpointers; K16's against
``_trace_fn`` on the same words; the whole tier against
``DeviceDiploidDP`` and the MHC slice's baked oracle; and where the JAX
chunked tier raises (a level 600 wide, an in-degree of 36: its clamping
buckets), the exact tier. Every comparison is of integers: exact
equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dipgenie_tpu.ops import diploid_jax as jd
from dipgenie_tpu.solver.diploid import _forward_exact, build_color_masks
from dipgenie_tpu_torch.ops import chunked, fused
from dipgenie_tpu_torch.ops.pair_plan import PlanLimit
from dipgenie_tpu_torch.ops.vertex_plan import (
    NEG, initial_state, plan_vertices, ship,
)
from dipgenie_tpu_torch.solver.diploid import csr_arrays
from dipgenie_tpu_torch.utils import synth
from tests.test_torch_fused import indeg36_graph, width600_graph
from tests.test_torch_kernels_gpu import DATA, case_csr
from tests.test_torch_vertex_plan import random_case


@pytest.mark.parametrize("case", ["mhc_slice500_csr", 0])
def test_program_matches_build_program(case):
    """The same ops, in order: kind and real transitions (the JAX ops'
    no-op padding rows left out)."""
    arrs, R = random_case(case) if isinstance(case, int) else case_csr(case)
    jdp = jd.DeviceDiploidDP(jd.plan_transitions(*arrs), R)
    ops = chunked.build_program(plan_vertices(*arrs).desc)
    assert [(o.kind, list(range(o.t0, o.t1))) for o in ops] == [
        (o.kind, [r for r in o.rows if r >= 0]) for o in jdp.ops]
    assert {o.kind for o in ops} == {"scan", "big"}


@pytest.mark.parametrize("widths,deg,P", [([1, 4, 6, 5, 4], 1, 4),
                                          ([1, 12, 10, 9, 1], 8, 16)])
def test_transition_matches_step_body(widths, deg, P):
    """K15's plain version on each transition from random states (V and
    SH) equals ``_step_body`` with its tables padded to (B, P, W): V, SH
    and the packed backpointer of every state."""
    rng = np.random.default_rng(sum(widths) + deg)
    g = synth.dense_graph(rng, widths, deg=deg)
    arrs, R = csr_arrays(g, [True, False, False, True, False, True]), 3
    R1 = R + 1
    jts = jd.plan_transitions(*arrs)
    plan = plan_vertices(*arrs)
    dev = ship(plan, "cpu")
    assert int(plan.desc[:, 2].max()) <= P
    for t, jt in enumerate(jts):
        k, k2 = jt.k, jt.k2
        B = max(k, k2)
        val = rng.integers(0, 1000, (R1, B, B))
        dead = rng.random((R1, B, B)) < 0.33
        sh = rng.integers(0, 50, (R1, B, B))
        vj = np.where(dead, jd.NEG_INF, val).astype(np.int32)
        xs = tuple(jnp.asarray(a) for a in jd._pad_fields(
            jt, B, P, jt.Hl.shape[1]))
        (jv, jsh), jbp = jd._step_body(
            R, P, (jnp.asarray(vj), jnp.asarray(sh.astype(np.int32))), xs)
        jv, jsh, jbp = (np.asarray(a)[:, :k2, :k2] for a in (jv, jsh, jbp))

        vp = torch.from_numpy(np.where(dead, NEG, val)[:, :k, :k].astype(
            np.int32))
        shp = torch.from_numpy(sh[:, :k, :k].astype(np.int32))
        bp = torch.zeros(R1 * k2 * k2, dtype=torch.int32)
        v2, sh2 = chunked.chunk_step_ref(dev, t, t + 1, vp, shp, bp, [0])
        v2, sh2 = v2.numpy(), sh2.numpy()
        reach = v2 >= 0
        assert np.array_equal(reach, jv > jd.VALID_T), t
        assert np.array_equal(v2[reach], jv[reach]), t
        assert np.array_equal(sh2[reach], jsh[reach]), t
        assert (sh2[~reach] == 0).all()
        assert np.array_equal(bp.numpy().reshape(R1, k2, k2), jbp), t


@pytest.mark.parametrize("seed", [0, 3])
def test_walker_matches_trace_fn(seed):
    """K16's plain version and ``_trace_fn`` on the same replayed words
    (each transition's [R+1, k2, k2] block, padded to B for the JAX
    walker): the same rows and carry, the plan cut into two spans."""
    arrs, R = random_case(seed)
    plan = plan_vertices(*arrs)
    dev = ship(plan, "cpu")
    k2s = plan.desc[:, 1]
    sizes = (R + 1) * k2s ** 2
    off = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    bp = torch.zeros(int(sizes.sum()), dtype=torch.int32)
    V = initial_state(R, 1, "cpu")
    chunked.chunk_step_ref(dev, 0, plan.T, V, torch.zeros_like(V), bp, off)
    B = int(k2s.max())
    ys = np.zeros((plan.T, R + 1, B, B), np.int32)
    words = bp.numpy()
    for t, k2 in enumerate(k2s):
        ys[t, :, :k2, :k2] = words[off[t]:off[t] + sizes[t]].reshape(
            R + 1, k2, k2)
    jdp = jd.DeviceDiploidDP(jd.plan_transitions(*arrs), R)
    carry = torch.tensor([0, 0, R], dtype=torch.int32)
    jcarry = jnp.asarray([0, 0, R], jnp.int32)
    rows = torch.zeros((plan.T, 4), dtype=torch.int32)
    cut = plan.T // 2
    woff = torch.from_numpy(chunked.word_offsets(plan.desc, R + 1))
    for t0, t1 in ((cut, plan.T), (0, cut)):
        chunked.chunk_trace_ref(dev, woff, t0, t1, bp[int(off[t0]):], carry,
                                rows[t0:t1])
        jcarry, jrows = jdp._trace_fn(t1 - t0)(jnp.asarray(ys[t0:t1]),
                                               jcarry)
        assert np.array_equal(rows[t0:t1].numpy(), np.asarray(jrows))
        assert carry.tolist() == np.asarray(jcarry).tolist()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_chunked_tier_matches_jax_chunked_tier(seed):
    """Also with spans of one op and ops of three transitions, so that the
    replay crosses many checkpoints."""
    arrs, R = random_case(seed)
    want = jd.DeviceDiploidDP(jd.plan_transitions(*arrs), R).run()
    plan = plan_vertices(*arrs)
    assert chunked.DeviceDiploidDP(plan, R, "cpu").run() == want
    assert chunked.DeviceDiploidDP(plan, R, "cpu", ckpt_every=1,
                                   chunk=3).run() == want


def test_chunked_tier_matches_mhc_slice_oracle():
    arrs, R = case_csr("mhc_slice_csr")
    d = np.load(f"{DATA}/mhc_slice_csr.npz")
    want = (int(d["oracle_value"]), int(d["oracle_shet"]),
            [tuple(int(x) for x in row) for row in d["oracle_transitions"]])
    assert chunked.DeviceDiploidDP(plan_vertices(*arrs), R, "cpu").run() \
        == want


@pytest.mark.parametrize("name,msg", [
    ("width600", r"shape \(600,1\) into shape \(512,1\)"),
    ("indeg36", r"shape \(2,36\) into shape \(2,32\)")])
def test_chunked_tier_where_jax_buckets_clamp(name, msg):
    """The JAX chunked tier clamps to its last bucket and raises
    (``diploid_jax.py:60-64``, ``:148-165``); the port equals the exact
    tier."""
    g, chb = (width600_graph if name == "width600" else indeg36_graph)()
    arrs, R = csr_arrays(g, chb), 3
    with pytest.raises(ValueError, match=msg):
        jd.DeviceDiploidDP(jd.plan_transitions(*arrs), R).run()
    got = chunked.DeviceDiploidDP(plan_vertices(*arrs), R, "cpu").run()
    assert got == _forward_exact(g, R, *build_color_masks(g, chb))


def test_memory_limit(monkeypatch):
    """Checkpoints, the largest span's backpointers and the state buffers:
    with exactly that much free the tier runs, with one byte less it
    raises before the forward (the free bytes patched: the CPU sets no
    limit)."""
    arrs, R = case_csr("mhc_slice_csr")
    plan = plan_vertices(*arrs)
    dp = chunked.DeviceDiploidDP(plan, R, "cpu", ckpt_every=2, chunk=4)
    need = dp.need_bytes()
    assert len(dp.spans) > 3 and need > max(
        dp.span_bytes(*sp) for sp in dp.spans)
    want = chunked.DeviceDiploidDP(plan, R, "cpu").run()
    monkeypatch.setattr(fused, "free_bytes", lambda device: need)
    assert chunked.DeviceDiploidDP(plan, R, "cpu", ckpt_every=2,
                                   chunk=4).run() == want
    monkeypatch.setattr(fused, "free_bytes", lambda device: need - 1)
    with pytest.raises(PlanLimit, match=f"needs {need} B .* past the "
                       f"{need - 1} B free; use --dp-backend native"):
        chunked.DeviceDiploidDP(plan, R, "cpu", ckpt_every=2,
                                chunk=4).run()
