"""The port's pair DP as a whole (forward + traceback + assembly) against
the JAX package's ``PairDiploidDP`` (interpret mode), the exact numpy tier
and the baked oracles of the real MHC slices. On the CPU every kernel is
its plain PyTorch version. Results are integers: exact equality.
"""

import numpy as np
import pytest

from dipgenie_tpu.ops.diploid_pallas import PairDiploidDP as JaxPairDiploidDP
from dipgenie_tpu.solver.diploid import (
    _forward_exact, build_color_masks, csr_arrays,
)
from dipgenie_tpu_torch.ops.diploid_pair import PairDiploidDP, assemble
from dipgenie_tpu_torch.ops.fused import path_transitions
from dipgenie_tpu_torch.ops.plan import plan_pairs
from dipgenie_tpu_torch.solver.diploid import native_forward_csr
from dipgenie_tpu_torch.utils.synth import dp_states, mhc_shaped_csr
from tests.test_device_kernels import _random_leveled_graph
from tests.test_pallas_dp import CASES
from tests.test_torch_kernels_gpu import DATA, case_csr
from tests.test_torch_narrow import plans


@pytest.mark.parametrize("seed,L,kmax,R,nc", CASES)
def test_port_dp_matches_jax_and_exact(seed, L, kmax, R, nc):
    rng = np.random.default_rng(seed)
    g = _random_leveled_graph(rng, L=L, kmax=kmax, ncolors=nc)
    chb = [bool(x) for x in rng.random(nc) < 0.4]
    jplan, plan = plans(csr_arrays(g, chb), R)
    got = PairDiploidDP(plan, "cpu").run()
    Hm, Tm = build_color_masks(g, chb)
    assert got == _forward_exact(g, R, Hm, Tm)
    assert got == JaxPairDiploidDP(jplan, interpret=True).run()


@pytest.mark.parametrize(
    "name", ["mhc_slice_csr", "mhc_slice500_csr", "mhc_slice_wide_csr"])
def test_port_dp_matches_mhc_slice_oracle(name):
    arrs, R = case_csr(name)
    d = np.load(f"{DATA}/{name}.npz")
    want = (int(d["oracle_value"]), int(d["oracle_shet"]),
            [tuple(int(x) for x in row) for row in d["oracle_transitions"]])
    assert PairDiploidDP(plan_pairs(*arrs, R), "cpu").run() == want


def test_mhc_shaped_graph_matches_native_tier():
    """The scale generator's graph (cut to 3000 levels and 8 wide bands)
    through the port and the native C++ tier."""
    from dipgenie_tpu_torch import native

    assert native.available()
    arrs = mhc_shaped_csr(L=3000, seed=1, n_bands=8)
    assert dp_states(arrs[0], 18) > 10**7
    plan = plan_pairs(*arrs, 18)
    assert sum(type(s).__name__ == "_WideRun" for s in plan.segments) == 8
    got = PairDiploidDP(plan, "cpu").run()
    assert got[0] > 0 and got == native_forward_csr(arrs, 18)


def test_assemble_orders_records_by_level():
    recs = np.array([[1, 2, 3, 4, 1, 0, 5], [0, 1, 0, 0, 0, 1, 2]])
    assert assemble(9, recs) == (
        9, 7, [(1, 1, 2, 3, 4, 1, 0), (2, 0, 1, 0, 0, 0, 1)])


# the per-row builds that the columnar ones replaced, kept as their oracles
def assemble_by_rows(sink_value, recs):
    recs = np.asarray(recs, np.int64)
    shet = int(recs[:, 6].sum()) if len(recs) else 0
    transitions = [
        (t + 1, *(int(x) for x in row[:6])) for t, row in enumerate(recs)
    ]
    return sink_value, shet, transitions


def path_transitions_by_rows(rows):
    rows = np.asarray(rows, np.int64)
    T = len(rows)
    out = []
    for t in range(T):
        i2, j2 = (0, 0) if t == T - 1 else (int(rows[t + 1, 0]),
                                            int(rows[t + 1, 1]))
        a, b, wu, wv = (int(x) for x in rows[t])
        out.append((t + 1, a, b, i2, j2, wu, wv))
    return out


def int32_rows(T, width, seed):
    """Seeded int32 ``[T, width]`` rows over the whole int32 range, the
    first row at its ends and the last column within 100 of 2**31 - 1."""
    info = np.iinfo(np.int32)
    rng = np.random.default_rng(seed)
    rows = rng.integers(info.min, info.max, (T, width), dtype=np.int32,
                        endpoint=True)
    rows[:1, 0::2], rows[:1, 1::2] = info.min, info.max
    rows[:, -1] = info.max - rng.integers(0, 100, T)
    return rows


def assert_python_int_rows(transitions):
    assert type(transitions) is list
    for tr in transitions:
        assert type(tr) is tuple and len(tr) == 7
        assert all(type(x) is int for x in tr)


@pytest.mark.parametrize("T", [0, 1, 2, 65, 119_999])
def test_assemble_equals_the_per_row_build(T):
    recs = int32_rows(T, 7, seed=T)
    got = assemble(-5, recs)
    assert got == assemble_by_rows(-5, recs)
    value, shet, transitions = got
    assert type(value) is int and type(shet) is int
    assert_python_int_rows(transitions)
    assert [tr[0] for tr in transitions] == list(range(1, T + 1))
    if T >= 2:
        assert shet >= 2**31  # past what an int32 accumulator holds
    if T == 0:
        assert got == (-5, 0, [])


@pytest.mark.parametrize("T", [0, 1, 2, 65, 119_999])
def test_path_transitions_equals_the_per_row_build(T):
    rows = int32_rows(T, 4, seed=T + 1)
    got = path_transitions(rows)
    assert got == path_transitions_by_rows(rows)
    assert_python_int_rows(got)
    assert [tr[0] for tr in got] == list(range(1, T + 1))
    if T:
        assert got[-1][3:5] == (0, 0)
    else:
        assert got == []
