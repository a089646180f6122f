"""The sketch kernels' plain versions at the block shapes and lookups of
their CUDA kernels (K10 ``csrc/sketch.cu``, K11 ``csrc/sketch_count.cu``),
on the CPU, held to the JAX package.

* K10's plain version against ``batch_minimizer_kernel`` on 150 bp rows
  at ``(k, w)`` = (17, 7), (32, 3) and (5, 1), and at the row lengths where a
  kernel block's windows meet a row's end (one window a row; 256 and 257
  windows; rows shorter than 16 bases);
* K11's bucket index (plain version) against ``torch.searchsorted``: its
  bucket starts, and the lower bound of every hash searched inside its
  bucket, on the adversarial tables of ``utils/synth.count_tables`` and
  on hashes at the ends of the range;
* ``sketch_count_ref`` against JAX's ``sharded_sketch_count_step`` (on a
  one-device CPU mesh, jitted) on those tables, with ``max_dup`` 0, 1, 4
  and with no emitted window, and against a host truth on the edge
  hashes.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dipgenie_tpu.ops import sketch_jax
from dipgenie_tpu.parallel import mesh as jax_mesh
from dipgenie_tpu_torch.ops import sketch
from dipgenie_tpu_torch.parallel import mesh as pmesh
from dipgenie_tpu_torch.utils.synth import (
    count_tables, edge_hashes, ragged_reads,
)

# (k, w, B, L): 150 bp rows; L = k + w - 1 (one window a row); 256 and 257
# windows a row (L = 256 + k + w - 2 and one more); rows of 9 bases, where
# a block's 16-aligned start reaches back over rows. JAX takes minutes to
# compile its kernel at the CLI's (31, 25), so k 17 stands in for it.
SHAPES = [(17, 7, 40, 150), (32, 3, 40, 150), (5, 1, 40, 150),
          (17, 7, 70, 17 + 7 - 1), (17, 7, 9, 256 + 17 + 7 - 2),
          (17, 7, 9, 256 + 17 + 7 - 1), (5, 1, 40, 9)]


@pytest.mark.parametrize("k,w,B,L", SHAPES)
def test_plain_sketch_equals_jax_kernel_at_block_shapes(k, w, B, L):
    codes, lens = ragged_reads(k * 1000 + L, B, L, k, w)
    want = jax.jit(partial(sketch_jax.batch_minimizer_kernel, k=k, w=w))(
        jnp.asarray(codes), jnp.asarray(lens))
    got = sketch.batch_minimizer_ref(torch.from_numpy(codes),
                                     torch.from_numpy(lens), k, w)
    for g, x in zip(got[:2], want[:2]):
        assert np.array_equal(g.numpy().view(np.uint32), np.asarray(x))
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))
    assert np.array_equal(got[3].numpy(), np.asarray(want[3]))
    assert got[2].any()


# the reads of the count checks: 150 bp rows at k 17, w 7
K, W = 17, 7


@pytest.fixture(scope="module")
def count_reads():
    codes, lens = ragged_reads(11, 32, 150, K, W)
    hh, hl, emit, _ = sketch.batch_minimizer_ref(
        torch.from_numpy(codes), torch.from_numpy(lens), K, W)
    return codes, lens, hh.numpy(), hl.numpy(), emit.numpy()


def _tables(count_reads):
    _, _, hh, hl, emit = count_reads
    return count_tables(hh, hl, emit, 5)


TABLES = ("mixed", "full_bucket", "lonely", "edges", "m1", "one_read")


def _table(count_reads, name):
    return next(t for t in _tables(count_reads) if t[0] == name)


def _u32(a) -> np.ndarray:
    return np.asarray(a).view(np.uint32).astype(np.int64)


@pytest.mark.parametrize("name", TABLES)
def test_bucket_index_equals_searchsorted(count_reads, name):
    """off[b] is the lower bound of b << (32 - bits); every hash's lower
    bound, searched inside its bucket, is searchsorted's."""
    _, _, hh, hl, emit = count_reads
    _, t_hi, _, _ = _table(count_reads, name)
    thi = torch.from_numpy(t_hi.astype(np.int64))
    e_hi, _ = edge_hashes(hh, hl, emit)
    rng = np.random.default_rng(0)
    q = np.concatenate([_u32(e_hi[emit]), t_hi, t_hi + 1, t_hi - 1,
                        [0, 1, 2**31, 2**32 - 2, 2**32 - 1],
                        rng.integers(0, 2**32, 2000)]).astype(np.int64)
    q = torch.from_numpy(q.clip(0, 2**32 - 1))
    M = len(t_hi)
    for bits in sorted({1, pmesh.bucket_bits(M), 12}):
        off = pmesh.bucket_index_ref(pmesh.u32_tensor(t_hi, "cpu"), bits)
        assert off.dtype == torch.int32 and off.shape == ((1 << bits) + 1,)
        starts = torch.arange((1 << bits) + 1, dtype=torch.int64) \
            << (32 - bits)
        assert torch.equal(off.long(), torch.searchsorted(thi, starts))
        b = q >> (32 - bits)
        lo, hi = off.long()[b], off.long()[b + 1]
        while bool((lo < hi).any()):  # bisection inside each bucket
            mid = (lo + hi) // 2
            below = (lo < hi) & (thi[mid.clamp(max=M - 1)] < q)
            lo = torch.where(below, mid + 1, lo)
            hi = torch.where((lo < hi) & ~below, mid, hi)
        assert torch.equal(lo, torch.searchsorted(thi, q))
    # the tables' edges at the kernel's bits: a bucket past its scan of 8
    # slots; a hit whose bucket's neighbours are empty
    bits = pmesh.bucket_bits(M)
    per = np.diff(pmesh.bucket_index_ref(pmesh.u32_tensor(t_hi, "cpu"),
                                         bits).numpy())
    if name == "full_bucket":
        assert per.max() > 8
    if name == "lonely":
        b = int(t_hi[0]) >> (32 - bits)
        assert per[b] == 1 and per[b - 1] == per[b + 1] == 0


def _jax_step(codes, lens, t_hi, t_lo, max_dup):
    mesh = jax_mesh.make_mesh(n_dp=1, n_tp=1)
    c, p = jax.jit(lambda *a: jax_mesh.sharded_sketch_count_step(
        mesh, *a, K, W, max_dup))(jnp.asarray(codes), jnp.asarray(lens),
                                  jnp.asarray(t_hi), jnp.asarray(t_lo))
    return np.asarray(c), np.asarray(p)


CASES = [(name, d) for name in TABLES
         for d in ((4, 1, 0) if name == "mixed" else (4,))] + [("none", 4)]


@pytest.mark.parametrize("name,max_dup", CASES)
def test_sketch_count_ref_equals_jax_step(count_reads, name, max_dup):
    codes, lens, hh, hl, emit = count_reads
    if name == "none":  # no emitted window: every row empty
        _, t_hi, t_lo, _ = _table(count_reads, "mixed")
        lens = np.zeros_like(lens)
        emit = np.zeros_like(emit)
    else:
        _, t_hi, t_lo, _ = _table(count_reads, name)
    want = _jax_step(codes, lens, t_hi, t_lo, max_dup)
    got = pmesh.sketch_count_ref(
        *(torch.from_numpy(a) for a in (hh, hl, emit)),
        pmesh.u32_tensor(t_hi, "cpu"), pmesh.u32_tensor(t_lo, "cpu"),
        max_dup)
    assert np.array_equal(got[0].numpy(), want[0])
    assert np.array_equal(got[1].numpy(), want[1])
    hits = int(want[0].sum())
    assert hits == int(want[1].sum())
    assert (hits == 0) == (name == "none" or max_dup == 0)
    if name == "one_read":
        assert np.count_nonzero(want[1]) == 1


def _truth(hh, hl, emit, t_hi, t_lo, max_dup):
    """Per window: a hit where the first slot equal to its (hi, lo) lies
    fewer than max_dup slots past the first slot of its hi."""
    thi, tlo = t_hi.astype(np.int64), t_lo.astype(np.int64)
    counts = np.zeros(len(thi), np.int32)
    per_read = np.zeros(emit.shape[0], np.int32)
    for r, c in zip(*np.nonzero(emit)):
        a, b = int(_u32(hh[r, c])), int(_u32(hl[r, c]))
        eq = np.nonzero((thi == a) & (tlo == b))[0]
        if len(eq) and eq[0] - np.searchsorted(thi, a) < max_dup:
            counts[eq[0]] += 1
            per_read[r] += 1
    return counts, per_read


@pytest.mark.parametrize("name", TABLES)
def test_sketch_count_ref_on_edge_hashes(count_reads, name):
    """Hashes of hi 0 and 0xFFFFFFFF against every table."""
    _, _, hh, hl, emit = count_reads
    e_hi, e_lo = edge_hashes(hh, hl, emit)
    _, t_hi, t_lo, dups = _table(count_reads, name)
    for max_dup in dups:
        got = pmesh.sketch_count_ref(
            *(torch.from_numpy(a) for a in (e_hi.view(np.int32),
                                            e_lo.view(np.int32), emit)),
            pmesh.u32_tensor(t_hi, "cpu"), pmesh.u32_tensor(t_lo, "cpu"),
            max_dup)
        want = _truth(e_hi, e_lo, emit, t_hi, t_lo, max_dup)
        assert np.array_equal(got[0].numpy(), want[0])
        assert np.array_equal(got[1].numpy(), want[1])
    if name == "edges":
        assert int(got[0].sum()) >= 6  # six of the eight edge hashes hit
