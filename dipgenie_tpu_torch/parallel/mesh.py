"""Multi-process meshes over ``torch.distributed``.

Counterpart of ``dipgenie_tpu/parallel/mesh.py``, whose ``make_mesh``
shapes the devices of one JAX process into a ``("dp", "tp")`` grid. Here
every device is a process (a rank) of an initialised default process
group: ``torchrun`` with NCCL and one rank per card, or ranks started by
the caller (gloo for ranks that share a card or run on the CPU). The rank
``dp * n_tp + tp`` holds grid cell ``(dp, tp)``, the order of JAX's
``reshape(n_dp, n_tp)``.

Axes:

* **tp**, for the chunked tier (``ops/chunked.py:chunk_step_tp``): every
  wide transition's destination pairs are split into equal shares, one a
  tp rank; each rank runs K15's per-transition kernel on its share against
  the replicated state, and one all-gather over the tp group
  (``all_gather_equal``) collects V', SH' and the replay's words. Runs of
  narrow transitions and the walk run on every rank.
* **tp**, for the pair DP: its wide runs. Every 1024-lane destination window of
  a wide transition is owned by one tp rank (``win % n_tp``); each rank
  computes its windows' partial state with K4 against the replicated
  state and the partials merge with one ``all_reduce(MAX)`` over the tp
  group (``ops/wide_step.py:wide_tp_run``), on the group's backend: NCCL
  on the card, gloo on the CPU or for ranks sharing one card (gloo
  stages CUDA tensors through host memory itself). Narrow runs and the
  traceback run on every rank, so every rank returns the same result.
* **dp**: the reads of device sketching. Each dp rank sketches a
  contiguous share of the reads with K10 (``ops/sketch.py``):
  ``sketch_reads_device(mesh=)`` gathers the per-read sets over the dp
  group, and ``sharded_sketch_count_step`` matches the share's emitted
  minimizers against a replicated sorted table with K11
  (``csrc/sketch_count.cu``) and merges the per-slot counts with one
  ``all_reduce(SUM)`` over dp. Host sketching ignores the axis, as the JAX
  package does with ``sketch_backend="host"``.

There is no single-process stand-in: without an initialised process
group ``make_mesh`` raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from .. import kernels
from ..device import resolve_device


@dataclass(frozen=True)
class Mesh:
    n_dp: int
    n_tp: int
    tp_rank: int
    dp_rank: int
    tp: object  # this rank's tp process group
    dp: object  # this rank's dp process group


def make_mesh(n_dp: int | None = None, n_tp: int = 1) -> Mesh:
    """The ``(n_dp, n_tp)`` mesh of the default process group's ranks.
    ``n_dp`` defaults to ``world_size // n_tp``. Raises without an
    initialised group, and when the world size is not ``n_dp * n_tp``.
    Every rank must call it (``dist.new_group`` is collective)."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised torch.distributed process group "
            "(torchrun, or dist.init_process_group in every rank)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_tp < 1:
        raise ValueError(f"n_tp = {n_tp}, want >= 1")
    if n_dp is None:
        n_dp = world // n_tp
    if n_dp * n_tp != world:
        raise ValueError(f"mesh {n_dp}x{n_tp} needs {n_dp * n_tp} ranks, "
                         f"the process group has {world}")
    dp_rank, tp_rank = divmod(rank, n_tp)
    tp = dp = None
    for d in range(n_dp):  # every rank creates every group, in one order
        g = dist.new_group([d * n_tp + t for t in range(n_tp)])
        if d == dp_rank:
            tp = g
    for t in range(n_tp):
        g = dist.new_group([d * n_tp + t for d in range(n_dp)])
        if t == tp_rank:
            dp = g
    return Mesh(n_dp=n_dp, n_tp=n_tp, tp_rank=tp_rank, dp_rank=dp_rank,
                tp=tp, dp=dp)


def u32_tensor(a, device) -> torch.Tensor:
    """A u32 table as an int32 tensor of its bit patterns on ``device``
    (numpy uint32 arrays are viewed, tensors moved)."""
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))
    return a.to(device).contiguous()


def _check_count(hash_hi, hash_lo, emit, table_hi, table_lo) -> None:
    for name, t in (("hash_hi", hash_hi), ("hash_lo", hash_lo)):
        if t.dtype != torch.int32 or t.shape != emit.shape:
            raise ValueError(f"{name}: want int32 {tuple(emit.shape)}")
    if emit.dtype != torch.bool or emit.dim() != 2:
        raise ValueError("emit: want a [B, NW] bool tensor")
    if table_hi.dtype != torch.int32 or table_lo.dtype != torch.int32 \
            or table_hi.dim() != 1 or table_hi.shape != table_lo.shape:
        raise ValueError("table_hi / table_lo: want int32 [M] tensors")


def sketch_count_ref(hash_hi, hash_lo, emit, table_hi, table_lo,
                     max_dup: int = 4):
    """Plain PyTorch version of K11: ``(counts [M], per_read [B])`` int32
    of the emitted windows ``(hash_hi, hash_lo)`` ([B, NW], u32 bit
    patterns in int32, as ``ops.sketch.batch_minimizer`` gives them)
    matched against the table sorted by unsigned ``(hi, lo)``: the lower
    bound of hi, then at most ``max_dup`` slots for an equal pair, the
    first hit winning (``dipgenie_tpu/parallel/mesh.py:66-72``)."""
    _check_count(hash_hi, hash_lo, emit, table_hi, table_lo)
    M = table_hi.shape[0]
    B = emit.shape[0]
    dev = emit.device
    thi = table_hi.to(torch.int64) & 0xFFFFFFFF
    tlo = table_lo.to(torch.int64) & 0xFFFFFFFF
    hh = hash_hi.to(torch.int64) & 0xFFFFFFFF
    hl = hash_lo.to(torch.int64) & 0xFFFFFFFF
    if M == 0:
        return (torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros(B, dtype=torch.int32, device=dev))
    start = torch.searchsorted(thi, hh.reshape(-1), side="left").reshape(
        hh.shape)
    slot = torch.full(hh.shape, -1, dtype=torch.int64, device=dev)
    for d in range(max_dup):
        idx = (start + d).clamp(0, M - 1)
        ok = (start + d < M) & (thi[idx] == hh) & (tlo[idx] == hl)
        slot = torch.where((slot < 0) & ok, idx, slot)
    matched = emit & (slot >= 0)
    counts = torch.bincount(slot[matched], minlength=M).to(torch.int32)
    return counts, matched.sum(1).to(torch.int32)


def bucket_bits(M: int) -> int:
    """Bits of K11's bucket index over a table of ``M`` slots: ``2^bits``
    buckets, the fewest that are at least ``M`` (1 to 26)."""
    return min(max((M - 1).bit_length(), 1), 26)


def bucket_index_ref(table_hi: torch.Tensor, bits: int) -> torch.Tensor:
    """Plain version of K11's bucket index: ``off [2^bits + 1]`` int32,
    ``off[b]`` the first slot of the sorted ``table_hi`` (u32 bit patterns
    in int32) whose ``hi >> (32 - bits)`` is at least ``b``; the lower
    bound of a hash ``hh`` lies in ``[off[b], off[b + 1]]`` for ``b = hh
    >> (32 - bits)``."""
    bucket = (table_hi.to(torch.int64) & 0xFFFFFFFF) >> (32 - bits)
    per = torch.bincount(bucket, minlength=1 << bits)
    off = torch.zeros((1 << bits) + 1, dtype=torch.int64,
                      device=table_hi.device)
    off[1:] = torch.cumsum(per, 0)
    return off.to(torch.int32)


def sketch_count(hash_hi, hash_lo, emit, table_hi, table_lo,
                 max_dup: int = 4):
    """K11. CUDA tensors launch ``csrc/sketch_count.cu`` (one call: the
    bucket index over the table and its (hi, lo) pairs, then the lookups
    of the emitted windows); CPU tensors take ``sketch_count_ref``."""
    if emit.device.type == "cpu":
        return sketch_count_ref(hash_hi, hash_lo, emit, table_hi, table_lo,
                                max_dup)
    _check_count(hash_hi, hash_lo, emit, table_hi, table_lo)
    for name, t in (("hash_hi", hash_hi), ("hash_lo", hash_lo),
                    ("table_hi", table_hi), ("table_lo", table_lo)):
        kernels.check_tensor(t, name, torch.int32, None, emit.device)
    kernels.check_tensor(emit, "emit", torch.bool)
    B, NW = emit.shape
    M = table_hi.shape[0]
    dev = emit.device
    if M == 0 or NW == 0:
        return (torch.zeros(M, dtype=torch.int32, device=dev),
                torch.zeros(B, dtype=torch.int32, device=dev))
    # both zeroed in the call
    counts = torch.empty(M, dtype=torch.int32, device=dev)
    per_read = torch.empty(B, dtype=torch.int32, device=dev)
    # scratch: the bucket index [2^bits + 1], then (8-aligned) the table's
    # (hi, lo) pairs [M, 2]
    bits = bucket_bits(M)
    at = (1 << bits) + 2
    scratch = torch.empty(at + 2 * M, dtype=torch.int32, device=dev)
    rc = kernels.lib().dg_sketch_count(
        hash_hi.data_ptr(), hash_lo.data_ptr(), emit.data_ptr(), B, NW,
        table_hi.data_ptr(), table_lo.data_ptr(), M, max_dup, bits,
        scratch.data_ptr(), scratch.data_ptr() + 4 * at, counts.data_ptr(),
        per_read.data_ptr(), kernels.stream_of(emit))
    kernels.raise_on_error(rc, "sketch_count")
    sketch_count.launches += 1
    return counts, per_read


sketch_count.launches = 0


def all_gather_equal(t: torch.Tensor, group) -> torch.Tensor:
    """``[n, *t.shape]``: the group's ranks' ``t`` (the same shape on every
    rank) stacked in rank order, on ``t``'s device. One collective: under
    gloo staged through host memory (the copy to the host waits for
    ``t``'s stream; a CUDA tensor goes through pinned buffers, which
    PyTorch's host allocator keeps for the next call, and comes back by
    an asynchronous copy), under NCCL on the card."""
    n = dist.get_world_size(group)
    if dist.get_backend(group) == "gloo":
        pin = t.is_cuda
        src = torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
        src.copy_(t)
        out = torch.empty((n, *t.shape), dtype=t.dtype, pin_memory=pin)
        dist.all_gather(list(out.unbind(0)), src, group=group)
        return out.to(t.device, non_blocking=pin)
    out = torch.empty((n, *t.shape), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out


def all_gather_cat(t: torch.Tensor, group) -> torch.Tensor:
    """The group's ranks' ``t`` concatenated in rank order, on ``t``'s
    device (through host memory where the group is gloo's)."""
    src = t.cpu() if dist.get_backend(group) == "gloo" else t
    parts = [torch.empty_like(src)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src.contiguous(), group=group)
    return torch.cat(parts).to(t.device)


def sharded_sketch_count_step(mesh, codes, lens, table_hi, table_lo, k: int,
                              w: int, max_dup: int = 4, device="cuda"):
    """Data-parallel sketch and anchor count with a sum over dp. ``codes
    [B, L]`` uint8 and ``lens [B]`` (numpy or tensors; B divisible by the
    mesh's ``n_dp``) are every rank's global reads, ``table_hi`` /
    ``table_lo`` the replicated haplotype minimizer hashes sorted by
    unsigned ``(hi, lo)`` (numpy uint32, or int32 tensors of their bits).
    Each dp rank runs K10 and K11 on its contiguous share of the rows; the
    counts merge with ``all_reduce(SUM)`` over ``mesh.dp`` and the per-read
    counts are gathered over it. Returns ``(counts [M], per_read [B])``
    int32 on ``device``, the same on every rank. ``mesh=None`` runs every
    row in this process."""
    from ..ops.sketch import batch_minimizer

    dev = resolve_device(device)
    codes = torch.as_tensor(codes).to(dev)
    lens = torch.as_tensor(lens).to(device=dev, dtype=torch.int32)
    B = codes.shape[0]
    n_dp = 1 if mesh is None else mesh.n_dp
    if B % n_dp:
        raise ValueError(f"{B} reads do not split over {n_dp} dp ranks")
    lo = 0 if mesh is None else mesh.dp_rank * (B // n_dp)
    rows = slice(lo, lo + B // n_dp)
    hh, hl, emit, _ = batch_minimizer(codes[rows].contiguous(),
                                      lens[rows].contiguous(), k, w)
    counts, per_read = sketch_count(hh, hl, emit, u32_tensor(table_hi, dev),
                                    u32_tensor(table_lo, dev), max_dup)
    if n_dp > 1:
        dist.all_reduce(counts, dist.ReduceOp.SUM, group=mesh.dp)
        per_read = all_gather_cat(per_read, mesh.dp)
    return counts, per_read


def sharded_dp_level_step(mesh, dev, t: int, V: torch.Tensor,
                          SH: torch.Tensor):
    """One chunked-tier transition ``t`` (``ops/chunked.py``, K15) with its
    destination pairs split over the tp ranks of ``mesh``: each rank runs
    the per-transition kernel on its share of the ``k2 * k2`` pairs and one
    all-gather over ``mesh.tp`` puts the shares together. ``dev`` is the
    plan's ``DevTables``, ``(V, SH)`` the replicated ``[R+1, k, k]`` int32
    states before it. Returns ``(V', SH', words)``, each ``[R+1, k2, k2]``
    int32, the same on every rank (``words`` the packed backpointers)."""
    from ..ops.chunked import chunk_step_tp
    from ..ops.vertex_plan import K2

    R1, k2 = V.shape[0], int(dev.desc[t, K2])
    words = torch.empty(R1 * k2 * k2, dtype=torch.int32, device=V.device)
    # a per-transition launch whatever the transition's width
    cut = np.array([[t, t + 1, 0]], np.int64)
    V2, SH2 = chunk_step_tp(dev, t, t + 1, V, SH, mesh, words, [0], cut=cut)
    return V2, SH2, words.view(R1, k2, k2)
