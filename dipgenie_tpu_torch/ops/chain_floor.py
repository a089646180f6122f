"""The floor probes' level chains (K5a ``chain_floor``, K5b
``chain_step16``): the CUDA kernels and their plain twins.

Replace ``build_pallas0`` and ``build_pallas16`` of
``scripts/tpu_floor_probe.py``. Both walk ``T`` levels with a state
carried from level to level and a backpointer block written per level:

* ``chain_floor`` is the empty body: ``acc += tbl[t]`` (int32, wrapping),
  ``bp[t] = acc & 0x7FFF`` as int16: 1,024 independent prefix sums along
  ``T``, which the kernel takes as one scan over the card, in chunks of
  ``FLOOR_CHUNK`` levels, a block of ``FLOOR_THREADS`` threads a chunk,
  each chunk's carry from a look-back over ``FLOOR_LOOK`` chunks at a time
  (``csrc/chain_floor.cu``).
* ``chain_step16`` is a DP-shaped body at ``B = 16``, ``P = 4``: the state
  ``V [19 * 16, 16]`` int32 (row ``r * 16 + i``, column ``j``) starts at 0
  on ``(r, 0, 0)`` and ``NEG`` elsewhere. With ``Vsh[r] = V[r - 1]``
  (``NEG`` at ``r = 0``), for every ``p, q < 4``::

      u = pi[p, i2]        A[r, i2, j1] = (pw[p, u] ? Vsh : V)[r, u, j1]
      v = pi[q, j2]        G[r, i2, j2] = (pw[q, v] ? Ash : A)[r, i2, v]
      key = G * 16 + C[p * 16 + i2, q * 16 + j2]

  (``Ash[r] = A[r - 1]``, ``NEG`` at ``r = 0``; the weight is looked up at
  the source index, and there is no validity mask). ``best`` is the max of
  the 16 keys and of ``-2^31 + 1``; ``V' = best >> 4`` where that is above
  ``-2^18``, else ``NEG``; ``bp = best & 15``. A source ``pi`` outside
  ``[0, 16)`` gathers ``NEG`` (the TPU kernel's selects match none). It is
  a floor probe with a DP-shaped body, not a checked DP; the port computes
  what the probe computes.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import kernels

R1, B, P = 19, 16, 4
FLOOR_LANES = 8 * 128  # K5a's prefix sums
FLOOR_CHUNK = 48  # K5a's levels a block (csrc/chain_floor.cu CHUNK)
FLOOR_THREADS = 256  # K5a's threads a block, 4 lanes each (THREADS)
FLOOR_LOOK = 8  # chunks a look-back step of K5a reads (LOOK)
NEG = -(2**19)
_BEST0 = -(2**31) + 1


def _check(t, name, shape) -> None:
    """Raise unless ``t`` is an int32 tensor ``[T, *shape]``."""
    if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
        raise ValueError(f"{name}: want an int32 tensor, got "
                         f"{getattr(t, 'dtype', type(t))}")
    if t.dim() != len(shape) + 1 or tuple(t.shape[1:]) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want "
                         f"(T, {', '.join(map(str, shape))})")


def chain_floor_ref(tbl: torch.Tensor):
    """Plain PyTorch version: ``(bp [T, 8, 128] int16, acc [8, 128]
    int32)`` from ``tbl [T, 8, 128] int32``."""
    _check(tbl, "tbl", (8, 128))
    acc = torch.zeros((8, 128), dtype=torch.int32, device=tbl.device)
    bp = torch.empty(tbl.shape, dtype=torch.int16, device=tbl.device)
    for t in range(tbl.shape[0]):
        acc = acc + tbl[t]
        bp[t] = (acc & 0x7FFF).to(torch.int16)
    return bp, acc


def floor_chunks(T: int) -> int:
    """K5a's chunks (blocks) for a chain of ``T`` levels: one chunk of no
    level where ``T = 0``, which writes ``acc = 0``."""
    return max(-(-T // FLOOR_CHUNK), 1)


def chain_floor(tbl: torch.Tensor):
    """K5a. A CUDA ``tbl`` (16-byte aligned: the kernel loads 16 bytes a
    thread) launches ``csrc/chain_floor.cu``, one launch per chain after
    the zeroing of its status words and ticket; a CPU ``tbl`` takes
    ``chain_floor_ref``."""
    if tbl.device.type == "cpu":
        return chain_floor_ref(tbl)
    _check(tbl, "tbl", (8, 128))
    kernels.check_tensor(tbl, "tbl", torch.int32)
    kernels.check_aligned(tbl, "tbl")
    T, dev = tbl.shape[0], tbl.device
    chunks = floor_chunks(T)
    bp = torch.empty(tbl.shape, dtype=torch.int16, device=dev)
    acc = torch.empty((8, 128), dtype=torch.int32, device=dev)
    status = torch.zeros(1 + chunks * FLOOR_THREADS, dtype=torch.int32,
                         device=dev)
    sums = torch.empty(2 * chunks * FLOOR_LANES, dtype=torch.int32,
                       device=dev)
    rc = kernels.lib().dg_chain_floor(
        tbl.data_ptr(), T, bp.data_ptr(), acc.data_ptr(), status.data_ptr(),
        sums.data_ptr(), kernels.stream_of(tbl))
    kernels.raise_on_error(rc, "chain_floor")
    chain_floor.launches += 1
    return bp, acc


chain_floor.launches = 0


def _shift_rows(x: torch.Tensor) -> torch.Tensor:
    """``x[r - 1]`` along the first axis, ``NEG`` at ``r = 0``."""
    return torch.cat([torch.full_like(x[:1], NEG), x[:-1]], 0)


def _check_step16(pit, pwt, C) -> None:
    _check(pit, "pit", (8, 128))
    _check(pwt, "pwt", (8, 128))
    _check(C, "C", (P * B, P * B))
    if not pit.shape[0] == pwt.shape[0] == C.shape[0]:
        raise ValueError("pit, pwt and C differ in T: "
                         f"{pit.shape[0]}, {pwt.shape[0]}, {C.shape[0]}")


def chain_step16_ref(pit, pwt, C):
    """Plain PyTorch version: ``(bp [T, 304, 16] int16, V [304, 16]
    int32)`` from ``pit, pwt [T, 8, 128]`` and ``C [T, 64, 64]`` int32."""
    _check_step16(pit, pwt, C)
    T, dev = pit.shape[0], pit.device
    V = torch.full((R1, B, B), NEG, dtype=torch.int32, device=dev)
    V[:, 0, 0] = 0
    bp = torch.empty((T, R1 * B, B), dtype=torch.int16, device=dev)
    for t in range(T):
        pi = pit[t, :P, :B].to(torch.int64)
        # a source outside [0, 16) matches none of the TPU kernel's selects
        # and gathers NEG
        ok = (pi >= 0) & (pi < B)
        pi = pi.clamp(0, B - 1)
        pw = pwt[t, :P, :B]
        Ct = C[t].reshape(P, B, P, B)
        Vsh = _shift_rows(V)
        best = torch.full((R1, B, B), _BEST0, dtype=torch.int32, device=dev)
        for p in range(P):
            u = pi[p]
            wu = (pw[p][u] > 0)[None, :, None]
            A = torch.where(wu, Vsh[:, u, :], V[:, u, :])
            A = torch.where(ok[p][None, :, None], A, NEG)
            Ash = _shift_rows(A)
            for q in range(P):
                v = pi[q]
                wv = (pw[q][v] > 0)[None, None, :]
                G = torch.where(wv, Ash[:, :, v], A[:, :, v])
                G = torch.where(ok[q][None, None, :], G, NEG)
                best = torch.maximum(best, G * 16 + Ct[p, :, q, :][None])
        Vn = best >> 4
        V = torch.where(Vn > -(2**18), Vn, NEG)
        bp[t] = (best & 15).to(torch.int16).reshape(R1 * B, B)
    return bp, V.reshape(R1 * B, B)


@functools.cache
def step16_fit(device_index: int) -> tuple[int, int, int, int]:
    """``(clusters, blocks, threads, shared bytes)``: how many of K5b's
    clusters the card holds at once, and the cluster's shape. Raises when
    it holds none."""
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device_index):
        rc = kernels.lib().dg_chain_step16_fit(out)
    kernels.raise_on_error(rc, "chain_step16 (cluster fit)")
    fit = tuple(out)
    if fit[0] < 1:
        raise RuntimeError(
            f"chain_step16: a cluster of {fit[1]} blocks of {fit[2]} threads "
            f"and {fit[3]} bytes of shared memory does not fit on "
            f"{torch.cuda.get_device_name(device_index)} "
            f"(cudaOccupancyMaxActiveClusters: {fit[0]})")
    return fit


def chain_step16(pit, pwt, C):
    """K5b. CUDA tensors launch ``csrc/chain_step16.cu`` (one cluster
    launch per chain); CPU tensors take ``chain_step16_ref``. Besides the
    backpointers it returns the final state, which the TPU kernel kept in
    scratch."""
    if pit.device.type == "cpu":
        return chain_step16_ref(pit, pwt, C)
    _check_step16(pit, pwt, C)
    for name, t in (("pit", pit), ("pwt", pwt), ("C", C)):
        kernels.check_tensor(t, name, torch.int32, None, pit.device)
        kernels.check_aligned(t, name)
    step16_fit(pit.device.index)
    T = pit.shape[0]
    bp = torch.empty((T, R1 * B, B), dtype=torch.int16, device=pit.device)
    v = torch.empty((R1 * B, B), dtype=torch.int32, device=pit.device)
    rc = kernels.lib().dg_chain_step16(
        pit.data_ptr(), pwt.data_ptr(), C.data_ptr(), T, bp.data_ptr(),
        v.data_ptr(), kernels.stream_of(pit))
    kernels.raise_on_error(rc, "chain_step16")
    chain_step16.launches += 1
    return bp, v


chain_step16.launches = 0
