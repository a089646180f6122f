"""The pair-space level chain (K6 ``chain_pair``): the CUDA kernel and its
plain twin.

Replaces ``kernel`` / ``build`` of ``scripts/tpu_pair_probe.py``, the
direct ancestor of the narrow-run kernel (K1). The state ``V [19, 256]``
int32 over pair lanes ``i * 16 + j`` starts at 0 on lane 0 and ``NEG``
elsewhere. Level ``t`` reads rows gidx, sc, tie, seg, lastE and wsum of
``tbl[t]`` (``probes/tables.py:pair_tables``). For every row ``r`` and
edge-pair lane ``e``::

    cand[r, e] = V[r - wsum[e], gidx[e]]     (NEG where r < wsum[e])
    key[r, e]  = (cand + sc[e]) * 256 + tie[e]   unless cand < REACH_T

Lanes of equal ``seg`` are contiguous; destination pair ``d`` takes the
largest key of the run of lanes that ends at ``lastE[d]`` (none if
``lastE[d] < 0``): its value ``key >> 8`` commits if it is above
``REACH_T``, else ``NEG``, and the backpointer is the winner's tie code
``key & 255`` where the state was reached, else 0. With ``tie = 255 -
lane`` the earliest lane wins among equal values. ``lastE[d]`` must be
the last lane of its run or -1, ``tie`` must lie in ``[0, 256)`` and
``wsum`` in ``{0, 1, 2}`` (two edges' weights).

The TPU kernel packs the key into int32, exact for ``|cand + sc| <
2^22``; here the plain version's key is 64 bits wide and the kernel
compares the value, then the tie, as two 32-bit words: both give the same
result below that limit and stay exact above it.
"""

from __future__ import annotations

import torch

from .. import kernels

R1, NP2 = 19, 256
BP_ROWS = 24  # the TPU block's sublane padding; rows 19..23 are 0
NEG = -(2**19)
REACH_T = -(2**18)
_NO_KEY = -(2**62)  # below every key


def _check(tbl) -> None:
    if not isinstance(tbl, torch.Tensor) or tbl.dtype != torch.int32:
        raise ValueError("tbl: want an int32 tensor, got "
                         f"{getattr(tbl, 'dtype', type(tbl))}")
    if tbl.dim() != 3 or tuple(tbl.shape[1:]) != (8, NP2):
        raise ValueError(f"tbl: shape {tuple(tbl.shape)}, want (T, 8, 256)")


def chain_pair_ref(tbl: torch.Tensor):
    """Plain PyTorch version: ``(bp [T, 24, 256] int16, V [19, 256]
    int32)`` from ``tbl [T, 8, 256] int32``; rows 19..23 of ``bp`` are 0."""
    _check(tbl)
    T, dev = tbl.shape[0], tbl.device
    V = torch.full((R1, NP2), NEG, dtype=torch.int64, device=dev)
    V[:, 0] = 0
    bp = torch.zeros((T, BP_ROWS, NP2), dtype=torch.int16, device=dev)
    rows = torch.arange(R1, device=dev)[:, None]
    for t in range(T):
        gidx, sc, tie, seg, lastE, wsum = tbl[t, :6].to(torch.int64)
        src_row = rows - wsum[None, :]
        cand = torch.where(src_row >= 0,
                           V[src_row.clamp(min=0), gidx[None, :]], NEG)
        key = torch.where(cand < REACH_T, _NO_KEY,
                          (cand + sc[None, :]) * 256 + tie[None, :])
        # the run of equal seg each lane lies in, and each run's max key
        run = torch.cumsum(torch.cat([seg[:1] * 0, (seg[1:] != seg[:-1])
                                      .to(torch.int64)]), 0)
        run_max = torch.full((R1, NP2), _NO_KEY, dtype=torch.int64,
                             device=dev)
        run_max.scatter_reduce_(1, run[None, :].expand(R1, -1), key,
                                reduce="amax")
        best = torch.where((lastE >= 0)[None, :],
                           run_max[:, run[lastE.clamp(min=0)]], _NO_KEY)
        value = best >> 8
        reach = (best != _NO_KEY) & (value > REACH_T)
        V = torch.where(reach, value, NEG)
        bp[t, :R1] = torch.where(reach, best & 255, 0).to(torch.int16)
    return bp, V.to(torch.int32)


def chain_pair(tbl: torch.Tensor):
    """K6. A CUDA ``tbl`` launches ``csrc/chain_pair.cu`` (one launch per
    chain, which also zeroes the padding rows of ``bp``; ``tbl`` 16-byte
    aligned for its bulk copies); a CPU ``tbl`` takes ``chain_pair_ref``."""
    if tbl.device.type == "cpu":
        return chain_pair_ref(tbl)
    _check(tbl)
    kernels.check_tensor(tbl, "tbl", torch.int32)
    kernels.check_aligned(tbl, "tbl")
    T = tbl.shape[0]
    bp = torch.empty((T, BP_ROWS, NP2), dtype=torch.int16, device=tbl.device)
    v = torch.empty((R1, NP2), dtype=torch.int32, device=tbl.device)
    rc = kernels.lib().dg_chain_pair(
        tbl.data_ptr(), T, bp.data_ptr(), v.data_ptr(),
        kernels.stream_of(tbl))
    kernels.raise_on_error(rc, "chain_pair")
    chain_pair.launches += 1
    return bp, v


chain_pair.launches = 0
