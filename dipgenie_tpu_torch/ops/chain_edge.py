"""The edge-space level chain (K7 ``chain_edge``): the CUDA kernel and its
plain twin.

Replaces ``kernel`` / ``build`` of ``scripts/tpu_edge_probe.py``: the
transition of ``ops/chain_pair.py`` with the edge pairs formed inside the
kernel. The state ``V [19, 16, 16]`` int32 starts at 0 on ``(r, 0, 0)``
and ``NEG`` elsewhere. Per level and edge ``e``: ``rsel[e] = w * 16 +
src``, ``dst[e]``, ``valid[e]`` (columns 0..2 of ``tblc[t]``); per
destination vertex ``i``: its last edge ``laste[i]`` and ``hp[i]``,
whether it has one (columns 0..1 of ``tbl2c[t]``); ``S[t]`` scores the
edge pairs. With ``w(e) = rsel[e] // 16`` and ``src(e) = rsel[e] % 16``
the weight is folded into the gather, once per stage::

    A[r, e1, j]  = V[r - w(e1), src(e1), j]      (NEG where r < w(e1);
                                                  0 where valid[e1] = 0)
    G[r, e1, e2] = A[r - w(e2), e1, src(e2)]     (NEG where r < w(e2))
    cand = G + S[e1, e2]     unless S < -8192 or G < REACH_T

Edges of equal ``dst`` are contiguous. Destination ``(i2, j2)`` takes the
lexicographic max of ``(cand, tie)``, ``tie = (15 - e1) * 16 + (15 -
e2)``, over the edge pairs of the runs that end at ``laste[i2]`` and
``laste[j2]`` (none where ``hp`` is 0). The TPU kernel takes that max in
two stages, over ``e1`` and then over ``e2``; the order on ``(cand,
tie)`` is total, so one flat max over the pairs gives the same winner. A
value above ``REACH_T`` commits, else ``NEG``; the backpointer is the
winner's tie where the state was reached, else 0. ``rsel`` must lie in
``[0, 32)``, and ``hp[i]`` must be 1 exactly where ``laste[i] >= 0``, the
last edge of its run.

``tblr`` and ``tbl2r``, the transposes the TPU's layouts needed, are
taken and checked but not read. That check is a pass over the tables and a
host synchronisation: a caller that times the chain makes it once
(``check_twins``) and passes ``twins_checked=True``.
"""

from __future__ import annotations

import torch

from .. import kernels

R1, B, EB = 19, 16, 16
NEG = -(2**19)
REACH_T = -(2**18)
_NO_KEY = -(2**62)  # below every key


def _check(tblc, tblr, tbl2c, tbl2r, S) -> None:
    """Raise unless the five tables are int32 tensors of their shapes."""
    shapes = {"tblc": (EB, 8), "tblr": (8, EB), "tbl2c": (B, 4),
              "tbl2r": (4, B), "S": (EB, EB)}
    T = getattr(tblc, "shape", (None,))[0]
    for (name, shape), t in zip(shapes.items(),
                                (tblc, tblr, tbl2c, tbl2r, S)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
            raise ValueError(f"{name}: want an int32 tensor, got "
                             f"{getattr(t, 'dtype', type(t))}")
        if tuple(t.shape) != (T, *shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want "
                             f"{(T, *shape)}")


def check_twins(tblc, tblr, tbl2c, tbl2r) -> None:
    """Raise unless ``tblr`` / ``tbl2r`` are the transposes of ``tblc`` /
    ``tbl2c``."""
    if not (torch.equal(tblr, tblc.transpose(1, 2))
            and torch.equal(tbl2r, tbl2c.transpose(1, 2))):
        raise ValueError("tblr / tbl2r are not the transposes of tblc / "
                         "tbl2c")


def _runs(dst):
    """The run of equal ``dst`` each edge lies in."""
    return torch.cumsum(torch.cat([dst[:1] * 0, (dst[1:] != dst[:-1])
                                   .to(torch.int64)]), 0)


def chain_edge_ref(tblc, tblr, tbl2c, tbl2r, S):
    """Plain PyTorch version: ``(bp [T, 19, 16, 16] int16, V [19, 16, 16]
    int32)``."""
    _check(tblc, tblr, tbl2c, tbl2r, S)
    check_twins(tblc, tblr, tbl2c, tbl2r)
    T, dev = tblc.shape[0], tblc.device
    V = torch.full((R1, B, B), NEG, dtype=torch.int64, device=dev)
    V[:, 0, 0] = 0
    bp = torch.empty((T, R1, B, B), dtype=torch.int16, device=dev)
    e = torch.arange(EB, device=dev)
    tie = ((EB - 1 - e)[:, None] * EB + (EB - 1 - e)[None, :])[None]
    for t in range(T):
        rsel, dst, valid = tblc[t, :, :3].to(torch.int64).unbind(1)
        laste, hp = tbl2c[t, :, :2].to(torch.int64).unbind(1)
        St = S[t].to(torch.int64)[None]
        # the weight-folded gathers over [V[r], V[r - 1]], rows then columns
        negblk = torch.full_like(V[:1], NEG)
        vx = torch.cat([V, torch.cat([negblk, V[:-1]], 0)], 1)
        A = torch.where((valid > 0)[None, :, None], vx[:, rsel, :], 0)
        ax = torch.cat([A, torch.cat([torch.full_like(A[:1], NEG), A[:-1]],
                                     0)], 2)
        G = ax[:, :, rsel]
        key = torch.where((St < -8192) | (G < REACH_T), _NO_KEY,
                          (G + St) * 256 + tie)
        # member[i, e]: edge e lies in the run that ends at laste[i]
        run = _runs(dst)
        member = ((run[None, :] == run[laste.clamp(min=0)][:, None])
                  & ((hp > 0) & (laste >= 0))[:, None])
        y = torch.where(member[None, :, :, None], key[:, None], _NO_KEY
                        ).amax(dim=2)  # [r, i2, e2]
        best = torch.where(member[None, None], y[:, :, None, :], _NO_KEY
                           ).amax(dim=3)  # [r, i2, j2]
        value = best >> 8
        reach = (best != _NO_KEY) & (value > REACH_T)
        V = torch.where(reach, value, NEG)
        bp[t] = torch.where(reach, best & 255, 0).to(torch.int16)
    return bp, V.to(torch.int32)


def chain_edge(tblc, tblr, tbl2c, tbl2r, S, twins_checked=False):
    """K7. CUDA tensors launch ``csrc/chain_edge.cu`` (one launch per
    chain; the tables it reads 16-byte aligned); CPU tensors take
    ``chain_edge_ref``. ``twins_checked`` says
    that the caller has held these tables to ``check_twins``."""
    if tblc.device.type == "cpu":
        return chain_edge_ref(tblc, tblr, tbl2c, tbl2r, S)
    for name, t in (("tblc", tblc), ("tblr", tblr), ("tbl2c", tbl2c),
                    ("tbl2r", tbl2r), ("S", S)):
        kernels.check_tensor(t, name, torch.int32, None, tblc.device)
    _check(tblc, tblr, tbl2c, tbl2r, S)
    for name, t in (("tblc", tblc), ("tbl2c", tbl2c), ("S", S)):
        kernels.check_aligned(t, name)
    if not twins_checked:
        check_twins(tblc, tblr, tbl2c, tbl2r)
    T = tblc.shape[0]
    bp = torch.empty((T, R1, B, B), dtype=torch.int16, device=tblc.device)
    v = torch.empty((R1, B, B), dtype=torch.int32, device=tblc.device)
    rc = kernels.lib().dg_chain_edge(
        tblc.data_ptr(), tbl2c.data_ptr(), S.data_ptr(), T, bp.data_ptr(),
        v.data_ptr(), kernels.stream_of(tblc))
    kernels.raise_on_error(rc, "chain_edge")
    chain_edge.launches += 1
    return bp, v


chain_edge.launches = 0
