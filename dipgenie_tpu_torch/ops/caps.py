"""The capability checks (K8 ``scripts/tpu_caps_probe.py``, K9
``scripts/tpu_caps_probe2.py``): 30 CUDA kernels and their plain twins.

Each TPU check is one tiny Pallas call that asked whether Mosaic lowers
one primitive (a lane gather, a roll, a DMA at a run-time offset, a batched
dot, ...). Its counterpart here asks the same of the Hopper primitive that
stands for it (``__shfl_sync``, shared-memory staging, ``cp.async.bulk``
and TMA with ``mbarrier``s, ``mma.sync``): ``csrc/caps_gather.cu``,
``caps_layout.cu``, ``caps_bulk.cu`` and ``caps_mma.cu``, one C entry point
``dg_caps(check, in0, in1, out, arg, stream)`` with the check ids of
``csrc/caps.cuh``, in the order of ``NAMES``.

``CHECKS[name]`` is ``(wrapper, plain version)``. The wrapper takes the
check's inputs at the scripts' shapes and types (a ``uint32`` input as its
``int32`` view, the indices as the scripts' ``int32``) and returns a new
output tensor. CUDA tensors launch the kernel (one launch per call,
counted in ``wrapper.launches``) or raise; CPU tensors take the plain
version. Every output is exact: the float products take small integers.

A check's launches are ~1 us of device time each, so the host's work per
call sets how fast a run of them goes. What does not change between
calls is made once per check (``wrapper.record``: the id, the inputs' and
output's ``(dtype, shape)``, the argument; ``wrapper.launch``, a
``kernels.Launch``, binds ``dg_caps`` at first use); a call reads tensor
attributes, allocates the output, and reads the current stream's raw
handle.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels

R1 = 19
_I32, _I16, _F32 = torch.int32, torch.int16, torch.float32


def _dyn_slice_row_bcast(a):
    # the row index stays on the device: no host read of A[0, 0]
    row = a.index_select(0, (a[0, 0] % 16).reshape(1))
    return row.expand(16, 256).contiguous()


def _popcount(a):
    # bit k of an int32 word is (a >> k) & 1, also with bit 31 set
    return sum((a >> k) & 1 for k in range(32)).to(_I32)


def _switch(b, a):
    branch = min(max(int(b[0]), 0), 2)  # lax.switch clamps its index
    if branch != 1:
        return a + 1 if branch == 0 else a - 3
    out = a.clone()
    out[:, :8, :8] *= 2
    return out


def _concat_plus(a, dim):
    return torch.cat([a, a + 1], dim)


def _where_rows(a):
    rows = torch.arange(16, device=a.device)[None, :, None]
    return torch.where(rows < 8, a, -1)


def _onehot(sel):
    cols = torch.arange(32, dtype=_I32, device=sel.device)[None, :]
    return (cols == sel).to(_F32)


# name -> (inputs as ((dtype, shape), ...), output (dtype, shape), plain
# version, the kernel's int argument). In the order of csrc/caps.cuh.
SPECS = {
    "lane_gather_taa_grouped": (
        ((_I32, (16, 256)), (_I32, (16, 256))), (_I32, (16, 256)),
        lambda a, i: torch.gather(a, 1, i.long()), 0),
    "lane_gather_cross_vreg": (
        ((_I32, (16, 256)), (_I32, (16, 256))), (_I32, (16, 256)),
        lambda a, i: torch.gather(a, 1, i.long()), 0),
    "sublane_gather_8": (
        ((_I32, (8, 128)), (_I32, (8, 128))), (_I32, (8, 128)),
        lambda a, i: torch.gather(a, 0, i.long()), 0),
    "sublane_gather_16": (
        ((_I32, (16, 128)), (_I32, (16, 128))), (_I32, (16, 128)),
        lambda a, i: torch.gather(a, 0, i.long()), 0),
    "roll_lane": (
        ((_I32, (16, 256)),), (_I32, (16, 256)),
        lambda a: torch.roll(a, 16, 1), 0),
    "roll_sublane": (
        ((_I32, (24, 256)),), (_I32, (24, 256)),
        lambda a: torch.roll(a, 1, 0), 0),
    "lane_bcast_col": (
        ((_I32, (16, 1)),), (_I32, (16, 256)),
        lambda a: a.expand(16, 256).contiguous(), 0),
    "sublane_bcast_row": (
        ((_I32, (1, 256)),), (_I32, (16, 256)),
        lambda a: a.expand(16, 256).contiguous(), 0),
    "tile_lane_concat": (
        ((_I32, (16, 16)),), (_I32, (16, 304)),
        lambda a: a.repeat(1, 19), 0),
    "dyn_slice_row_bcast": (
        ((_I32, (16, 256)),), (_I32, (16, 256)), _dyn_slice_row_bcast, 0),
    # the kernel's argument is the first row of the slice A[8:24]
    "manual_dma_dynoff": (
        ((_I32, (64, 128)),), (_I32, (16, 128)),
        lambda a: a[8:24] + 1, 8),
    "scalar_prefetch_grid": (
        ((_I32, (8,)), (_I32, (8, 8, 128))), (_I32, (8, 8, 128)),
        lambda sel, a: a.index_select(0, sel), 0),
    "popcount": (((_I32, (16, 256)),), (_I32, (16, 256)), _popcount, 0),
    "strided_slice_lane": (
        ((_I32, (16, 304)),), (_I32, (16, 19)),
        lambda a: a[:, 3::16].contiguous(), 0),
    "reshape_lane_groups": (
        ((_I32, (16, 304)),), (_I32, (16, 19, 16)),
        lambda a: a.reshape(16, 19, 16).clone(), 0),
    "batched_dot_3d": (
        ((_F32, (R1, 16, 32)), (_F32, (R1, 32, 16))), (_F32, (R1, 16, 16)),
        torch.bmm, 0),
    "batched_dot_bcast_lhs": (
        ((_F32, (16, 32)), (_F32, (R1, 32, 16))), (_F32, (R1, 16, 16)),
        torch.matmul, 0),
    "concat3d_ax0": (
        ((_I32, (R1, 16, 16)),), (_I32, (R1, 16, 16)),
        lambda a: torch.cat([torch.full_like(a[:1], -7), a[:R1 - 1]], 0), 0),
    "concat3d_ax1": (
        ((_I32, (R1, 16, 16)),), (_I32, (R1, 32, 16)),
        lambda a: _concat_plus(a, 1), 0),
    "concat3d_ax2": (
        ((_I32, (R1, 16, 16)),), (_I32, (R1, 16, 32)),
        lambda a: _concat_plus(a, 2), 0),
    "roll3d_ax1": (
        ((_I32, (R1, 16, 16)),), (_I32, (R1, 16, 16)),
        lambda a: torch.roll(a, 4, 1), 0),
    "roll3d_ax2": (
        ((_I32, (R1, 16, 16)),), (_I32, (R1, 16, 16)),
        lambda a: torch.roll(a, 4, 2), 0),
    # .to(int32) truncates toward zero, as numpy's astype does
    "convert_f32_i32_3d": (
        ((_F32, (R1, 16, 16)),), (_I32, (R1, 16, 16)),
        lambda a: a.to(_I32) * 2, 0),
    "iota_onehot_build": (((_I32, (16, 1)),), (_F32, (16, 32)), _onehot, 0),
    "where3d_iota_mask": (
        ((_I32, (R1, 16, 16)),), (_I32, (R1, 16, 16)), _where_rows, 0),
    "transpose2d": (
        ((_F32, (304, 16)),), (_F32, (16, 304)),
        lambda a: a.t().contiguous(), 0),
    # the kernel's argument is the slab A[2]
    "dma_strided_3d": (
        ((_I16, (4, R1, 16, 16)),), (_I16, (R1, 8, 8)),
        lambda a: a[2, :, :8, :8] + 1, 2),
    "switch_compute": (
        ((_I32, (1,)), (_I32, (R1, 16, 16))), (_I32, (R1, 16, 16)),
        _switch, 0),
    "dma_in_when": (
        ((_I32, (4, 8, 128)),), (_I32, (8, 128)),
        lambda a: a[2].clone(), 2),
    "dot2d_f32": (
        ((_F32, (64, 32)), (_F32, (32, 304))), (_F32, (64, 304)),
        torch.matmul, 0),
}
NAMES = tuple(SPECS)  # a check's id in csrc/caps.cuh is its index here


class Record(NamedTuple):
    """What every launch of a check shares, made once: its id in
    ``csrc/caps.cuh``, its inputs' and output's ``(dtype, shape)``, and
    the kernel's int argument."""
    check: int
    ins: tuple
    out: tuple
    arg: int


def _wrapper(name):
    ins, out_spec, plain, arg = SPECS[name]
    record = Record(NAMES.index(name), ins, out_spec, arg)
    launch = kernels.Launch(name, "dg_caps", ins, out_spec)
    check_id, two = record.check, len(ins) == 2
    (dt0, sh0), (dt1, sh1) = ins[0], ins[-1]
    raw_stream = kernels.raw_stream

    def run(d, ts, p0, p1):
        out = launch.empty(d, ts)
        rc = (launch._fn or launch.fn())(check_id, p0, p1, out.data_ptr(),
                                         arg, raw_stream(d))
        if rc:
            kernels.raise_on_error(rc, name)
        wrapper.launches += 1
        return out

    def checked(ts):
        """The plain version for CPU tensors, else every check with its
        message (``launch.check``), then the launch."""
        try:
            on_cpu = not ts[0].is_cuda and not (two and ts[-1].is_cuda)
        except (IndexError, AttributeError):
            on_cpu = False  # launch.check says what is wrong
        if on_cpu:
            if len(ts) != len(ins):
                raise ValueError(f"{name}: takes {len(ins)} tensors, got "
                                 f"{len(ts)}")
            return plain(*ts)
        d, ptrs = launch.check(ts)
        return run(d, ts, ptrs[0], ptrs[1] if two else None)

    def wrapper(*ts):
        # what launch.check would find, as bare attribute reads; anything
        # else (CPU tensors, a wrong input) takes the checked path
        if len(ts) == len(ins):
            a, b = ts[0], ts[-1]
            if (a.is_cuda and a.dtype is dt0 and a.shape == sh0
                    and a.is_contiguous() and not (p0 := a.data_ptr()) & 15):
                d, p1 = a.get_device(), None
                if not two or (
                        b.is_cuda and b.dtype is dt1 and b.shape == sh1
                        and b.is_contiguous() and b.get_device() == d
                        and not (p1 := b.data_ptr()) & 15):
                    return run(d, ts, p0, p1)
        return checked(ts)

    wrapper.launches = 0
    wrapper.record, wrapper.launch = record, launch
    wrapper.__name__ = wrapper.__qualname__ = name
    wrapper.__doc__ = (f"The {name} check: csrc/caps_*.cu on CUDA tensors, "
                       "its plain version on CPU tensors.")
    return wrapper


CHECKS = {name: (_wrapper(name), SPECS[name][2]) for name in NAMES}
