"""The capability checks' launch path as it was before its redesign for
Hopper, kept for the timings in turns of ``chip_smoke.py`` phase H2 only:
no other path of the package imports this module.

``CHECKS[name]`` is the replaced wrapper of a check: per call it scans the
inputs' devices, checks each with ``kernels.check_tensor`` (which builds a
``torch.device``), allocates the output, and reads the stream through
``kernels.stream_of`` (which builds a ``torch.cuda.Stream``). The checks
whose kernels were redesigned on the card (``REDESIGNED``) launch the
replaced kernels of ``caps_replaced.cu`` (entry ``dg_caps_replaced``,
built here into ``build/dipgenie_tpu_torch/caps_replaced/``); the others
launch the package's own ``dg_caps`` kernels, which did not change.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os

import torch

from .. import kernels
from ..ops.caps import NAMES, SPECS

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "caps_replaced.cu")
REDESIGNED = ("sublane_gather_8", "sublane_gather_16", "batched_dot_3d",
              "batched_dot_bcast_lhs", "dma_strided_3d", "dot2d_f32")


@functools.cache
def lib() -> ctypes.CDLL:
    """The replaced kernels' library, built first if needed."""
    h = hashlib.sha1(" ".join(kernels.NVCC_FLAGS).encode())
    for src in (SOURCE, os.path.join(kernels.CSRC, "caps.cuh")):
        with open(src, "rb") as fh:
            h.update(fh.read())
    path = os.path.join(kernels.BUILD_ROOT, "caps_replaced",
                        h.hexdigest()[:16], "libcapsreplaced.so")
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        kernels._run_all([[kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared",
                           "-I", kernels.CSRC, "-o", tmp, SOURCE]])
        os.replace(tmp, path)
    so = ctypes.CDLL(path)
    so.dg_caps_replaced.argtypes = list(kernels._SIGNATURES["dg_caps"])
    so.dg_caps_replaced.restype = ctypes.c_int
    return so


def _wrapper(name):
    check_id = NAMES.index(name)
    ins, (out_dtype, out_shape), plain, arg = SPECS[name]
    replaced = name in REDESIGNED

    def wrapper(*ts):
        if len(ts) != len(ins):
            raise ValueError(f"{name}: takes {len(ins)} tensors, got "
                             f"{len(ts)}")
        if all(t.device.type == "cpu" for t in ts):
            return plain(*ts)
        dev = next(t.device for t in ts if t.device.type != "cpu")
        for i, (t, (dtype, shape)) in enumerate(zip(ts, ins)):
            kernels.check_tensor(t, f"{name} input {i}", dtype, shape, dev)
            if t.data_ptr() % 16:
                raise ValueError(f"{name} input {i}: not 16-byte aligned")
        out = torch.empty(out_shape, dtype=out_dtype, device=dev)
        ptrs = [t.data_ptr() for t in ts] + [None]
        launch = (lib().dg_caps_replaced if replaced
                  else kernels.lib().dg_caps)
        rc = launch(check_id, ptrs[0], ptrs[1], out.data_ptr(), arg,
                    kernels.stream_of(out))
        kernels.raise_on_error(rc, name)
        wrapper.launches += 1
        return out

    wrapper.launches = 0
    wrapper.__name__ = wrapper.__qualname__ = f"replaced_{name}"
    return wrapper


CHECKS = {name: _wrapper(name) for name in NAMES}
