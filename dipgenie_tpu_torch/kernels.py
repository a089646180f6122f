"""Build and bind the port's CUDA kernels.

``csrc/*.cu`` compile with ``nvcc`` for ``sm_90a`` (one ``nvcc`` per
source, all started together) and link into one shared library with a
plain C interface, loaded with ``ctypes``: no PyTorch headers, so the
build takes seconds. The library is built at first use,
from the sources in this checkout only, into
``build/dipgenie_tpu_torch/<hash of sources and flags>/`` beside the
package (``.gitignore`` lists ``build/``). Every C entry point launches on
the stream it is given, allocates nothing, and returns
``cudaGetLastError()``; the wrappers raise on a non-zero return.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "dipgenie_tpu_torch")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_LIB_NAME = "libdgtorch.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# argtypes of every C entry point (csrc/*.cu)
_SIGNATURES = {
    # tbl, tb_desc [T, 4], T, R1, lanes, shared_v, v_in, v_out, bp256,
    # bp1024, stream
    "dg_narrow_run": (_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P),
    # R1, lanes, shared_v: K1's dynamic shared memory
    "dg_narrow_smem_bytes": (_I, _I, _I),
    # dtbl, k2_desc [T, 2], k2_cuts [T, grid * per_block + 1] int16, T, R1,
    # NB, grid, per_block, v_in, V [2, R1, NB * 1024], bp, stream
    "dg_wide_dense_run": (_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    # int *blocks: K2's co-resident grid on the current device
    "dg_wide_dense_grid": (_P,),
    # tbl, wwin, wbase, k3_desc [T, 4], k3_cuts [T, grid * per_block + 1,
    # 2], T, R1, NB, grid, per_block, v_in, V [2, R1, NB * 1024], bp, rec,
    # stream
    "dg_wide_split_run": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P,
                          _P, _P, _P),
    # int *blocks: K3's (and K4's) co-resident grid on the current device
    "dg_wide_split_grid": (_P,),
    # stbl, swin, sbase, the transition's k3_desc row and k3_cuts rows, R1,
    # NB, grid, per_block, v, part [2, R1, NB * 1024], rec, stream
    "dg_wide_step": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P),
    # desc [T, 8], bases [segments, 6], T, R, recs [ceil(T / 64) * 64, 7],
    # stream
    "dg_trace": (_P, _P, _I, _I, _P, _P),
    # tbl [T, 8, 128], T, bp, acc, status (zeroed), sums, stream
    "dg_chain_floor": (_P, _I, _P, _P, _P, _P, _P),
    # pit, pwt [T, 8, 128], C [T, 64, 64], T, bp, v, stream
    "dg_chain_step16": (_P, _P, _P, _I, _P, _P, _P),
    # int out[4]: K5b's clusters on the current device, blocks, threads,
    # shared bytes
    "dg_chain_step16_fit": (_P,),
    # tbl [T, 8, 256], T, bp, v, stream
    "dg_chain_pair": (_P, _I, _P, _P, _P),
    # tblc [T, 16, 8], tbl2c [T, 16, 4], S [T, 16, 16], T, bp, v, stream
    "dg_chain_edge": (_P, _P, _P, _I, _P, _P, _P),
    # check id (csrc/caps.cuh), in0, in1 (or null), out, offset, stream
    "dg_caps": (_I, _P, _P, _P, _I, _P),
    # codes [B, L] u8, lens [B], B, L, k, w, hash_hi, hash_lo, emit, minpos
    # [B, L - k - w + 2], stream
    "dg_sketch": (_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P),
    # hash_hi, hash_lo, emit [B, NW], B, NW, table_hi, table_lo [M], M,
    # max_dup, bits, scratch off [2^bits + 1] and pairs [M, 2], counts [M],
    # per_read [B], stream
    "dg_sketch_count": (_P, _P, _P, _I, _I, _P, _P, _I, _I, _I, _P, _P, _P,
                        _P, _P),
    # fhom, fhet, ferr, pd, pe, y, the launch geometry (host uint32 words,
    # models/fitter.py:grid_nll_geometry), out, stream
    "dg_grid_nll": (_P, _P, _P, _P, _P, _P, _P, _P, _P),
    # U, SD, VW, ZP, ZPH, SS, xs, their lengths (u, sd, vw, zp, zph, s, x),
    # max_copy, fhom, fhet, ferr, stream
    "dg_grid_tables": (*(_P,) * 7, *(_I,) * 8, _P, _P, _P, _P),
    # desc (host [T, 9] int64), desc_dev, cut (host [n, 3] int64,
    # ops/vertex_plan.py:plan_launches), n, R1, pred, deg, masks, va, vb,
    # bp, stream
    "dg_fused_forward": (_P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P),
    # int *bytes: the shared memory a block may opt in to (current device)
    "dg_vertex_smem_optin": (_P,),
    # desc_dev [T, 9], T, R, pred, its words, masks, bp, its bytes, rows
    # [T, 4], sh [1], cycles [T] (or null), stream
    "dg_fused_trace": (_P, _I, _I, _P, _L, _P, _P, _L, _P, _P, _P, _P),
    # desc (host), desc_dev, cut (host [n, 3]), n, t0, R1, pred, deg,
    # masks, va, vb, sa, sb, bp (or null), bp_off (host, one int64 a
    # transition from t0), stream
    "dg_chunk_forward": (_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                         _P, _P, _P),
    # desc row (host), pred, deg, masks, vin, shin, vout, shout, words (or
    # null), p0, p1, pitch, R1, stream
    "dg_chunk_step_share": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _L, _L,
                            _I, _P),
    # desc_dev [T, 9], woff [T + 1] int64, t0, n, bp, its words, carry
    # [3], rows [n, 4], cycles [n] (or null), stream
    "dg_chunk_trace": (_P, _P, _I, _I, _P, _L, _P, _P, _P, _P),
}


def _sources() -> list[str]:
    return sorted(
        glob.glob(os.path.join(CSRC, "*.cu"))
        + glob.glob(os.path.join(CSRC, "*.cuh"))
    )


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels of "
        "dipgenie_tpu_torch are built from source at first use"
    )


def library_path() -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16], _LIB_NAME)


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands at once; their output, or raise on a failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, cwd=CSRC)
             for c in cmds]
    outs = [(c, p.communicate()[0], p.returncode) for c, p in zip(cmds, procs)]
    for c, out, rc in outs:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(c)}\n{out}")
    return "".join(out for _, out, _ in outs)


def build() -> tuple[str, str]:
    """Compile ``csrc/*.cu`` unless the library for these sources exists.
    Returns ``(path, compiler log)``; the log is empty when nothing was
    built. Raises with the compiler's output when ``nvcc`` fails."""
    path = library_path()
    if os.path.exists(path):
        return path, ""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tag = f"tmp{os.getpid()}"
    nvcc = _nvcc()
    objs = {src: f"{path}.{os.path.basename(src)}.{tag}.o"
            for src in _sources() if src.endswith(".cu")}
    log = _run_all([[nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
                    for src, obj in objs.items()])
    tmp = f"{path}.{tag}"
    log += _run_all([[nvcc, "-shared", *NVCC_FLAGS[:2], "-o", tmp,
                      *objs.values()]])
    for obj in objs.values():
        os.remove(obj)
    os.replace(tmp, path)
    return path, log


@functools.cache
def lib() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    path, _ = build()
    so = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(so, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    so.dg_error_string.argtypes = [ctypes.c_int]
    so.dg_error_string.restype = ctypes.c_char_p
    return so


def raise_on_error(rc: int, name: str) -> None:
    if rc != 0:
        msg = lib().dg_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


# PyTorch's own read of the current stream's raw handle (what its generated
# code passes to its launches); absent from a build without CUDA
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def raw_stream(index: int) -> int:
    """Handle of PyTorch's current stream on CUDA device ``index``, read
    without building a ``torch.cuda.Stream``."""
    if _RAW_STREAM is None:
        return torch.cuda.current_stream(index).cuda_stream
    return _RAW_STREAM(index)


class Launch:
    """The checks a wrapper of a kernel with fixed shapes makes on every
    call, with what does not change between calls made once: the inputs'
    ``(dtype, shape)`` tuples and the output's, and at first use the bound
    C entry point ``entry``. ``check`` reads only tensor attributes (no
    ``torch.device`` built); ``raw_stream`` gives the stream's handle."""

    __slots__ = ("name", "entry", "ins", "out", "_like", "_stride", "_fn")

    def __init__(self, name: str, entry: str, ins: tuple, out: tuple):
        self.name, self.entry, self.ins, self.out = name, entry, ins, out
        # the output comes from torch.empty_like of an input of its dtype
        # and shape where there is one, else from torch.empty_strided at
        # its contiguous strides: both allocate faster than torch.empty's
        # keywords parse (1-3 us a call on an H100 host)
        self._like = next((i for i, spec in enumerate(ins) if spec == out),
                          None)
        stride, n = [], 1
        for size in reversed(out[1]):
            stride.append(n)
            n *= size
        self._stride = tuple(reversed(stride))
        self._fn = None

    def fn(self):
        """The bound C entry point (the library built and loaded first)."""
        if self._fn is None:
            self._fn = getattr(lib(), self.entry)
        return self._fn

    def check(self, ts) -> tuple[int, list[int]]:
        """``(device index, data pointers)`` of ``ts``; raises
        ``ValueError`` unless each is a contiguous CUDA tensor of its
        dtype and shape, all on one device, each 16-byte aligned (the
        kernels' 16-byte loads and bulk copies)."""
        if len(ts) != len(self.ins):
            raise ValueError(f"{self.name}: takes {len(self.ins)} tensors, "
                             f"got {len(ts)}")
        d = ts[0].get_device() if isinstance(ts[0], torch.Tensor) else -1
        ptrs = []
        for i, (t, (dtype, shape)) in enumerate(zip(ts, self.ins)):
            if not isinstance(t, torch.Tensor) or not t.is_cuda:
                raise ValueError(
                    f"{self.name} input {i}: want a CUDA tensor, got "
                    f"{type(t)} on {getattr(t, 'device', None)}")
            if t.get_device() != d:
                raise ValueError(f"{self.name} input {i}: on {t.device}, want "
                                 f"cuda:{d}")
            if t.dtype is not dtype:
                raise ValueError(f"{self.name} input {i}: dtype {t.dtype}, "
                                 f"want {dtype}")
            if t.shape != shape:
                raise ValueError(f"{self.name} input {i}: shape "
                                 f"{tuple(t.shape)}, want {shape}")
            if not t.is_contiguous():
                raise ValueError(f"{self.name} input {i}: not contiguous")
            p = t.data_ptr()
            if p & 15:
                raise ValueError(f"{self.name} input {i}: not 16-byte "
                                 "aligned")
            ptrs.append(p)
        return d, ptrs

    def empty(self, d: int, ts) -> torch.Tensor:
        """A new output tensor on CUDA device ``d``, where ``ts`` (the
        checked inputs) lie."""
        if self._like is not None:
            return torch.empty_like(ts[self._like])
        return torch.empty_strided(self.out[1], self._stride,
                                   dtype=self.out[0], device=d)


def check_tensor(t, name, dtype, shape=None, device=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and
    ``shape`` / ``device`` when given)."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name}: want a CUDA tensor, got {type(t)} on "
                         f"{getattr(t, 'device', None)}")
    want = torch.device(device) if device is not None else None
    if want is not None and (
        t.device.type != want.type
        or want.index not in (None, t.device.index)
    ):
        raise ValueError(f"{name}: on {t.device}, want {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, want {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def check_aligned(t: torch.Tensor, name: str) -> None:
    """Raise unless ``t`` starts on a 16-byte boundary (the bulk copies'
    alignment)."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel copies it in 16-byte units "
                         "and wants a 16-byte aligned tensor")
