"""Per-stage checkpoint/resume for batch runs (ROADMAP item 9).

The reference binary has no checkpointing — it is a single-shot batch
process and an interrupted multi-hour leave-one-out run restarts from
zero (SURVEY §5 "Checkpoint/resume: none"). Here the expensive front
half of a run — haplotype + read sketching, the anchor join/filter and
the k-mer classification — can be checkpointed to disk and resumed:
``dipgenie-tpu-torch --checkpoint-dir DIR`` makes every batch entry
restartable at the anchor stage (the DP plan and bench CSR caches
cover the later stages; see bench.py).

Checkpoints are keyed by a content fingerprint of the input files
(size + mtime) and the sketch/classify parameters, so a changed input
or parameter set can never silently resume a stale run.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

CKPT_FORMAT = 1


def anchors_key(gfa: str, reads: str, k: int, w: int,
                threshold: float) -> str:
    h = hashlib.sha1()
    h.update(f"anchors{CKPT_FORMAT}-k{k}-w{w}-T{threshold}".encode())
    for p in (gfa, reads):
        st = os.stat(p)
        h.update(f"{os.path.abspath(p)}:{st.st_size}:{st.st_mtime_ns}".encode())
    return h.hexdigest()[:16]


def anchors_path(ckpt_dir: str, key: str) -> str:
    return os.path.join(ckpt_dir, f"anchors_{key}.npz")


def save_anchors(ckpt_dir: str, key: str, data) -> str | None:
    """Persist an AnchorData produced by the native occurrence path.
    Returns the path, or None when the data is not checkpointable
    (pure-Python chain lists)."""
    if data.occ_sp is None:
        return None
    os.makedirs(ckpt_dir, exist_ok=True)
    path = anchors_path(ckpt_dir, key)
    tmp = path + ".tmp"
    np.savez_compressed(
        tmp if tmp.endswith(".npz") else tmp,
        count_sp_r=np.int64(data.count_sp_r),
        sp_hashes=data.sp_hashes,
        homo_bv=np.asarray(data.homo_bv, np.int8),
        multiplicity=(
            data.multiplicity
            if data.multiplicity is not None
            else np.zeros(0, np.int64)
        ),
        hap_minimizer_counts=np.asarray(
            data.hap_minimizer_counts, np.int64
        ),
        occ_sp=data.occ_sp,
        occ_hap=data.occ_hap,
        occ_ptr=data.occ_ptr,
        occ_v=data.occ_v,
    )
    # np.savez appends .npz when missing; normalize then atomic-rename
    tmp_real = tmp if os.path.exists(tmp) else tmp + ".npz"
    os.replace(tmp_real, path)
    return path


def load_anchors(ckpt_dir: str, key: str):
    """Load a checkpointed AnchorData, or None when absent/corrupt."""
    from ..solver.anchors import AnchorData

    path = anchors_path(ckpt_dir, key)
    if not os.path.exists(path):
        return None
    try:
        d = np.load(path)
        data = AnchorData()
        data.count_sp_r = int(d["count_sp_r"])
        data.sp_hashes = d["sp_hashes"]
        data.homo_bv = d["homo_bv"]
        mult = d["multiplicity"]
        data.multiplicity = mult if len(mult) else None
        data.hap_minimizer_counts = [
            int(x) for x in d["hap_minimizer_counts"]
        ]
        data.occ_sp = d["occ_sp"]
        data.occ_hap = d["occ_hap"]
        data.occ_ptr = d["occ_ptr"]
        data.occ_v = d["occ_v"]
        return data
    except Exception:  # corrupt checkpoint: recompute, never crash
        return None
