"""dipgenie_tpu_torch — the diploid pair DP of dipgenie_tpu on an NVIDIA GPU.

A PyTorch + CUDA port of the device tier of ``dipgenie_tpu``. The host
front end (GFA/FASTQ I/O, sketching, anchors, expanded-graph build,
levelization), the pair planner (``dipgenie_tpu.ops.diploid_pallas.
plan_pairs``) and the haplotype stitching are imported from
``dipgenie_tpu``, which does not import JAX at module level; this package
replaces only the device forward pass and traceback with hand-written
CUDA kernels (``csrc/``), each beside a plain PyTorch version of the same
function. It imports ``torch`` and never ``jax``.
"""

from dipgenie_tpu import PHI_VERSION

__version__ = "0.1.0"

__all__ = ["PHI_VERSION", "__version__"]
