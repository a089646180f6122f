"""dipgenie_tpu_torch — dipgenie_tpu's haplotype inference on an NVIDIA GPU.

A PyTorch + CUDA port of ``dipgenie_tpu`` that stands alone: it holds its
own copies of the host front end (GFA/FASTQ I/O, sketching, anchors,
expanded-graph build, levelization), the pair planner
(``ops/pair_plan.py``), the host DP tiers and the haplotype stitching,
held to the JAX package by the parity tests, and runs the diploid DP's
forward pass and traceback as hand-written CUDA kernels (``csrc/``),
each beside a plain PyTorch version of the same function: the pair DP
(the torch tier), and the fused and chunked tiers on per-vertex tables
(``ops/vertex_plan.py``). ``parallel/``
shards the DP's wide runs over the tp ranks of a ``torch.distributed``
mesh; ``probes/`` holds the level-chain floor probes (four more CUDA
kernels), the DP stage probe and the compiled parity gate. It imports
``torch`` and never ``jax`` or ``dipgenie_tpu``.
"""

__version__ = "0.1.0"

PHI_VERSION = "1.0"  # reference version string parity (src/PHI.h:9)

__all__ = ["PHI_VERSION", "__version__"]
