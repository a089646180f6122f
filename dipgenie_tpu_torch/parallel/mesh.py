"""Multi-process meshes over ``torch.distributed``.

Counterpart of ``dipgenie_tpu/parallel/mesh.py``, whose ``make_mesh``
shapes the devices of one JAX process into a ``("dp", "tp")`` grid. Here
every device is a process (a rank) of an initialised default process
group: ``torchrun`` with NCCL and one rank per card, or ranks started by
the caller (gloo for ranks that share a card or run on the CPU). The rank
``dp * n_tp + tp`` holds grid cell ``(dp, tp)``, the order of JAX's
``reshape(n_dp, n_tp)``.

Axes:

* **tp**: the pair DP's wide runs. Every 1024-lane destination window of
  a wide transition is owned by one tp rank (``win % n_tp``); each rank
  computes its windows' partial state with K4 against the replicated
  state and the partials merge with one ``all_reduce(MAX)`` over the tp
  group (``ops/wide_step.py:wide_tp_run``), on the group's backend: NCCL
  on the card, gloo on the CPU or for ranks sharing one card (gloo
  stages CUDA tensors through host memory itself). Narrow runs and the
  traceback run on every rank, so every rank returns the same result.
* **dp**: the data-parallel axis of device sketching, which the port does
  not have yet (host sketching ignores it, as the JAX package does with
  ``sketch_backend="host"``).

There is no single-process stand-in: without an initialised process
group ``make_mesh`` raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch.distributed as dist


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
