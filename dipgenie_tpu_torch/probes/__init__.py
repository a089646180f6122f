"""Probes of the port on the card: the level-chain floors (``floor``,
``pair``, ``edge``), the DP's stages (``dp-stages``) and the compiled
parity gate (``parity-gate``), run as ``python -m
dipgenie_tpu_torch.probes <name> [--device cuda|cpu] ...``.

Counterparts of ``scripts/tpu_floor_probe.py``, ``tpu_pair_probe.py``,
``tpu_edge_probe.py``, ``tpu_e2e_probe.py`` / ``tpu_split_probe.py`` and
``tpu_parity_gate.py``. Every probe runs on ``cuda`` unless ``--device
cpu`` is given, and stops with a message when the card is asked for and
there is none; a time taken with ``--device cpu`` is a host-clock time of
the kernels' plain PyTorch versions and is printed as such.
"""
