"""End-to-end pipeline with the port's DP tier.

The shared ``dipgenie_tpu.solver.pipeline.Pipeline`` (GFA, index, reads,
anchors) with only ``solve`` overridden, in the flow of
``dipgenie_tpu/solver/pipeline.py:110-185``. Backends: ``torch`` (the
CUDA kernels on ``device``, or their plain PyTorch versions on
``cpu``), ``native`` and ``exact``; ``auto`` is ``torch`` on the card
when ``device`` is ``cuda`` and a card is present, else ``native`` (or
``exact`` without the native runtime), as the JAX package does without a
TPU. This module never imports JAX.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import torch

from dipgenie_tpu.graph.expanded import build_expanded_graph
from dipgenie_tpu.io.fasta import write_fasta
from dipgenie_tpu.solver.haploid import dp_approximation_solver
from dipgenie_tpu.solver.pipeline import Pipeline, PipelineConfig

from ..utils.native_build import ensure_native
from .diploid import diploid_dp_solver


@dataclass
class TorchPipelineConfig(PipelineConfig):
    dp_backend: str = "auto"  # auto | torch | native | exact
    device: str = "cuda"  # cuda | cpu


def resolve_backend(cfg: TorchPipelineConfig, have_native: bool) -> str:
    backend = cfg.dp_backend
    if backend == "auto":
        if torch.device(cfg.device).type == "cuda" and (
            torch.cuda.is_available()
        ):
            return "torch"
        backend = "native" if have_native else "exact"
        print(
            f"[M::solve] no CUDA device for the torch tier; using the "
            f"{backend} DP tier",
            file=sys.stderr,
        )
    return backend


class TorchPipeline(Pipeline):
    def __init__(self, gfa_file: str, reads_file: str, hap_file: str,
                 cfg: TorchPipelineConfig | None = None):
        super().__init__(gfa_file, reads_file, hap_file,
                         cfg or TorchPipelineConfig())

    def solve(self, diploid: bool, out=sys.stdout) -> None:
        cfg = self.cfg
        have_native = ensure_native()
        backend = resolve_backend(cfg, have_native)
        # native C++ graph build unless the exact tier was requested, which
        # exercises the Python graph path
        use_native_build = have_native and backend in ("native", "torch")
        if use_native_build:
            from dipgenie_tpu.graph.expanded import build_expanded_graph_native

            build = build_expanded_graph_native(self.index, self.anchors)
            g = build.graph
        else:
            if self.anchors.occ_sp is not None and not self.anchors.anchor_hits:
                from dipgenie_tpu.solver.anchors import materialize_hits

                self.anchors.anchor_hits = materialize_hits(
                    self.anchors, self.index.num_walks
                )
            build = build_expanded_graph(self.index, self.anchors)
            g = build.graph
            g.topologically_reorder(build.sink)

        if not diploid:
            dp_path = dp_approximation_solver(g, cfg.recombination_limit, out=out)
            dp_output = "".join(self.index.node_seq[u] for u in dp_path)
            write_fasta(self.hap_file, [(f"dp_sol LN:{len(dp_output)}", dp_output)])
        else:
            color_homo_bv = [False] * build.num_colors
            for c in range(build.num_colors):
                if self.anchors.homo_bv[build.color_to_anchor[c]]:
                    color_homo_bv[c] = True
            if use_native_build:
                # C++ levelizer + CSR view (no Python list rebuild)
                from dipgenie_tpu.graph.leveled import levelize_native

                g = levelize_native(g)
            else:
                g.strict_bfs_levelize_and_reorder()
            solutions = diploid_dp_solver(
                g, cfg.recombination_limit, color_homo_bv,
                build.anchors_by_hap, self.index, out=out,
                progress=cfg.progress, backend=backend,
                n_threads=cfg.num_threads, device=cfg.device,
            )
            for r1, r2, s1, s2 in solutions:
                print(
                    f"recombinations in P1: {r1}, recombinations in P2: {r2}"
                    f", bp of P1: {len(s1)}, bp of P2: {len(s2)}",
                    file=out,
                )
            if len(solutions) == 1:
                r1, r2, s1, s2 = solutions[0]
                write_fasta(
                    self.hap_file,
                    [(f"sol_1 bp:{len(s1)}", s1), (f"sol_2 bp:{len(s2)}", s2)],
                )
            else:
                print("No solution reported, output file not written.", file=out)
        print(f"Diploid sequences written to: {self.hap_file}", file=out)
