"""End-to-end inference pipeline of the port.

A copy of ``dipgenie_tpu/solver/pipeline.py`` (load GFA → build index →
read reads → anchors/classification → expanded graph → haploid or diploid
DP → FASTA output) with the port's DP tiers. ``dp_backend``:

* ``auto`` (the default) and ``torch``: the pair DP of ``ops/`` on
  ``device``: the CUDA kernels on ``cuda``, their plain PyTorch versions
  on ``cpu`` (``auto`` runs a graph with a level wider than 512, past the
  pair planner's window limit, on the fused tier);
* ``fused`` / ``jax``: the fused tier / the chunked tier
  (``ops/fused.py``, ``ops/chunked.py``) on ``device``, likewise.

With a tp ``mesh`` the torch tier shards its wide runs and the chunked
tier its wide transitions over the mesh's tp ranks (``auto`` then sends a
graph past the pair planner's window limit to the chunked tier over the
mesh), and the fused tier runs whole on every rank with one
``[W::diploid_dp]`` line. For every device tier, with ``device="cuda"``
and no card ``run()`` raises ``NoCudaDevice`` before any host work: the
port never moves to the CPU unless asked to;
* ``native`` / ``exact``: the native C++ tier / the exact numpy tier, on
  the host.

``sketch_backend="device"`` sketches haplotypes and reads with K10
(``ops/sketch.py``) on ``device``, the reads sharded over the dp ranks of
``mesh`` when one is given; it too raises ``NoCudaDevice`` before any host
work where ``device="cuda"`` finds no card.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass

from .. import native
from ..device import resolve_device
from ..graph.expanded import build_expanded_graph, build_expanded_graph_native
from ..graph.leveled import levelize_native
from ..graph.pangenome import PangenomeIndex
from ..io.fasta import write_fasta
from ..io.fastx import read_fastx
from ..io.gfa import read_gfa
from ..solver.anchors import (
    AnchorData,
    compute_and_classify_anchors,
    materialize_hits,
)
from ..solver.diploid import DEVICE_TIERS, diploid_dp_solver
from ..solver.haploid import dp_approximation_solver
from ..utils import checkpoint
from ..utils.timing import log_stage

BACKENDS = ("auto", "torch", "fused", "jax", "native", "exact")


def get_hap_name(gfa_name: str, reads_name: str) -> str:
    """Reference filename munging (misc.cpp:73-101)."""
    hap_name = os.path.basename(gfa_name)
    dot = hap_name.rfind(".")
    if dot != -1:
        hap_name = hap_name[:dot]
    hap_name += "_" + os.path.basename(reads_name)
    dot = hap_name.rfind(".")
    if dot != -1:
        hap_name = hap_name[:dot]
    return hap_name


@dataclass
class PipelineConfig:
    k: int = 31  # options.cpp:7
    w: int = 25  # options.cpp:8
    recombination_limit: int = 18  # main.cpp:44
    recombination_penalty: int = 100  # main.cpp:45
    ploidy: int = 2  # main.cpp:50
    threshold: float = 1.0  # main.cpp:48
    num_threads: int = 4
    debug: bool = False
    verbose: bool = True
    progress: bool = False
    dp_backend: str = "auto"  # auto | torch | fused | jax | native | exact
    device: str = "cuda"  # cuda | cpu: where the device tiers run
    sketch_backend: str = "host"  # host | device (K10 on ``device``)
    # optional checkpoint directory: the anchor stage (sketch + join +
    # classify) resumes from disk on rerun (utils/checkpoint.py)
    checkpoint_dir: str | None = None
    # optional parallel.mesh.Mesh: the torch tier's wide runs are sharded
    # over its tp ranks and device sketching's reads over its dp ranks
    # (every rank runs the pipeline and writes the same FASTA); host
    # sketching ignores the dp axis
    mesh: object = None

    @property
    def backend(self) -> str:
        """The DP tier asked for (``auto`` is the torch tier, routed past
        its window limit)."""
        if self.dp_backend not in BACKENDS:
            raise ValueError(
                f"unknown DP backend {self.dp_backend!r}: {BACKENDS}")
        return self.dp_backend


class Pipeline:
    def __init__(self, gfa_file: str, reads_file: str, hap_file: str,
                 cfg: PipelineConfig | None = None):
        self.gfa_file = gfa_file
        self.reads_file = reads_file
        self.hap_file = hap_file
        self.cfg = cfg or PipelineConfig()
        self.hap_name = get_hap_name(gfa_file, reads_file)
        self.index: PangenomeIndex | None = None
        self.anchors: AnchorData | None = None

    def load(self) -> None:
        g = read_gfa(self.gfa_file)
        if self.cfg.verbose:
            log_stage("main", f"Loaded graph from: {self.gfa_file}")
        self.index = PangenomeIndex.from_gfa(g)

    def run(self, out=sys.stdout) -> None:
        cfg = self.cfg
        if cfg.backend in DEVICE_TIERS or cfg.sketch_backend == "device":
            resolve_device(cfg.device)  # fail before any host work
        if self.index is None:
            self.load()
        ck_key = None
        anchors = None
        if cfg.checkpoint_dir:
            ck_key = checkpoint.anchors_key(
                self.gfa_file, self.reads_file, cfg.k, cfg.w, cfg.threshold
            )
            anchors = checkpoint.load_anchors(cfg.checkpoint_dir, ck_key)
            if anchors is not None and cfg.verbose:
                log_stage(
                    "main",
                    f"Resumed anchors from checkpoint {ck_key}",
                )
        if anchors is None:
            reads = read_fastx(self.reads_file)
            anchors = compute_and_classify_anchors(
                self.index, reads, cfg.k, cfg.w, cfg.threshold,
                verbose=cfg.verbose, sketch_backend=cfg.sketch_backend,
                mesh=cfg.mesh, device=cfg.device,
            )
            if ck_key is not None:
                checkpoint.save_anchors(cfg.checkpoint_dir, ck_key, anchors)
        self.anchors = anchors
        self.solve(diploid=(cfg.ploidy == 2), out=out)

    def solve(self, diploid: bool, out=sys.stdout) -> None:
        cfg = self.cfg
        backend = cfg.backend
        # native C++ graph build unless the exact tier was requested, which
        # exercises the Python graph path
        use_native_build = native.available() and backend != "exact"
        if use_native_build:
            build = build_expanded_graph_native(self.index, self.anchors)
            g = build.graph
        else:
            if self.anchors.occ_sp is not None and not self.anchors.anchor_hits:
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
                g = levelize_native(g)
            else:
                g.strict_bfs_levelize_and_reorder()
            solutions = diploid_dp_solver(
                g, cfg.recombination_limit, color_homo_bv,
                build.anchors_by_hap, self.index, out=out,
                progress=cfg.progress, backend=backend,
                n_threads=cfg.num_threads, device=cfg.device,
                mesh=cfg.mesh,
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
