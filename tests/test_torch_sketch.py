"""Device sketching of the port (K10 ``ops/sketch.py``, K11 and the dp mesh
``parallel/mesh.py``) on the CPU, held to the JAX package and the host
scanner.

The plain versions run here (the kernels are held to them on the card by
``tests/test_torch_kernels_gpu.py -k sketch``): K10's plain version against
``batch_minimizer_kernel`` on every element of its four outputs; the
64-bit hash on 32-bit halves against the port's numpy MurmurHash3 and
JAX's ``murmur_fold64_device``; the drivers, the anchor stage and the CLI
against the host scanner; the dp sketch-count step in gloo ranks against
JAX's on its virtual CPU mesh and the host truth of
``tests/test_parallel.py``.
"""

import io
import os
import random
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dipgenie_tpu.ops import sketch_jax
from dipgenie_tpu.parallel import mesh as jax_mesh
from dipgenie_tpu_torch.ops import sketch
from dipgenie_tpu_torch.sketch.minimizers import sketch_sequence
from dipgenie_tpu_torch.sketch.murmur import murmur3_x64_128_fold64
from dipgenie_tpu_torch.utils.synth import pangenome, ragged_reads
from tests.torch_tp_ranks import run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("k,w", [(17, 7), (16, 5)])
def test_plain_sketch_equals_jax_kernel(k, w):
    """Every element of hash_hi, hash_lo, emit and minpos, on ragged rows
    (empty, shorter than a window, shorter than k, full, one base
    repeated, period 2)."""
    codes, lens = ragged_reads(k + w, 24, 90, k, w)
    want = jax.jit(partial(sketch_jax.batch_minimizer_kernel, k=k, w=w))(
        jnp.asarray(codes), jnp.asarray(lens))
    got = sketch.batch_minimizer(torch.from_numpy(codes),
                                 torch.from_numpy(lens), k, w)
    hh, hl, emit, minpos = (np.asarray(a) for a in want)
    assert np.array_equal(got[0].numpy().view(np.uint32), hh)
    assert np.array_equal(got[1].numpy().view(np.uint32), hl)
    assert np.array_equal(got[2].numpy(), emit)
    assert np.array_equal(got[3].numpy(), minpos)
    assert emit[:4].sum() == emit[3].sum() > 0  # the short rows emit nothing


def test_plain_murmur_equals_host_and_jax():
    """Message lengths 1-40: the 16-byte blocks and both tail branches."""
    rng = np.random.default_rng(0)
    for n in range(1, 41):
        data = rng.integers(0, 256, (5, n)).astype(np.uint8)
        hi, lo = sketch.murmur_fold64_ref(torch.from_numpy(
            data.astype(np.int64)))
        got = (hi.numpy().astype(np.uint64) << np.uint64(32)) \
            | lo.numpy().astype(np.uint64)
        assert np.array_equal(got, murmur3_x64_128_fold64(data)), n
        jh, jl = sketch_jax.murmur_fold64_device(
            [jnp.asarray(data[:, i].astype(np.uint32)) for i in range(n)], n)
        assert np.array_equal(hi.numpy(), np.asarray(jh)), n
        assert np.array_equal(lo.numpy(), np.asarray(jl)), n


def _reads(seed):
    """Random reads of 0-160 bases, a non-ACGT one and lowercase ones."""
    random.seed(seed)
    seqs = ["".join(random.choice("ACGT")
                    for _ in range(random.randint(0, 160))) for _ in range(40)]
    return seqs + ["ACGTN" * 20, "acgtTTGACCAgg" * 12, "ggccaTA" * 30]


@pytest.mark.parametrize("k", [17, 31])
def test_sketch_reads_equal_the_host_scanner(k):
    seqs = _reads(k)
    got = sketch.sketch_reads_device(seqs, k, 25, device="cpu")
    assert len(got) == len(seqs)
    for i, s in enumerate(seqs):
        host = np.unique(sketch_sequence(s, k, 25).hashes)
        assert got[i].dtype == np.uint64 and np.array_equal(got[i], host), i
    short = sum(len(s) < k + 24 for s in seqs)
    assert sketch.sketch_reads_device.host_rows == short + 1  # + "ACGTN"
    # a launch cap of a few rows cuts the reads over many launches alike
    few = sketch.sketch_reads_device(seqs, k, 25, batch=3, device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(few, got))


def test_sketch_reads_equal_jax_drivers():
    """k = 17, as the JAX package's own test (tests/test_device_kernels.py)."""
    seqs = _reads(42)
    want = sketch_jax.sketch_reads_device(seqs, 17, 7, batch=8)
    got = sketch.sketch_reads_device(seqs, 17, 7, device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_unsigned_order_of_the_read_sets():
    """Hashes with the top bit set sort after the others, as np.unique
    orders uint64 (a signed sort would put them first)."""
    got = sketch.sketch_reads_device(_reads(3), 17, 7, device="cpu")
    allh = np.concatenate(got)
    assert (allh >= np.uint64(2**63)).any() and (allh < np.uint64(2**63)).any()
    for h in got:
        assert np.array_equal(h, np.unique(h))


def test_long_sequence_equals_the_host_scanner():
    rng = np.random.default_rng(1)
    seq = "".join(rng.choice(list("ACGT"), 20_000))
    for k, w in ((31, 25), (17, 7)):
        hs, ps = sketch.sketch_long_sequence_device(seq, k, w, device="cpu")
        m = sketch_sequence(seq, k, w)
        assert np.array_equal(hs, m.hashes) and np.array_equal(ps, m.positions)
    # a non-ACGT sequence takes the host scanner
    hs, ps = sketch.sketch_long_sequence_device(seq[:500] + "N" + seq[500:900],
                                                31, 25, device="cpu")
    m = sketch_sequence(seq[:500] + "N" + seq[500:900], 31, 25)
    assert np.array_equal(hs, m.hashes) and np.array_equal(ps, m.positions)


def test_k_past_32_raises():
    with pytest.raises(ValueError, match="--sketch-backend host"):
        sketch.sketch_reads_device(["ACGT" * 30], 33, 5, device="cpu")
    with pytest.raises(ValueError, match="--sketch-backend host"):
        sketch.sketch_long_sequence_device("ACGT" * 30, 33, 5, device="cpu")
    codes, lens = ragged_reads(0, 8, 80, 33, 5)
    with pytest.raises(ValueError, match="k <= 32"):
        sketch.batch_minimizer(torch.from_numpy(codes),
                               torch.from_numpy(lens), 33, 5)


def test_device_sketching_needs_the_card_it_asks_for():
    """device="cuda" without a card raises before any work: no fallback."""
    from dipgenie_tpu_torch.device import NoCudaDevice

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(NoCudaDevice):
        sketch.sketch_reads_device(["ACGT" * 30], 17, 7)


@pytest.fixture(scope="module")
def small_pangenome(tmp_path_factory):
    return pangenome(str(tmp_path_factory.mktemp("skpg")), n_bp=20_000,
                     n_walks=8, seed=1)


def test_anchor_stage_device_equals_host(small_pangenome):
    from dipgenie_tpu_torch.graph.pangenome import PangenomeIndex
    from dipgenie_tpu_torch.io.fastx import read_fastx
    from dipgenie_tpu_torch.io.gfa import read_gfa
    from dipgenie_tpu_torch.solver.anchors import compute_and_classify_anchors

    gfa, reads = small_pangenome
    index = PangenomeIndex.from_gfa(read_gfa(gfa))
    rd = read_fastx(reads)
    got = {b: compute_and_classify_anchors(index, rd, 31, 25, 1.0,
                                           verbose=False, sketch_backend=b,
                                           device="cpu")
           for b in ("host", "device")}
    a, b = got["host"], got["device"]
    assert a.count_sp_r == b.count_sp_r > 0
    for f in ("sp_hashes", "homo_bv", "multiplicity", "occ_sp", "occ_hap",
              "occ_ptr", "occ_v"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert a.hap_minimizer_counts == b.hap_minimizer_counts
    assert a.anchor_hits == b.anchor_hits and a.fit == b.fit


def _cli(args, cwd):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    return subprocess.run([sys.executable, "-m", "dipgenie_tpu_torch", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=600)


def test_cli_device_sketch_writes_the_host_fasta(tmp_path, small_pangenome):
    gfa, reads = small_pangenome
    out = {}
    for tag, flags in (("host", []), ("device", ["--sketch-backend", "device",
                                                 "--device", "cpu"])):
        d = tmp_path / tag
        d.mkdir()
        p = _cli(["--dp-backend", "native", *flags, "-p2", "-g", gfa, "-r",
                  reads, "-o", "out.fa"], d)
        assert p.returncode == 0, p.stderr[-3000:]
        out[tag] = ((d / "out.fa").read_bytes(), p.stderr)
    assert out["device"][0] == out["host"][0] and len(out["host"][0]) > 0
    assert "device sketch on cpu" in out["device"][1]
    assert "of them by the host scanner" in out["device"][1]


def test_cli_device_sketch_without_card_exits_1(tmp_path, small_pangenome):
    """--sketch-backend device on cuda (the default device) with no card
    stops with exit code 1 before any host work, even on the native DP
    tier; -k 33 is refused with exit code 2."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    gfa, reads = small_pangenome
    p = _cli(["--dp-backend", "native", "--sketch-backend", "device", "-p2",
              "-g", gfa, "-r", reads, "-o", "out.fa"], tmp_path)
    assert p.returncode == 1
    assert "torch.cuda.is_available() is false" in p.stderr
    assert "Loaded graph" not in p.stderr
    assert not (tmp_path / "out.fa").exists()
    p = _cli(["--sketch-backend", "device", "--device", "cpu", "-k", "33",
              "-g", gfa, "-r", reads, "-o", "out.fa"], tmp_path)
    assert p.returncode == 2 and "-k up to 32" in p.stderr


def _count_case():
    """The reads and haplotype table of tests/test_parallel.py:14-54, and
    its host truth."""
    rng = np.random.default_rng(7)
    k, w = 11, 5
    reads = ["".join(rng.choice(list("ACGT"), 80)) for _ in range(16)]
    hap = "".join(rng.choice(list("ACGT"), 2000))
    tbl = np.unique(sketch_sequence(hap, k, w).hashes)
    thi = (tbl >> np.uint64(32)).astype(np.uint32)
    tlo = (tbl & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    order = np.lexsort((tlo, thi))
    thi, tlo = thi[order], tlo[order]
    codes, lens, _ = sketch.encode_reads(reads, 80)
    tbl64 = (thi.astype(np.uint64) << np.uint64(32)) | tlo.astype(np.uint64)
    counts = np.zeros(len(tbl64), np.int64)
    per_read = np.zeros(len(reads), np.int64)
    for i, s in enumerate(reads):
        for h in sketch_sequence(s, k, w).hashes:
            j = np.searchsorted(tbl64, h)
            if j < len(tbl64) and tbl64[j] == h:
                counts[j] += 1
                per_read[i] += 1
    return (codes, lens, thi, tlo, k, w), reads, counts, per_read


@pytest.fixture(scope="module")
def dp2(tmp_path_factory):
    """Two gloo ranks, mesh (n_dp = 2, n_tp = 1): the sketch-count step,
    the read sketch and the pipeline with device sketching."""
    tmp = str(tmp_path_factory.mktemp("dp2"))
    gfa, reads = pangenome(os.path.join(tmp, "genome"), n_bp=20_000, n_walks=8,
                           seed=1)
    args, reads_l, _, _ = _count_case()
    job = {"mesh": (2, 1), "sketch_count": args,
           "sketch_reads": (_reads(5), 17, 7),
           "pipeline": (gfa, reads),
           "config": {"sketch_backend": "device", "dp_backend": "native"}}
    return tmp, gfa, reads, run_ranks(2, job, tmp)


def test_dp_sketch_count_equals_jax_and_the_host_truth(dp2):
    args, _, counts, per_read = _count_case()
    if len(jax.devices()) < 4:
        pytest.skip("needs the virtual CPU mesh of tests/conftest.py")
    codes, lens, thi, tlo, k, w = args
    mesh = jax_mesh.make_mesh(n_dp=4, n_tp=1)
    jc, jp = jax.jit(lambda *a: jax_mesh.sharded_sketch_count_step(
        mesh, *a, k, w))(jnp.asarray(codes), jnp.asarray(lens),
                         jnp.asarray(thi), jnp.asarray(tlo))
    assert np.array_equal(np.asarray(jc), counts)
    assert np.array_equal(np.asarray(jp), per_read)
    _, _, _, ranks = dp2
    assert [r["dp_rank"] for r in ranks] == [0, 1]
    for r in ranks:
        got_c, got_p = r["sketch_count"]
        assert got_c.dtype == got_p.dtype == np.int32
        assert np.array_equal(got_c, counts)
        assert np.array_equal(got_p, per_read)
    from dipgenie_tpu_torch.parallel.mesh import sharded_sketch_count_step

    one = sharded_sketch_count_step(None, *args, device="cpu")
    assert np.array_equal(one[0].numpy(), counts)


def test_dp_sketch_reads_equal_one_rank(dp2):
    want = sketch.sketch_reads_device(_reads(5), 17, 7, device="cpu")
    for r in dp2[3]:
        assert all(np.array_equal(a, b)
                   for a, b in zip(r["sketch_reads"], want))
        assert len(r["sketch_reads"]) == len(want)


def test_dp_pipeline_device_sketch_fasta_equals_native_tier(dp2):
    from dipgenie_tpu_torch.solver.pipeline import Pipeline, PipelineConfig

    tmp, gfa, reads, _ = dp2
    out = os.path.join(tmp, "native.fa")
    Pipeline(gfa, reads, out, PipelineConfig(
        dp_backend="native", verbose=False)).run(out=io.StringIO())
    with open(out, "rb") as fh:
        want = fh.read()
    assert len(want) > 0
    for r in (0, 1):
        with open(os.path.join(tmp, f"rank{r}.fa"), "rb") as fh:
            assert fh.read() == want
