"""chip_smoke.py's host-side pieces at a tiny size, and its refusal to run
without a GPU (the card-side phases run only on the card)."""

import importlib.util
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.join(os.path.dirname(__file__), "..")
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

TINY = dict(genome_len=30_000, region_len=4_000, n_reads=128, n_snps=4,
            short_len=300, long_len=600, long_share=0.25)


@pytest.fixture(scope="module")
def tiny():
    return smoke.simulate_dataset(3, **TINY)


def test_dataset_plants_truth_in_the_covered_region(tiny):
    genome, reads, truth = tiny
    ref = genome["chr"].codes
    assert len(ref) == TINY["genome_len"] and len(truth) == TINY["n_snps"]
    pos = np.array(sorted(truth))
    assert np.diff(pos).min() > 6  # SNPs never share a k-mer
    lo = min(r.ref_start for r in reads)
    hi = max(r.ref_end for r in reads)
    assert hi - lo <= TINY["region_len"]
    assert lo <= pos.min() and pos.max() < hi
    for p, b in truth.items():
        assert ref[p] != b  # the reference disagrees with the sample
    lens = sorted({r.ref_end - r.ref_start for r in reads})
    assert lens[0] >= 290 and lens[-1] <= 610
    assert {r.strand for r in reads} == {1, -1}


def test_dataset_reads_carry_a_monotone_move_table(tiny):
    _, reads, _ = tiny
    for r in reads[:8]:
        assert len(r.basecall) == len(r.window_codes) == len(r.move_index)
        assert np.all(np.diff(r.move_index) >= 0)
        assert r.move_index[-1] < len(r.signal)
        # the move table marks where each k-mer's first sample is
        n_kmer = len(r.window_codes) - 5
        np.testing.assert_array_equal(
            r.true_path[r.move_index[:n_kmer]], np.arange(n_kmer))


def test_score_calls_against_truth():
    truth = {10: 0, 50: 2, 90: 3}
    calls = {(10, "C", "A"): 40.0, (50, "A", "G"): 30.0, (70, "T", "C"): 9.0}
    recall, precision, tp, fp, fn = smoke.score_calls(calls, truth)
    assert (tp, fp, fn) == (2, 1, 1)
    assert recall == pytest.approx(2 / 3) and precision == pytest.approx(2 / 3)


def test_vcf_and_alignment_readers(tmp_path):
    from nadavca_tpu import call as callmod

    calls = [callmod.SnpCall(contig="chr", position=41, ref_base="C",
                             alt_base="T", probability=0.999, coverage=30)]
    vcf = tmp_path / "x.vcf"
    callmod.write_vcf(str(vcf), calls)
    got = smoke.read_vcf(str(vcf))
    assert list(got) == [(41, "C", "T")] and got[(41, "C", "T")] == 30.0
    out = tmp_path / "aln"
    out.mkdir()
    callmod.write_alignment(str(out / "r1.txt"), "r1", "chr", 1, 0, 3,
                            np.array([0, 2, -1]), np.array([2, 5, -1]))
    paths = smoke.read_alignments(str(out))
    np.testing.assert_array_equal(paths["r1"], [0, 0, 1, 1, 1])


def test_memory_seam_feeds_the_cli_like_fast5(tiny, tmp_path, monkeypatch):
    """Without h5py a pickle loader stands in for the fast5 decoder under the
    CLI's own file listing; the snp command must call the same set as from
    fast5 files (scan backend, CPU)."""
    from nadavca_tpu.io import fast5 as fast5mod

    genome, reads, truth = tiny
    vcfs = {}
    for name, use_fast5 in (("fast5", True), ("memory", False)):
        root = tmp_path / name
        root.mkdir()
        data = smoke.write_dataset(str(root), genome, reads, use_fast5)
        if not use_fast5:
            monkeypatch.setattr(fast5mod, "read_fast5", fast5mod.read_fast5)
            smoke.install_memory_reads()
        vcf = str(root / "out.vcf")
        stats = smoke.run_cli(["snp", str(root / "reference.fasta"), data,
                               "-o", vcf, "--batch-reads", "16",
                               "--backend", "scan"])
        assert stats["reads_called"] > 0.9 * len(reads)
        vcfs[name] = smoke.read_vcf(vcf)
    assert vcfs["memory"] == vcfs["fast5"]
    recall, precision, *_ = smoke.score_calls(vcfs["fast5"], truth)
    assert recall >= 0.75 and precision >= 0.75, (recall, precision)


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_refuses_without_gpu_or_repo(where, tmp_path):
    """No accelerator, or no repo beside the script: non-zero, no result."""
    cwd = REPO
    if where == "alone":
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    r = _run_smoke(cwd)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
