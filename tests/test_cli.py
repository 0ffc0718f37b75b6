"""CLI end-to-end: simulate → align → snp, through the argparse front end."""

import os

import numpy as np
import pytest

from nadavca_tpu import cli
from nadavca_tpu.io import fast5

pytestmark = pytest.mark.skipif(not fast5.HAVE_H5PY, reason="h5py unavailable")


@pytest.fixture(scope="module")
def simdir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("simdata"))
    rc = cli.main([
        "simulate", "-o", d, "--reads", "24", "--files", "2",
        "--read-length", "400", "--genome-length", "2000", "--snps", "2",
        "--seed", "3",
    ])
    assert rc == 0
    return d


def test_simulate_outputs(simdir):
    files = sorted(os.listdir(simdir))
    assert "reference.fasta" in files
    assert "truth_snps.tsv" in files
    assert sum(f.endswith(".fast5") for f in files) == 2


def test_cli_align(simdir, tmp_path):
    out = str(tmp_path / "aln")
    rc = cli.main([
        "align", os.path.join(simdir, "reference.fasta"), simdir,
        "-o", out, "--backend", "scan", "--batch-reads", "16",
    ])
    assert rc == 0
    outs = os.listdir(out)
    assert len(outs) >= 20  # most reads aligned
    body = open(os.path.join(out, outs[0])).read().splitlines()
    assert body[0].startswith("# read=")
    cols = body[1].split("\t")
    assert len(cols) == 3 and int(cols[2]) > int(cols[1])


def test_cli_snp_finds_truth(simdir, tmp_path):
    out = str(tmp_path / "calls.vcf")
    rc = cli.main([
        "snp", os.path.join(simdir, "reference.fasta"), simdir,
        "-o", out, "--backend", "scan", "--batch-reads", "16",
        "--min-coverage", "2",
    ])
    assert rc == 0
    truth = {}
    with open(os.path.join(simdir, "truth_snps.tsv")) as f:
        next(f)
        for line in f:
            contig, pos, sample_b, ref_b = line.split()
            truth[int(pos)] = sample_b
    called = {}
    with open(out) as f:
        for line in f:
            if line.startswith("#"):
                continue
            c = line.split("\t")
            called[int(c[1]) - 1] = c[4]
    for p, b in truth.items():
        assert p in called, f"missed planted SNP at {p}: called={called}"
        assert called[p] == b
    fps = set(called) - set(truth)
    assert len(fps) <= 1, f"false positives: {fps}"


@pytest.mark.skipif(
    len(__import__("jax").devices()) < 8, reason="needs 8 virtual devices")
def test_cli_snp_devices8_identical_vcf(simdir, tmp_path):
    """`snp --devices 8` must produce a byte-identical VCF to --devices 1
    (VERDICT r1 item 1 done-criterion)."""
    ref = os.path.join(simdir, "reference.fasta")
    out1 = str(tmp_path / "calls_d1.vcf")
    out8 = str(tmp_path / "calls_d8.vcf")
    base = ["snp", ref, simdir, "--backend", "scan", "--batch-reads", "16",
            "--min-coverage", "2"]
    assert cli.main(base + ["-o", out1, "--devices", "1"]) == 0
    assert cli.main(base + ["-o", out8, "--devices", "8"]) == 0
    assert open(out1, "rb").read() == open(out8, "rb").read()
    assert len(open(out1).readlines()) > 5  # non-trivial output


@pytest.mark.skipif(
    len(__import__("jax").devices()) < 8, reason="needs 8 virtual devices")
def test_cli_align_devices8_identical(simdir, tmp_path):
    out1 = str(tmp_path / "a1")
    out8 = str(tmp_path / "a8")
    ref = os.path.join(simdir, "reference.fasta")
    base = ["align", ref, simdir, "--backend", "scan", "--batch-reads", "16"]
    assert cli.main(base + ["-o", out1, "--devices", "1"]) == 0
    assert cli.main(base + ["-o", out8, "--devices", "8"]) == 0
    files = sorted(os.listdir(out1))
    assert files == sorted(os.listdir(out8))
    for f in files:
        assert (open(os.path.join(out1, f), "rb").read()
                == open(os.path.join(out8, f), "rb").read()), f


def test_prefetched_reraises_worker_errors():
    """A failure while preparing a batch must surface in the loop, not end
    the stream as if the input were exhausted."""
    def prepare(g):
        if g == 2:
            raise RuntimeError("prep failed")
        return g

    got = []
    with pytest.raises(RuntimeError, match="prep failed"):
        for item in cli._prefetched(iter(range(5)), prepare):
            got.append(item)
    assert got == [0, 1]


@pytest.mark.parametrize("cmd", ["align", "snp"])
def test_backend_cuda_without_gpu_fails_up_front(simdir, tmp_path, cmd):
    """--backend cuda on a host without a GPU raises before any ingest:
    nothing runs in an interpreter, nothing retries on the CPU."""
    out = str(tmp_path / ("out.vcf" if cmd == "snp" else "aln"))
    with pytest.raises(RuntimeError, match="needs a GPU"):
        cli.main([cmd, os.path.join(simdir, "reference.fasta"), simdir,
                  "-o", out, "--backend", "cuda"])
