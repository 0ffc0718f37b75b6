"""Edge cases: N bases in the reference, single-read batches, tiny windows."""

import numpy as np
import jax.numpy as jnp
import pytest

from nadavca_tpu import call
from nadavca_tpu.anchor import SeedIndex
from nadavca_tpu.config import AlignConfig
from nadavca_tpu.genome import Genome, decode_bases
from nadavca_tpu.io.simulator import random_genome, simulate_read
from nadavca_tpu.kmer_model import default_model
from nadavca_tpu.pipeline import align_batch, assemble_batch, preprocess_read

CFG = AlignConfig()


def test_reference_with_N_bases():
    """An N run in the reference must not crash the pipeline and must never
    be called as a SNP (ref>3 masked)."""
    rng = np.random.default_rng(8)
    model = default_model()
    clean = random_genome(rng, length=1200)
    codes = clean["ref"].codes.copy()
    codes[600:620] = 4  # N run
    genome = Genome.from_dict({"ref": decode_bases(codes)})
    index = SeedIndex(genome)
    # reads simulated from the clean genome, aligned against the N-containing one
    reads = [
        simulate_read(clean, "ref", model, rng, read_len=300,
                      start=int(rng.integers(400, 700)), strand=1)
        for _ in range(8)
    ]
    records = [
        preprocess_read(r.signal.astype(np.float32), r.basecall, r.move_index,
                        index, genome, r.read_id, model=model)
        for r in reads
    ]
    records = [r for r in records if r is not None]
    assert records, "all reads lost to anchoring"
    batch = assemble_batch(records, model, CFG)
    out = align_batch(batch, model, CFG, backend="scan")
    G = len(genome["ref"])
    acc, cov, votes = call.make_accumulators(G, with_votes=True)
    acc, cov, votes = call.accumulate_batch(
        acc, cov, out["base_loglik"], jnp.asarray(batch.window_start),
        jnp.asarray(batch.window_len), jnp.asarray(batch.strand),
        votes=votes, cfg=CFG,
    )
    calls = call.call_snps(np.asarray(acc), np.asarray(cov), codes, "ref",
                           CFG, min_coverage=1, votes=np.asarray(votes))
    assert all(not (600 <= c.position < 620) for c in calls), calls


def test_single_read_batch():
    rng = np.random.default_rng(9)
    model = default_model()
    genome = random_genome(rng, length=600)
    index = SeedIndex(genome)
    rd = simulate_read(genome, "ref", model, rng, read_len=200, strand=1)
    rec = preprocess_read(rd.signal.astype(np.float32), rd.basecall,
                          rd.move_index, index, genome, rd.read_id, model=model)
    batch = assemble_batch([rec], model, CFG)
    assert batch.n_reads == 1
    out = align_batch(batch, model, CFG, backend="scan")
    assert np.isfinite(np.asarray(out["score"][0]))


def test_window_shorter_than_band():
    """Reference window much narrower than the band width."""
    rng = np.random.default_rng(10)
    model = default_model()
    genome = random_genome(rng, length=60)  # < band_width k-mer positions
    rd = simulate_read(genome, "ref", model, rng, read_len=60, strand=1,
                       basecall_sub_rate=0.0)
    from nadavca_tpu.ops import dp_spec

    mu, sigma = model.expected_signal(rd.window_codes)
    lo = dp_spec.make_band(rd.true_path.astype(np.float64), len(mu),
                           CFG.band_width)
    score, path = dp_spec.banded_viterbi(
        rd.signal, mu.astype(np.float64), sigma.astype(np.float64), lo, CFG)
    err = np.abs(path - rd.true_path)
    assert np.mean(err <= 2) > 0.9
