"""Config-4 validation: whole bacterial genome (4.6 Mb) end-to-end.

Exercises the BASELINE.json config 4 shape on whatever backend is available:
full-genome seed index, reads scattered genome-wide, (G, 4) locus
accumulators + votes at G = 4.6e6, scatter-add merge, and SNP calling.
Reports wall-clock per stage and peak accumulator memory.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from nadavca_tpu import call as callmod
from nadavca_tpu.anchor import SeedIndex
from nadavca_tpu.config import AlignConfig
from nadavca_tpu.genome import Genome, decode_bases
from nadavca_tpu.io.simulator import random_genome, simulate_read
from nadavca_tpu.kmer_model import default_model
from nadavca_tpu.pipeline import align_batch, assemble_batch, preprocess_read
from nadavca_tpu.utils.cache import enable_compile_cache

G_LEN = 4_600_000
N_READS = 64
READ_LEN = 800
N_SNPS = 40


def main():
    enable_compile_cache()
    cfg = AlignConfig()
    rng = np.random.default_rng(1)
    model = default_model()

    t0 = time.time()
    genome = random_genome(rng, length=G_LEN)
    ref_codes = genome["ref"].codes.copy()
    snp_pos = np.sort(rng.choice(G_LEN - 20, size=N_SNPS, replace=False) + 10)
    truth = {}
    for p in snp_pos:
        orig = int(ref_codes[p])
        ref_codes[p] = (orig + 1) % 4
        truth[int(p)] = orig
    ref_genome = Genome.from_dict({"ref": ""})
    ref_genome.contigs[0].codes = ref_codes
    ref_genome._by_name = {"ref": ref_genome.contigs[0]}
    print(f"genome build: {time.time()-t0:.1f}s", flush=True)

    t0 = time.time()
    index = SeedIndex(ref_genome)
    print(f"seed index (4.6 Mb): {time.time()-t0:.1f}s", flush=True)

    # reads clustered around a few SNPs so the parity check has coverage
    t0 = time.time()
    reads = []
    for i in range(N_READS):
        p = int(snp_pos[i % min(8, N_SNPS)])
        start = max(0, p - READ_LEN // 2 + int(rng.integers(-100, 100)))
        reads.append(simulate_read(genome, "ref", model, rng,
                                   read_len=READ_LEN, start=start, strand=1 if i % 2 else -1))
    print(f"simulate {N_READS} reads: {time.time()-t0:.1f}s", flush=True)

    t0 = time.time()
    records = [
        preprocess_read(r.signal.astype(np.float32), r.basecall, r.move_index,
                        index, ref_genome, r.read_id, model=model)
        for r in reads
    ]
    records = [r for r in records if r is not None]
    print(f"anchor+calibrate: {time.time()-t0:.1f}s ({len(records)}/{N_READS} anchored)",
          flush=True)

    batch = assemble_batch(records, model, cfg)
    t0 = time.time()
    out = align_batch(batch, model, cfg, backend="auto")
    np.asarray(out["score"])
    print(f"align+rescore (compile+run): {time.time()-t0:.1f}s", flush=True)

    t0 = time.time()
    acc, cov, votes = callmod.make_accumulators(G_LEN, with_votes=True)
    acc, cov, votes = callmod.accumulate_batch(
        acc, cov, out["base_loglik"], jnp.asarray(batch.window_start),
        jnp.asarray(batch.window_len), jnp.asarray(batch.strand),
        votes=votes, cfg=cfg,
    )
    calls = callmod.call_snps(np.asarray(acc), np.asarray(cov),
                              ref_codes, "ref", cfg, min_coverage=2,
                              votes=np.asarray(votes))
    print(f"accumulate(G=4.6M)+call: {time.time()-t0:.1f}s", flush=True)

    hits = sum(1 for c in calls if c.position in truth
               and "ACGT"[truth[c.position]] == c.alt_base)
    fps = sum(1 for c in calls if c.position not in truth)
    covered = [p for p in truth if np.asarray(cov)[p] >= 2]
    print(f"calls: {len(calls)} (true {hits} / covered-truth {len(covered)}, FP {fps})",
          flush=True)
    assert hits >= max(1, len(covered) - 1), "missed covered SNPs"
    assert fps <= 2, f"too many FPs: {fps}"
    print("CONFIG4_OK", flush=True)


if __name__ == "__main__":
    main()
