"""Accuracy harness: recall / precision / F1 over coverage × noise × SNP
density, plus cross-backend call diffs (SURVEY.md §7.3 item 1, §4 item 5).

Simulated truth (the interim oracle — reference mount empty, SURVEY.md
header): plant SNPs into a reference at a given density, simulate reads from
the TRUE genome at a given coverage/noise with honest error processes (2%
basecall substitutions, 5% indels, 3% pore skip events), run the production
pipeline (anchor → banded DP → local rescore → accumulate → call), and score
the calls against the planted truth.

Usage:
  python scripts/accuracy_sweep.py --grid quick --backend scan
  python scripts/accuracy_sweep.py --grid full --backend cuda --markdown  # GPU

Prints one JSON line per (cell, backend) and, with --markdown, a table ready
for BASELINE.md. With --backend both, also reports the per-cell symmetric
difference between scan and cuda call sets (cross-backend concordance).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")  # repo-root script


@dataclasses.dataclass(frozen=True)
class Cell:
    coverage: int
    noise: float
    density: float       # SNPs per base
    read_len: int = 600
    genome_len: int = 8000


QUICK_GRID = [
    Cell(coverage=6, noise=0.8, density=1 / 1000),
    Cell(coverage=12, noise=0.8, density=1 / 1000),
    Cell(coverage=12, noise=1.0, density=1 / 500),
]

FULL_GRID = [
    Cell(coverage=c, noise=nz, density=d)
    for c in (4, 8, 16)
    for nz in (0.8, 1.0, 1.2)
    for d in (1 / 2000, 1 / 500)
]


def build_world(cell: Cell, seed: int):
    """Truth genome + SNP-planted reference + simulated reads."""
    from nadavca_tpu.genome import Genome, decode_bases
    from nadavca_tpu.io.simulator import random_genome, simulate_read
    from nadavca_tpu.kmer_model import default_model

    rng = np.random.default_rng(seed)
    model = default_model()
    true_genome = random_genome(rng, length=cell.genome_len)
    ref_codes = true_genome["ref"].codes.copy()
    k = model.k
    n_snps = max(1, int(cell.density * cell.genome_len))
    # min spacing 2k keeps each SNP's k-mer neighborhood independent
    candidates = rng.permutation(np.arange(2 * k, cell.genome_len - 2 * k))
    positions, last_taken = [], []
    for p in candidates:
        if all(abs(p - q) >= 2 * k for q in last_taken[-8:]) and \
           all(abs(p - q) >= 2 * k for q in positions):
            positions.append(int(p))
            if len(positions) == n_snps:
                break
    truth = {}
    for p in positions:
        orig = int(ref_codes[p])
        ref_codes[p] = (orig + 1 + int(rng.integers(0, 3))) % 4
        truth[p] = orig
    ref_genome = Genome.from_dict({"ref": decode_bases(ref_codes)})

    n_reads = int(np.ceil(cell.coverage * cell.genome_len / cell.read_len))
    reads = [
        simulate_read(
            true_genome, "ref", model, rng, read_len=cell.read_len,
            start=int(rng.integers(0, cell.genome_len - cell.read_len + 1)),
            strand=1 if rng.random() < 0.5 else -1,
            mean_dwell=9.0, noise_scale=cell.noise,
            basecall_sub_rate=0.02, basecall_ins_rate=0.025,
            basecall_del_rate=0.025, skip_prob=0.03,
        )
        for _ in range(n_reads)
    ]
    return model, true_genome, ref_genome, reads, truth


def run_cell(cell: Cell, backend: str, seed: int, cfg=None):
    """Run the pipeline on one cell; returns (metrics dict, call set)."""
    import jax
    import jax.numpy as jnp

    from nadavca_tpu import call as callmod
    from nadavca_tpu.anchor import SeedIndex
    from nadavca_tpu.config import AlignConfig
    from nadavca_tpu.pipeline import (align_batch, assemble_batch,
                                      preprocess_read)

    cfg = cfg or AlignConfig()
    model, true_genome, ref_genome, reads, truth = build_world(cell, seed)
    index = SeedIndex(ref_genome)
    t0 = time.time()
    records = []
    for rd in reads:
        rec = preprocess_read(rd.signal.astype(np.float32), rd.basecall,
                              rd.move_index, index, ref_genome, rd.read_id)
        if rec is not None:
            records.append(rec)
    G = len(ref_genome["ref"])
    acc, cov, votes = callmod.make_accumulators(G, with_votes=True)
    records.sort(key=lambda r: len(r.signal))
    BR = 256
    for i in range(0, len(records), BR):
        group = records[i : i + BR]
        batch = assemble_batch(group, model, cfg)
        out = align_batch(batch, model, cfg, backend=backend)
        acc, cov, votes = callmod.accumulate_batch(
            acc, cov, out["base_loglik"],
            jnp.asarray(batch.window_start), jnp.asarray(batch.window_len),
            jnp.asarray(batch.strand), votes=votes, cfg=cfg,
        )
    # min_coverage matches the CLI default (3 since the 2026-08-20
    # threshold sweep: votes>=3 + cov>=3 removes the 4x-coverage FP floor;
    # sites below it are honest no-calls and excluded from recall)
    min_cov = 3
    if cfg.snp_joint_rescore:
        from nadavca_tpu import joint

        metas = [joint.ReadMeta(r.read_id, r.anchor.contig,
                                int(r.anchor.ref_start), len(r.window_codes),
                                int(r.anchor.strand)) for r in records]
        calls = joint.refine_contig_calls(
            np.asarray(acc), np.asarray(cov), np.asarray(votes),
            ref_genome["ref"].codes, "ref", cfg, model, metas,
            {r.read_id: r for r in records}, min_coverage=min_cov)
    else:
        calls = callmod.call_snps(
            np.asarray(acc), np.asarray(cov), ref_genome["ref"].codes, "ref",
            cfg, min_coverage=min_cov, votes=np.asarray(votes),
        )
    wall = time.time() - t0
    cov_np = np.asarray(cov)
    called = {(c.position, c.alt_base) for c in calls}
    truth_set = {(p, "ACGT"[b]) for p, b in truth.items()}
    # only truth positions with callable coverage count toward recall
    callable_truth = {(p, a) for (p, a) in truth_set if cov_np[p] >= min_cov}
    tp = len(called & callable_truth)
    fp = len(called - truth_set)
    fn = len(callable_truth - called)
    # adjacent-shift calls: an FP within k bases of an FN truth site is the
    # documented signal-space k-mer ambiguity mode (BASELINE.md 2026-08-18
    # soak: every backend makes the identical shifted call), not a
    # kernel bug — reported separately so the table stays honest
    fp_pos = sorted(p for (p, _) in (called - truth_set))
    fn_pos = sorted(p for (p, _) in (callable_truth - called))
    k = model.k
    n_shifted = sum(1 for p in fp_pos if any(abs(p - q) <= k for q in fn_pos))
    recall = tp / max(1, tp + fn)
    precision = tp / max(1, tp + fp)
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall else 0.0)
    metrics = dict(
        coverage=cell.coverage, noise=cell.noise, density=cell.density,
        backend=backend, n_reads=len(reads), n_anchored=len(records),
        n_truth=len(truth_set), n_callable=len(callable_truth),
        tp=tp, fp=fp, fn=fn, n_shifted=n_shifted,
        recall=round(recall, 4), precision=round(precision, 4),
        f1=round(f1, 4), wall_s=round(wall, 1),
    )
    return metrics, called


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", choices=("quick", "full"), default="quick")
    ap.add_argument("--backend", choices=("scan", "cuda", "both"),
                    default="scan",
                    help="cuda needs a GPU; both compares the call sets")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--markdown", action="store_true")
    args = ap.parse_args()

    from nadavca_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()

    grid = QUICK_GRID if args.grid == "quick" else FULL_GRID
    backends = ["scan", "cuda"] if args.backend == "both" else [args.backend]
    rows = []
    for cell in grid:
        cell_calls = {}
        for be in backends:
            m, calls = run_cell(cell, be, args.seed)
            cell_calls[be] = calls
            print(json.dumps(m), flush=True)
            rows.append(m)
        if len(backends) == 2:
            diff = cell_calls["scan"] ^ cell_calls["cuda"]
            print(json.dumps(dict(
                coverage=cell.coverage, noise=cell.noise,
                density=cell.density, backend="scan^cuda",
                n_call_diffs=len(diff), diffs=sorted(diff)[:10],
            )), flush=True)

    if args.markdown:
        print("\n| coverage | noise | SNP density | backend | recall | "
              "precision | F1 | TP/FP/FN |")
        print("|---|---|---|---|---|---|---|---|")
        for m in rows:
            print(f"| {m['coverage']}× | {m['noise']} | 1/{int(1/m['density'])} "
                  f"| {m['backend']} | {m['recall']:.3f} | {m['precision']:.3f} "
                  f"| {m['f1']:.3f} | {m['tp']}/{m['fp']}/{m['fn']} |")


if __name__ == "__main__":
    main()
