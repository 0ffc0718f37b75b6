"""Caller threshold sweep over the accuracy grid and the skip-transition
end-to-end comparison.

The expensive pipeline (anchor -> banded DP -> rescore -> accumulate) runs
ONCE per grid cell; the calling thresholds (snp_threshold x
snp_min_alt_votes x snp_vote_margin x min_coverage) only affect the final
host-side ``call_snps`` pass, so the whole sweep costs one pipeline run per
cell plus milliseconds per combo.

Usage:
  python scripts/threshold_sweep.py --backend cuda              # GPU
  python scripts/threshold_sweep.py --backend scan              # CPU
  python scripts/threshold_sweep.py --backend scan --use-skip   # skip DP

Prints per-combo aggregate TP/FP/FN over the grid (micro-averaged), the
per-cell table for the best combo, and a markdown row block for BASELINE.md.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import sys

import numpy as np

sys.path.insert(0, ".")

from accuracy_sweep import FULL_GRID, QUICK_GRID, build_world  # noqa: E402


def accumulate_cell(cell, backend, seed, cfg):
    """One pipeline run; returns (acc, cov, votes, truth, ref_genome, k)."""
    import jax.numpy as jnp

    from nadavca_tpu import call as callmod
    from nadavca_tpu.anchor import SeedIndex
    from nadavca_tpu.pipeline import (align_batch, assemble_batch,
                                      preprocess_read)

    model, true_genome, ref_genome, reads, truth = build_world(cell, seed)
    index = SeedIndex(ref_genome)
    records = []
    for rd in reads:
        rec = preprocess_read(rd.signal.astype(np.float32), rd.basecall,
                              rd.move_index, index, ref_genome, rd.read_id)
        if rec is not None:
            records.append(rec)
    G = len(ref_genome["ref"])
    acc, cov, votes = callmod.make_accumulators(G, with_votes=True)
    records.sort(key=lambda r: len(r.signal))
    for i in range(0, len(records), 256):
        group = records[i : i + 256]
        batch = assemble_batch(group, model, cfg)
        out = align_batch(batch, model, cfg, backend=backend)
        acc, cov, votes = callmod.accumulate_batch(
            acc, cov, out["base_loglik"],
            jnp.asarray(batch.window_start), jnp.asarray(batch.window_len),
            jnp.asarray(batch.strand), votes=votes, cfg=cfg,
        )
    return (np.asarray(acc), np.asarray(cov), np.asarray(votes), truth,
            ref_genome, model.k)


def score(calls, truth, cov_np, k, min_cov):
    called = {(c.position, c.alt_base) for c in calls}
    truth_set = {(p, "ACGT"[b]) for p, b in truth.items()}
    callable_truth = {(p, a) for (p, a) in truth_set if cov_np[p] >= min_cov}
    tp = len(called & callable_truth)
    fp = len(called - truth_set)
    fn = len(callable_truth - called)
    fp_pos = sorted(p for (p, _) in (called - truth_set))
    fn_pos = sorted(p for (p, _) in (callable_truth - called))
    shifted = sum(1 for p in fp_pos if any(abs(p - q) <= k for q in fn_pos))
    return tp, fp, fn, shifted


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", choices=("scan", "cuda"), default="scan")
    ap.add_argument("--grid", choices=("quick", "full"), default="full")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--use-skip", action="store_true",
                    help="enable the DP skip transition (log_p_skip=-3.5, "
                         "matching the simulator's 3%% pore-skip rate)")
    args = ap.parse_args()

    from nadavca_tpu import call as callmod
    from nadavca_tpu.config import AlignConfig
    from nadavca_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    base_cfg = AlignConfig()
    if args.use_skip:
        base_cfg = dataclasses.replace(base_cfg, use_skip=True,
                                       log_p_skip=-3.5)
    grid = FULL_GRID if args.grid == "full" else QUICK_GRID

    cells = []
    for cell in grid:
        acc, cov, votes, truth, ref_genome, k = accumulate_cell(
            cell, args.backend, args.seed, base_cfg)
        cells.append((cell, acc, cov, votes, truth, ref_genome, k))
        print(f"# accumulated {cell}", file=sys.stderr, flush=True)

    combos = list(itertools.product(
        (0.9, 0.95, 0.99),      # snp_threshold
        (2, 3),                 # snp_min_alt_votes
        (3.0, 5.0, 8.0),        # snp_vote_margin
        (2, 3),                 # min_coverage
    ))
    results = []
    for thr, mav, margin, min_cov in combos:
        cfg = dataclasses.replace(base_cfg, snp_threshold=thr,
                                  snp_min_alt_votes=mav,
                                  snp_vote_margin=margin)
        tot = np.zeros(4, np.int64)
        per_cell = []
        for cell, acc, cov, votes, truth, ref_genome, k in cells:
            calls = callmod.call_snps(
                acc, cov, ref_genome["ref"].codes, "ref", cfg,
                min_coverage=min_cov, votes=votes)
            s = score(calls, truth, cov, k, min_cov)
            tot += s
            per_cell.append((cell, s))
        tp, fp, fn, shifted = (int(v) for v in tot)
        rec = tp / max(1, tp + fn)
        prec = tp / max(1, tp + fp)
        f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
        results.append(dict(
            snp_threshold=thr, snp_min_alt_votes=mav, snp_vote_margin=margin,
            min_coverage=min_cov, tp=tp, fp=fp, fn=fn, shifted=shifted,
            recall=round(rec, 4), precision=round(prec, 4), f1=round(f1, 4),
            per_cell=per_cell))
        r = dict(results[-1])
        r.pop("per_cell")
        print(json.dumps(r), flush=True)

    results.sort(key=lambda r: (-r["f1"], r["fp"], -r["tp"]))
    best = results[0]
    print("\n# best combo (micro-F1 over the grid):", file=sys.stderr)
    print(json.dumps({k: v for k, v in best.items() if k != "per_cell"}),
          flush=True)
    print("\n| coverage | noise | density | TP/FP/FN (shifted) |")
    print("|---|---|---|---|")
    for cell, (tp, fp, fn, sh) in best["per_cell"]:
        print(f"| {cell.coverage}x | {cell.noise} | "
              f"1/{int(1 / cell.density)} | {tp}/{fp}/{fn} ({sh}) |")


if __name__ == "__main__":
    main()
