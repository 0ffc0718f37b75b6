"""Each CUDA kernel against what XLA makes of the plain version, on the card.

    python scripts/kernel_timing.py [--reps 5] [--out chiprun_out/kernel_timing.json]

At the CLI's batch shapes (R=512 reads; B=128 with ~1,000-base reads, T
~10k samples, L=1,024; B=256 with ~2,500-base reads, T ~26k, L=2,560;
t_w=192, k=6) it times, each jitted and synced with block_until_ready
(median of --reps after a warm-up call):

  step       pipeline._device_step, backend cuda vs scan (end to end/batch)
  fill       the fill kernel vs the lax.scan fill (banded_viterbi_fill)
  backtrack  the CUDA walk vs the lax.scan walk of the same kernel bits
  rescore    the rescore kernel vs base_loglik_local_batch on one path

Needs a GPU. Prints the card's name and power limit beside the times.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def timed(fn, *args, reps=5):
    out = fn(*args)
    _block(out)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _block(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _block(out):
    import jax

    for leaf in jax.tree_util.tree_leaves(out):
        leaf.block_until_ready()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "kernel_timing.json"))
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    import chip_smoke
    from nadavca_tpu.config import AlignConfig
    from nadavca_tpu.ops import banded_dp, cuda_dp
    from nadavca_tpu.pipeline import _device_step
    from nadavca_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    dev = chip_smoke.phase_device(1)
    card = chip_smoke.nvidia_smi()[0]
    rows = []
    for band_width, read_len in ((128, 1000), (256, 2500)):
        cfg = dataclasses.replace(AlignConfig(), band_width=band_width)
        b, model, _ = chip_smoke.synthetic_batch(0, 512, read_len, band_width)
        R, T = b["x"].shape
        L = b["codes"].shape[1]
        lm = jnp.asarray(model.level_mean)
        ls = jnp.asarray(model.level_std)
        chunked = [b[k] for k in ("x", "t_len", "mu", "sigma", "n_ref", "lo",
                                  "delta")]
        step_args = chunked + [b["codes"], b["ids"], lm, ls]
        res = {}
        for backend in ("cuda", "scan"):
            f = jax.jit(lambda *a, be=backend: _device_step(
                *a, cfg=cfg, backend=be, k=model.k))
            res[f"step_{backend}"] = timed(f, *step_args, reps=args.reps)

        fill_k = jax.jit(lambda *a: cuda_dp.ffi_fill(*a, cfg))
        fill_x = jax.jit(lambda x, t, m, s, n, lo_full: (
            banded_dp.banded_viterbi_fill(x, t, m, s, n, lo_full, cfg)))
        res["fill_cuda"] = timed(fill_k, *chunked, reps=args.reps)
        res["fill_scan"] = timed(fill_x, *chunked[:5], b["lo_full"],
                                 reps=args.reps)

        bits, bits2, _, _ = fill_k(*chunked)
        vit = jax.jit(lambda *a: cuda_dp.cuda_viterbi_batch(*a, cfg))(*chunked)
        bt_args = (bits, bits2, b["lo"], b["delta"], vit.final_j, b["t_len"])
        res["backtrack_cuda"] = timed(jax.jit(cuda_dp.ffi_backtrack), *bt_args,
                                      reps=args.reps)
        res["backtrack_scan"] = timed(jax.jit(cuda_dp.reference_backtrack),
                                      *bt_args, reps=args.reps)

        rs_args = (b["x"], vit.path, b["t_len"], b["codes"], b["ids"], lm, ls)
        res["rescore_cuda"] = timed(jax.jit(
            lambda *a: cuda_dp.cuda_local_rescore(
                *a, model.k, cfg, t_w=cfg.snp_local_window)),
            *rs_args, reps=args.reps)
        res["rescore_xla"] = timed(jax.jit(
            lambda *a: banded_dp.base_loglik_local_batch(
                *a, model.k, cfg, t_w=cfg.snp_local_window)),
            *rs_args, reps=args.reps)
        row = dict(band_width=band_width, R=R, T=T, L=L, t_w=192, k=model.k,
                   card=card, device=dev, seconds=res)
        rows.append(row)
        print(json.dumps(row), flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
