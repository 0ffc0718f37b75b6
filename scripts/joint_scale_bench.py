"""Joint-pass cost at whole-genome scale.

Config-4 shape: 4.6 Mb genome, dense planted SNP clusters with real
coverage, production pipeline to accumulators, then the joint pass timed
stage by stage (cluster_plan / partial_deltas / decide) against the
pipeline wall. partial_deltas already batches every cluster's hypothesis
rows into ONE padded DP call per pass (joint.py: loc/score rows share the
static T_PAD x N_PAD shapes), so this measures the shipped batching.

Run: JAX_PLATFORMS=cpu python scripts/joint_scale_bench.py
"""

from __future__ import annotations

import os
import sys
import time

if not os.environ.get("JOINT_BENCH_DEVICE"):
    os.environ["JAX_PLATFORMS"] = "cpu"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax

# env overwrite alone is not enough where JAX_PLATFORMS is preset — mirror
# tests/conftest.py and update the config after import. Set
# JOINT_BENCH_DEVICE=1 to measure the default-device slab routing.
if not os.environ.get("JOINT_BENCH_DEVICE"):
    jax.config.update("jax_platforms", "cpu")
else:
    os.environ.pop("JAX_PLATFORMS", None)

import jax.numpy as jnp

from nadavca_tpu import call as callmod, joint
from nadavca_tpu.anchor import SeedIndex
from nadavca_tpu.config import AlignConfig
from nadavca_tpu.genome import Genome
from nadavca_tpu.io.simulator import random_genome, simulate_read
from nadavca_tpu.kmer_model import default_model
from nadavca_tpu.pipeline import align_batch, assemble_batch, preprocess_read

G_LEN = 4_600_000
N_CLUSTERS = 16        # planted SNP sites with coverage
READS_PER = 16         # covering reads per site (16x)
READ_LEN = 800


def main():
    from nadavca_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    rng = np.random.default_rng(4)
    model = default_model()
    cfg = AlignConfig()
    if os.environ.get("JOINT_BENCH_DEVICE"):
        import dataclasses
        cfg = dataclasses.replace(cfg, snp_joint_device="default")
    k = model.k

    t0 = time.time()
    genome = random_genome(rng, length=G_LEN)
    ref_codes = genome["ref"].codes.copy()
    snp_pos = np.sort(rng.choice(
        np.arange(2000, G_LEN - 2000), size=N_CLUSTERS, replace=False))
    truth = {}
    for p in snp_pos:
        orig = int(ref_codes[p])
        ref_codes[p] = (orig + 1 + int(rng.integers(0, 3))) % 4
        truth[int(p)] = orig
    ref_genome = Genome.from_dict({"ref": ""})
    ref_genome.contigs[0].codes = ref_codes
    ref_genome._by_name = {"ref": ref_genome.contigs[0]}
    index = SeedIndex(ref_genome)
    print(f"world build (4.6 Mb + index): {time.time()-t0:.1f}s", flush=True)

    t0 = time.time()
    reads = []
    for p in snp_pos:
        for _ in range(READS_PER):
            start = int(np.clip(p - READ_LEN // 2 + rng.integers(-150, 150),
                                0, G_LEN - READ_LEN - 1))
            reads.append(simulate_read(
                genome, "ref", model, rng, read_len=READ_LEN, start=start,
                strand=1 if rng.random() < 0.5 else -1, mean_dwell=9.0,
                basecall_sub_rate=0.02, basecall_ins_rate=0.025,
                basecall_del_rate=0.025, skip_prob=0.03))
    print(f"simulate {len(reads)} reads: {time.time()-t0:.1f}s", flush=True)

    t_pipe0 = time.time()
    records = []
    for r in reads:
        rec = preprocess_read(r.signal.astype(np.float32), r.basecall,
                              r.move_index, index, ref_genome, r.read_id,
                              model=model)
        if rec is not None:
            records.append(rec)
    acc, cov, votes = callmod.make_accumulators(G_LEN, with_votes=True)
    records.sort(key=lambda r: len(r.signal))
    for i in range(0, len(records), 128):
        group = records[i:i + 128]
        batch = assemble_batch(group, model, cfg)
        out = align_batch(batch, model, cfg, backend="scan")
        acc, cov, votes = callmod.accumulate_batch(
            acc, cov, out["base_loglik"], jnp.asarray(batch.window_start),
            jnp.asarray(batch.window_len), jnp.asarray(batch.strand),
            votes=votes, cfg=cfg)
    acc_np, cov_np, votes_np = map(np.asarray, (acc, cov, votes))
    t_pipe = time.time() - t_pipe0
    print(f"pipeline to accumulators ({len(records)} reads): {t_pipe:.1f}s",
          flush=True)

    metas = [joint.ReadMeta(r.read_id, r.anchor.contig,
                            int(r.anchor.ref_start), len(r.window_codes),
                            int(r.anchor.strand)) for r in records]
    records_by_id = {r.read_id: r for r in records}

    t0 = time.time()
    plan = joint.cluster_plan(acc_np, cov_np, votes_np, ref_codes, cfg,
                              min_coverage=3)
    t_plan = time.time() - t0
    n_hyp = sum(len(c.hyps) for c in plan)
    n_cov = sum(len(joint.reads_covering(c.span, metas, k)) for c in plan)
    print(f"cluster_plan: {t_plan*1e3:.0f} ms — {len(plan)} clusters, "
          f"{n_hyp} hypotheses, {n_cov} covering reads", flush=True)

    t0 = time.time()
    mats = joint.partial_deltas(plan, metas, records_by_id, model, cfg)
    t_pd = time.time() - t0
    rows = sum(m.shape[0] * (m.shape[1] - 1) for m in mats)
    print(f"partial_deltas: {t_pd:.2f}s — {rows} scored DP rows "
          f"(one batched locate pass + one batched score pass)", flush=True)

    t0 = time.time()
    calls = joint.decide(plan, mats, cov_np, ref_codes, "ref", cfg,
                         acc=acc_np)
    t_dec = time.time() - t0
    hits = sum(1 for c in calls if c.position in truth)
    print(f"decide: {t_dec*1e3:.0f} ms — {len(calls)} calls, "
          f"{hits}/{len(truth)} at true positions", flush=True)

    t_joint = t_plan + t_pd + t_dec
    print(f"\njoint pass total: {t_joint:.2f}s = "
          f"{100*t_joint/(t_pipe+t_joint):.1f}% of pipeline wall "
          f"({t_pipe:.1f}s)", flush=True)


if __name__ == "__main__":
    main()
