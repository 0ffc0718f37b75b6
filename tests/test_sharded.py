"""Multi-device sharding: shard_map pipeline on the 8-device CPU mesh.

SURVEY.md §4 item 4: N-way sharded locus accumulators must merge to exactly
the 1-device result; genome-sharded (psum_scatter) and replicated (psum)
layouts must agree. The sharded step wraps pipeline.device_compute — the
same body as the single-device program — so these tests also pin the two
paths to each other (tests/test_cuda_dp.py checks that the cuda backend's
custom calls lower inside shard_map).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nadavca_tpu.config import AlignConfig
from nadavca_tpu.io.simulator import random_genome, simulate_read
from nadavca_tpu.kmer_model import default_model
from nadavca_tpu.parallel import sharded
from nadavca_tpu.pipeline import assemble_batch, align_batch, preprocess_read, stage_batch
from nadavca_tpu import call as callmod
from nadavca_tpu.anchor import SeedIndex

CFG = AlignConfig()

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(31)
    model = default_model()
    genome = random_genome(rng, length=2048)
    index = SeedIndex(genome)
    reads = [
        simulate_read(genome, "ref", model, rng, read_len=300,
                      strand=1 if i % 2 else -1)
        for i in range(16)
    ]
    records = [
        preprocess_read(r.signal.astype(np.float32), r.basecall, r.move_index,
                        index, genome, r.read_id)
        for r in reads
    ]
    records = [r for r in records if r is not None]
    batch = assemble_batch(records[:16], model, CFG, pad_reads_to=16)
    return model, genome, batch


def _run(mesh_n, batch, model, genome, genome_sharded, backend="scan"):
    G = len(genome["ref"])
    mesh = sharded.make_mesh(mesh_n, CFG.data_axis)
    staged = stage_batch(batch, model, CFG, backend)
    step = sharded.make_sharded_step(
        mesh, CFG, G, backend=staged["backend"], k=model.k,
        genome_sharded=genome_sharded,
    )
    acc, cov, votes = sharded.make_accumulators_sharded(mesh, CFG, G, genome_sharded)
    staged = sharded.shard_staged(mesh, CFG, staged)
    arrays = sharded.shard_batch_arrays(mesh, CFG, {
        "wstart": jnp.asarray(batch.window_start),
        "wlen": jnp.asarray(batch.window_len),
        "strand": jnp.asarray(batch.strand),
    })
    inputs = {k: v for k, v in staged.items() if k not in ("backend", "k")}
    score, path, acc, cov, votes = step(
        inputs, arrays["wstart"], arrays["wlen"], arrays["strand"],
        acc, cov, votes,
    )
    return (np.asarray(score), np.asarray(path), np.asarray(acc),
            np.asarray(cov), np.asarray(votes))


def test_sharded_matches_single_device(world):
    model, genome, batch = world
    s8, p8, acc8, cov8, v8 = _run(8, batch, model, genome, genome_sharded=False)
    s1, p1, acc1, cov1, v1 = _run(1, batch, model, genome, genome_sharded=False)
    np.testing.assert_allclose(s8, s1, rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(p8, p1)
    np.testing.assert_array_equal(cov8, cov1)
    np.testing.assert_array_equal(v8, v1)
    np.testing.assert_allclose(acc8, acc1, rtol=1e-4, atol=1e-2)


def test_genome_sharded_accumulators_match(world):
    model, genome, batch = world
    _, _, acc_r, cov_r, v_r = _run(8, batch, model, genome, genome_sharded=False)
    _, _, acc_s, cov_s, v_s = _run(8, batch, model, genome, genome_sharded=True)
    np.testing.assert_array_equal(cov_s, cov_r)
    np.testing.assert_array_equal(v_s, v_r)
    np.testing.assert_allclose(acc_s, acc_r, rtol=1e-4, atol=1e-2)


def test_sharded_matches_unsharded_pipeline(world):
    """The shard_map path must equal the plain single-process align_batch."""
    model, genome, batch = world
    out = align_batch(batch, model, CFG, backend="scan")
    s8, p8, _, _, _ = _run(8, batch, model, genome, genome_sharded=False)
    np.testing.assert_allclose(np.asarray(out["score"]), s8, rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(np.asarray(out["path"]), p8)


def test_sharded_matches_accumulate_batch(world):
    """psum aggregation == call.accumulate_batch (shared scatter semantics)."""
    model, genome, batch = world
    G = len(genome["ref"])
    _, _, acc8, cov8, v8 = _run(8, batch, model, genome, genome_sharded=False)
    out = align_batch(batch, model, CFG, backend="scan")
    acc, cov, votes = callmod.make_accumulators(G, with_votes=True)
    acc, cov, votes = callmod.accumulate_batch(
        acc, cov, out["base_loglik"],
        jnp.asarray(batch.window_start), jnp.asarray(batch.window_len),
        jnp.asarray(batch.strand), votes=votes, cfg=CFG,
    )
    np.testing.assert_array_equal(np.asarray(cov), cov8)
    np.testing.assert_array_equal(np.asarray(votes), v8)
    np.testing.assert_allclose(np.asarray(acc), acc8, rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("genome_sharded", [False, True])
def test_deferred_merge_matches_per_batch(world, genome_sharded):
    """merge_deferred: two batches of local-partial accumulation + ONE
    collective at merge time must equal the per-batch-psum state (the
    production contract behind the checkpoint/finalize-time merge)."""
    model, genome, batch = world
    G = len(genome["ref"])
    mesh = sharded.make_mesh(8, CFG.data_axis)
    staged0 = stage_batch(batch, model, CFG, "scan")
    arrays = sharded.shard_batch_arrays(mesh, CFG, {
        "wstart": jnp.asarray(batch.window_start),
        "wlen": jnp.asarray(batch.window_len),
        "strand": jnp.asarray(batch.strand),
    })
    inputs = sharded.shard_staged(mesh, CFG, staged0)
    inputs = {k: v for k, v in inputs.items() if k not in ("backend", "k")}

    def run(merge_deferred):
        step = sharded.make_sharded_step(
            mesh, CFG, G, backend=staged0["backend"], k=model.k,
            genome_sharded=genome_sharded, merge_deferred=merge_deferred,
            with_path=False,
        )
        acc, cov, votes = sharded.make_accumulators_sharded(
            mesh, CFG, G, genome_sharded, merge_deferred=merge_deferred)
        for _ in range(2):  # two batches: partials must accumulate
            _, acc, cov, votes = step(
                inputs, arrays["wstart"], arrays["wlen"], arrays["strand"],
                acc, cov, votes)
        if merge_deferred:
            merge = sharded.make_merge_fn(mesh, CFG, G, genome_sharded)
            m1 = merge(acc, cov, votes)
            m2 = merge(acc, cov, votes)  # pure: partials untouched
            np.testing.assert_array_equal(np.asarray(m1[1]),
                                          np.asarray(m2[1]))
            acc, cov, votes = m1
        return np.asarray(acc), np.asarray(cov), np.asarray(votes)

    acc_d, cov_d, votes_d = run(True)
    acc_p, cov_p, votes_p = run(False)
    np.testing.assert_array_equal(cov_d, cov_p)
    np.testing.assert_array_equal(votes_d, votes_p)
    np.testing.assert_allclose(acc_d, acc_p, rtol=1e-4, atol=1e-2)
