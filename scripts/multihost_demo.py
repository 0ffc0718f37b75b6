"""Multi-host demo/validation: N local processes, CPU devices, cross-process merge.

Launch (done automatically when run without args — spawns the workers):
    python scripts/multihost_demo.py            # coordinator + 2 workers
    python scripts/multihost_demo.py WORKER_ID  # internal

Validates BASELINE.json config 5's control flow without a pod: every process
joins a jax.distributed group, contributes its own reads through the UNIFIED
production step (pipeline.device_compute under shard_map — the same program
`cli snp --devices N` runs), and the psum-merged accumulators must equal a
single-process reference computed by the parent (written to REF_NPZ). Also
reports the per-batch collective traffic — the best config-5 scaling proxy
this sandbox allows.

Driven by tests/test_multihost.py.
"""

import os
import subprocess
import sys
import tempfile

# the repo may not be pip-installed in the spawned interpreters — make the
# package importable regardless of the caller's environment
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)

N_PROC = 2
PORT = int(os.environ.get("MULTIHOST_DEMO_PORT", "9378"))
REF_NPZ = os.environ.get("MULTIHOST_DEMO_REF", "")


def _world():
    """Deterministic world shared by every process: genome, model, records."""
    import numpy as np

    from nadavca_tpu.anchor import SeedIndex
    from nadavca_tpu.config import AlignConfig
    from nadavca_tpu.io.simulator import random_genome, simulate_read
    from nadavca_tpu.kmer_model import default_model
    from nadavca_tpu.pipeline import preprocess_read

    cfg = AlignConfig()
    rng = np.random.default_rng(7)
    model = default_model()
    genome = random_genome(rng, length=1024)
    index = SeedIndex(genome)
    reads = [
        simulate_read(genome, "ref", model, rng, read_len=200, strand=1)
        for _ in range(8)
    ]
    records = [
        preprocess_read(r.signal.astype(np.float32), r.basecall, r.move_index,
                        index, genome, r.read_id)
        for r in reads
    ]
    return cfg, model, genome, [r for r in records if r is not None]


def make_reference(out_npz: str) -> None:
    """Single-process reference accumulators for the full read set."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import jax.numpy as jnp

    from nadavca_tpu import call as callmod
    from nadavca_tpu.pipeline import align_batch, assemble_batch

    cfg, model, genome, records = _world()
    G = len(genome["ref"])
    acc, cov, votes = callmod.make_accumulators(G, with_votes=True)
    for half in (records[:4], records[4:]):
        batch = assemble_batch(half, model, cfg, pad_reads_to=8)
        out = align_batch(batch, model, cfg, backend="scan")
        acc, cov, votes = callmod.accumulate_batch(
            acc, cov, out["base_loglik"],
            jnp.asarray(batch.window_start), jnp.asarray(batch.window_len),
            jnp.asarray(batch.strand), votes=votes, cfg=cfg,
        )
    np.savez(out_npz, acc=np.asarray(acc), cov=np.asarray(cov),
             votes=np.asarray(votes))


def worker(pid: int) -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax

    jax.config.update("jax_platforms", "cpu")
    from nadavca_tpu.parallel import distributed as dist

    dist.initialize_distributed(f"127.0.0.1:{PORT}", N_PROC, pid)
    assert jax.process_count() == N_PROC
    n_dev = len(jax.devices())
    print(f"[proc {pid}] joined: {n_dev} global devices", flush=True)

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from nadavca_tpu.parallel import sharded
    from nadavca_tpu.pipeline import assemble_batch, stage_batch

    cfg, model, genome, records = _world()
    mesh = Mesh(np.array(jax.devices()).reshape(-1), (cfg.data_axis,))

    # each host contributes its own half of the reads (shared-nothing ingest)
    local = records[pid * 4:(pid + 1) * 4]
    # pad so every one of the 8 global devices gets rows
    batch = assemble_batch(local, model, cfg, pad_reads_to=32)
    # the production config-5 layout: genome-SHARDED accumulators merged by
    # psum_scatter across the processes — not the replicated layout
    staged = stage_batch(batch, model, cfg, "scan")
    local_arrays = {k: np.asarray(v) for k, v in staged.items()
                    if k not in ("backend", "k")}
    local_arrays.update(
        wstart=batch.window_start, wlen=batch.window_len, strand=batch.strand)

    G = len(genome["ref"])
    assert G % (n_dev * 128) == 0, (G, n_dev)
    step = sharded.make_sharded_step(mesh, cfg, G, backend="scan",
                                     k=model.k, genome_sharded=True)
    acc, cov, votes = sharded.make_accumulators_sharded(
        mesh, cfg, G, genome_sharded=True)
    arrays = dist.global_staged_from_local(local_arrays, mesh, cfg)
    inputs = {k: v for k, v in arrays.items()
              if k not in ("wstart", "wlen", "strand")}
    score, path, acc, cov, votes = step(
        inputs, arrays["wstart"], arrays["wlen"], arrays["strand"],
        acc, cov, votes,
    )
    # genome-sharded accumulators: reassemble the global value on host
    cov_h = dist.fetch_replicated(cov)
    acc_h = dist.fetch_replicated(acc)
    votes_h = dist.fetch_replicated(votes)
    assert cov_h.shape == (G,), cov_h.shape
    if pid == 0:
        # per-batch collective traffic of the genome-sharded layout: one
        # psum_scatter each for acc/cov/votes — each device RECEIVES only
        # its G/n_dev genome slice (1/n_dev of the replicated layout's psum)
        coll_bytes = (G * 4 * 4 + G * 4 + G * 4 * 4) // n_dev
        print(f"[proc 0] collective traffic/batch: {coll_bytes} bytes "
              f"(G={G}); batch payload ~{sum(v.nbytes for v in local_arrays.values())} bytes",
              flush=True)
        if REF_NPZ and os.path.exists(REF_NPZ):
            ref = np.load(REF_NPZ)
            np.testing.assert_array_equal(cov_h, ref["cov"])
            np.testing.assert_array_equal(votes_h, ref["votes"])
            np.testing.assert_allclose(acc_h, ref["acc"], rtol=1e-5, atol=1e-3)
            print("[proc 0] merged accumulators == single-process reference",
                  flush=True)
        total = int(cov_h.sum())
        assert total > 0
        print("MULTIHOST_OK", flush=True)


def main() -> None:
    if len(sys.argv) > 1:
        worker(int(sys.argv[1]))
        return
    global REF_NPZ
    if not REF_NPZ:
        REF_NPZ = os.path.join(tempfile.mkdtemp(), "ref.npz")
    # parent computes the single-process reference before spawning workers
    rc = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.argv=['x']; "
         f"sys.path.insert(0, {os.path.dirname(os.path.abspath(__file__))!r}); "
         f"import multihost_demo as m; m.make_reference({REF_NPZ!r})"],
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    if rc.returncode:
        sys.exit(rc.returncode)
    env = {**os.environ, "MULTIHOST_DEMO_REF": REF_NPZ}
    procs = [
        subprocess.Popen([sys.executable, __file__, str(i)], env=env)
        for i in range(N_PROC)
    ]
    rcs = [p.wait(timeout=560) for p in procs]
    if any(rcs):
        sys.exit(1)


if __name__ == "__main__":
    main()
