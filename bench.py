"""Benchmark: reads/s per GPU of the align+call device step vs the C++ CPU core.

Needs an NVIDIA GPU and fails without one. Prints the device (platform,
device_kind, count, and the card's name and power limit from nvidia-smi) on
stderr and ONE JSON line on stdout:
  {"metric": "reads_per_s_per_chip", "value": N, "unit": "reads/s",
   "vs_baseline": N / cpu_reads_per_s, "device": {...}}

The CPU baseline is the native single-core C++ implementation of the same
banded Viterbi + local rescoring (csrc/banded_dp.cpp) — the reference tool
publishes no numbers and is unavailable in this sandbox (BASELINE.md), so the
equivalent-workload C++ engine is the measured denominator, as BASELINE.md
prescribes. Workload ≈ BASELINE.json config 2: a 1k-read batch, fixed band,
single chip.
"""

import json
import os
import sys
import time

import numpy as np

BATCH_READS = 512     # reads per device batch
N_BATCHES = 4         # pipelined batches in the timed loop
READ_LEN = 1000       # bases
CPU_SAMPLE = 6        # reads timed on the CPU core
# distinct simulated reads in the workload (default: every batch row is a
# unique read; BENCH_PROTO_READS=32 reuses 32 of them across the batch)
N_PROTO = int(os.environ.get("BENCH_PROTO_READS", str(BATCH_READS)))


def build_workload(seed=0):
    from nadavca_tpu.config import AlignConfig
    from nadavca_tpu.genome import kmer_ids
    from nadavca_tpu.io.simulator import random_genome, simulate_read
    from nadavca_tpu.kmer_model import default_model
    from nadavca_tpu.sched import build_chunked_bands

    cfg = AlignConfig()
    rng = np.random.default_rng(seed)
    model = default_model()
    genome = random_genome(rng, length=5000)
    protos = [
        simulate_read(genome, "ref", model, rng, read_len=READ_LEN, strand=1,
                      mean_dwell=10.0)
        for _ in range(N_PROTO)
    ]
    R = BATCH_READS
    T = ((max(len(p.signal) for p in protos) + cfg.signal_chunk - 1)
         // cfg.signal_chunk * cfg.signal_chunk)
    L = max(len(p.window_codes) for p in protos)
    N = L - model.k + 1
    x = np.zeros((R, T), np.float32)
    t_len = np.zeros(R, np.int32)
    mu = np.zeros((R, N), np.float32)
    sigma = np.ones((R, N), np.float32)
    n_ref = np.zeros(R, np.int32)
    anchors = np.zeros((R, T), np.float64)
    codes = np.full((R, L), 4, np.int32)
    ids = np.full((R, N), -1, np.int32)
    for r in range(R):
        p = protos[r % len(protos)]
        t = len(p.signal)
        x[r, :t] = p.signal
        t_len[r] = t
        m, s = model.expected_signal(p.window_codes)
        mu[r, : len(m)] = m
        sigma[r, : len(m)] = s
        n_ref[r] = len(m)
        anchors[r, :t] = p.true_path
        anchors[r, t:] = p.true_path[-1]
        codes[r, : len(p.window_codes)] = p.window_codes
        ids[r, : len(m)] = kmer_ids(p.window_codes, model.k)
    bands = build_chunked_bands(anchors, t_len, n_ref, cfg.band_width,
                                cfg.signal_chunk)
    return cfg, model, protos, dict(
        x=x, t_len=t_len, mu=mu, sigma=sigma, n_ref=n_ref,
        lo=bands.lo, delta=bands.delta, codes=codes, ids=ids,
    ), genome


def device_info() -> dict:
    """Platform, kind and count as JAX reports them, plus the card's name
    and power limit from nvidia-smi; raises without a GPU."""
    import subprocess

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {devs[0].platform!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "nvidia_smi": smi.stdout.strip()}


def bench_device(cfg, model, w):
    """The CLI's jitted device step (pipeline._device_step) on one batch."""
    import jax.numpy as jnp

    from nadavca_tpu.pipeline import _device_step, resolve_backend

    backend = resolve_backend(cfg, "auto", model.k)
    lm = jnp.asarray(model.level_mean)
    ls = jnp.asarray(model.level_std)
    args = tuple(jnp.asarray(w[k]) for k in
                 ("x", "t_len", "mu", "sigma", "n_ref", "lo", "delta",
                  "codes", "ids")) + (lm, ls)

    def step():
        return _device_step(*args, cfg=cfg, backend=backend, k=model.k)

    step()[2].block_until_ready()  # compile
    best_dt = float("inf")
    for _ in range(3):
        t0 = time.time()
        outs = [step() for _ in range(N_BATCHES)]
        outs[-1][2].block_until_ready()
        best_dt = min(best_dt, time.time() - t0)
    reads_per_s = BATCH_READS * N_BATCHES / best_dt
    cells = float(np.sum(w["t_len"], dtype=np.int64)) * cfg.band_width * N_BATCHES
    return reads_per_s, cells / best_dt, backend


def bench_host_stream(cfg, model, protos, genome):
    """Host ingest+prep streaming rate (reads/s) on THIS host.

    The streamed CLI overlaps ingest/prep with device compute, so its
    steady end-to-end rate is ~min(host stream rate, device rate). This
    measures the host side for the JSON line (fast5 read + native prep per
    read); the 2-CPU sandbox is host-bound, a many-core production host is
    not (BASELINE.md 2026-08-21 row).
    """
    import os
    import tempfile

    from nadavca_tpu.io import fast5 as fast5mod
    from nadavca_tpu.pipeline import make_preprocessor

    import dataclasses

    uniq = [dataclasses.replace(p, read_id=f"bench{i:04d}")
            for i, p in enumerate(protos * 2)]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "r.fast5")
        fast5mod.write_fast5(path, uniq)
        work = make_preprocessor(genome, cfg, model=model)
        raws = fast5mod.read_fast5(path)
        for r in raws[:4]:
            work(r)  # warm the native engine
        t0 = time.time()
        raws = fast5mod.read_fast5(path)
        n = 0
        for r in raws:
            work(r)
            n += 1
        dt = time.time() - t0
    return n / dt if dt > 0 else float("nan")


def bench_cpu(cfg, model, protos, w):
    from nadavca_tpu.ops import cpu_ref

    times = []
    for i in range(CPU_SAMPLE):
        p = protos[i % len(protos)]
        mu, sigma = model.expected_signal(p.window_codes)
        lo = w["lo"][i % w["lo"].shape[0]]
        lo_full = np.repeat(lo, cfg.signal_chunk)[: len(p.signal)].astype(np.int32)
        lo_full = np.minimum(lo_full, max(len(mu) - cfg.band_width, 0))
        t0 = time.time()
        _, path = cpu_ref.banded_viterbi_cpu(
            p.signal.astype(np.float32), mu, sigma, lo_full, cfg.band_width,
            cfg.log_p_stay, cfg.log_p_move,
        )
        cpu_ref.base_loglik_local_cpu(
            p.signal.astype(np.float32), p.window_codes.astype(np.int32),
            path.astype(np.int32), model.level_mean, model.level_std,
            model.k, cfg.log_p_stay, cfg.log_p_move, cfg.snp_local_window,
        )
        times.append(time.time() - t0)
    per_read = float(np.median(times))
    return 1.0 / per_read


def main():
    from nadavca_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    device = device_info()
    print(f"[bench] device {device}", file=sys.stderr)
    cfg, model, protos, w, genome = build_workload()
    try:
        cpu_rps = bench_cpu(cfg, model, protos, w)
    except Exception as e:  # no toolchain: no baseline
        print(f"[bench] cpu baseline failed: {e}", file=sys.stderr)
        cpu_rps = float("nan")
    dev_rps, cells_per_s, backend = bench_device(cfg, model, w)
    try:
        host_rps = bench_host_stream(cfg, model, protos, genome)
    except Exception as e:
        print(f"[bench] host stream failed: {e}", file=sys.stderr)
        host_rps = float("nan")
    vs = dev_rps / cpu_rps if cpu_rps == cpu_rps else None
    # steady end-to-end bound of the streamed CLI: host feed and device
    # compute overlap, so the slower side is the pipeline rate
    e2e = min(dev_rps, host_rps) if host_rps == host_rps else None
    print(
        f"[bench] backend={backend} device={dev_rps:.1f} reads/s "
        f"({cells_per_s/1e9:.1f} Gcells/s incl. rescore) cpu={cpu_rps:.2f} "
        f"reads/s host_stream={host_rps:.0f} reads/s",
        file=sys.stderr,
    )
    print(json.dumps({
        "metric": "reads_per_s_per_chip",
        "value": dev_rps,
        "unit": "reads/s",
        "vs_baseline": vs,
        "host_stream_reads_per_s": host_rps if host_rps == host_rps else None,
        "e2e_steady_bound_reads_per_s": e2e,
        "device": device,
    }))


if __name__ == "__main__":
    main()
