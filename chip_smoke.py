#!/usr/bin/env python3
"""Smoke run of the device path on an NVIDIA GPU, through the CLI.

    python chip_smoke.py              # one card
    python chip_smoke.py --devices 4  # four cards of one host

One card, in one process: (1) the device, with the card's name and power
limit; (2) the environment (h5py, yaml, g++, nvcc, prep engine, compile
cache); (3) the CUDA kernels against the lax.scan backend, the float64
oracle and the XLA rescore at real widths, then the ``gpu``-marked tests in
a child process; (4) ``nadavca-tpu snp`` on a 4.6 Mb reference with 2,000
simulated reads (80% ~1,000 bases, 20% ~2,500 bases, so both band widths
run) and 30 planted SNPs, checked against the truth and against
``--backend scan``, then ``align`` on 250 reads against the scan route.

Four cards: the 1-card ``snp``, ``snp --devices 4`` and four processes x one
card joined by ``--coordinator`` on the same data, each in a child process
(this process stays off JAX); the three call sets must be equal.

Every line but the last is progress. The last line is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``,
printed only when every phase passed; any failure exits non-zero without it.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

GENOME_LEN = 4_600_000       # E. coli-sized single contig
REGION_LEN = 80_000          # reads pile up here: ~2.6 Mb of bases, ~32x
N_READS = 2000
LONG_SHARE = 0.2             # reads of ~2,500 bases (> 16,384 samples: B=256)
SHORT_LEN, LONG_LEN = 1000, 2500
N_SNPS = 30
READS_PER_FILE = 250
RECALL_FLOOR = 0.8
PRECISION_FLOOR = 0.8
# kernel vs scan: the fill renormalizes once per 128-sample chunk where the
# scan renormalizes every sample, and nvcc and XLA contract multiply-adds
# differently, so scores differ by float32 rounding and near-tied decisions
# can flip; a flip moves a short run of samples by one position
SCORE_RTOL, SCORE_ATOL = 2e-5, 0.1
PATH_AGREE_MIN = 0.999       # share of live samples on the same position
READ_AGREE_MIN = 0.99        # the same, for every single read
# second witness for those flips: on the reads that agree least, the f64
# oracle prices the kernel's path; a near-tied flip gives up no more
# likelihood than float32 rounding over a read (|dscore| ~0.005 at
# T=26k), while a wrong decision gives up its whole margin
TIE_TOL = 0.05
RESCORE_RTOL, RESCORE_ATOL = 1e-4, 2e-2
QUAL_TOL = 1.0               # printed, not asserted: f32 atomics in the scatter


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, what) -> None:
    """A failed check fails the phase (and the run), also under -O."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi() -> list:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


# ------------------------------------------------------------------ data
def simulate_dataset(seed: int, genome_len=GENOME_LEN, region_len=REGION_LEN,
                     n_reads=N_READS, n_snps=N_SNPS, long_share=LONG_SHARE,
                     short_len=SHORT_LEN, long_len=LONG_LEN):
    """Reference, reads and truth, generated from ``seed`` in bulk.

    The sample genome is random; the reference is the sample with
    ``n_snps`` substitutions planted in the covered region (>= 20 bases
    apart). Reads are simulated from the sample (simulator squiggles, 2%
    basecall substitutions, a basecaller-style move table). Returns
    (reference Genome, list of SimulatedRead, truth {pos0: sample base}).
    """
    from nadavca_tpu.genome import Contig, Genome, decode_bases
    from nadavca_tpu.io.simulator import (SimulatedRead, add_basecall_errors,
                                          simulate_squiggle)
    from nadavca_tpu.kmer_model import default_model

    rng = np.random.default_rng(seed)
    model = default_model()
    sample = rng.integers(0, 4, size=genome_len).astype(np.int8)
    lo = int(rng.integers(0, genome_len - region_len))
    hi = lo + region_len
    margin = min(3000, region_len // 4)
    cand = np.arange(lo + margin, hi - margin, 20)
    pos = np.sort(rng.choice(cand, size=n_snps, replace=False))
    pos = pos + rng.integers(0, 10, size=n_snps)
    ref = sample.copy()
    ref[pos] = (sample[pos] + rng.integers(1, 4, size=n_snps)) % 4
    truth = {int(p): int(sample[p]) for p in pos}

    sample_genome = Genome([Contig("chr", sample)])
    reads = []
    for i in range(n_reads):
        length = long_len if rng.random() < long_share else short_len
        length += int(rng.integers(-10, 11))
        start = int(rng.integers(lo, hi - length))
        strand = 1 if rng.random() < 0.5 else -1
        window = sample_genome.window("chr", start, start + length, strand)
        signal, path = simulate_squiggle(window, model, rng, mean_dwell=10.0)
        n_kmer = len(window) - model.k + 1
        first_t = np.searchsorted(path, np.arange(n_kmer), side="left")
        move = np.concatenate(
            [first_t, np.full(len(window) - n_kmer, first_t[-1])])
        reads.append(SimulatedRead(
            read_id=f"r{i:05d}", signal=signal, true_path=path,
            window_codes=window, contig="chr", ref_start=start,
            ref_end=start + length, strand=strand,
            basecall=decode_bases(add_basecall_errors(window, rng)),
            move_index=move.astype(np.int64)))
    return Genome([Contig("chr", ref)]), reads, truth


def write_dataset(root: str, genome, reads, use_fast5: bool) -> str:
    """Reference FASTA + reads in files of READS_PER_FILE under ``root``.

    Without h5py the files, still named ``.fast5`` so the CLI lists, orders
    and shards them itself, hold pickled RawReads (see install_memory_reads)."""
    from nadavca_tpu.io import fast5 as fast5mod

    data = os.path.join(root, "reads")
    os.makedirs(data, exist_ok=True)
    genome.to_fasta(os.path.join(root, "reference.fasta"))
    for fi in range(0, len(reads), READS_PER_FILE):
        chunk = reads[fi:fi + READS_PER_FILE]
        name = os.path.join(data, f"reads_{fi // READS_PER_FILE:03d}.fast5")
        if use_fast5:
            fast5mod.write_fast5(name, chunk)
        else:
            with open(name, "wb") as f:
                pickle.dump([fast5mod.RawRead(
                    r.read_id, (80.0 + 12.0 * r.signal).astype(np.float32),
                    r.basecall, r.move_index) for r in chunk], f)
    return data


def have_h5py() -> bool:
    try:
        import h5py  # noqa: F401
    except ImportError:
        return False
    return True


def install_memory_reads() -> None:
    """For hosts without h5py: swap only the per-file decoder the CLI calls
    (fast5.read_fast5) for a loader of write_dataset's pickles, with the
    decoder's id filters; listing and sharding stay in cli._iter_raw_reads."""
    from nadavca_tpu.io import fast5 as fast5mod

    def read_pickled(path, skip_ids=None, skipped=None, include_ids=None):
        with open(path, "rb") as f:
            raws = pickle.load(f)
        out = []
        for raw in raws:
            if include_ids is not None and raw.read_id not in include_ids:
                continue
            if skip_ids and raw.read_id in skip_ids:
                if skipped is not None:
                    skipped[0] += 1
                continue
            out.append(raw)
        return out

    fast5mod.read_fast5 = read_pickled


def read_vcf(path: str):
    """{(pos0, ref, alt): qual} of a VCF written by the snp command."""
    calls = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            c = line.split("\t")
            calls[(int(c[1]) - 1, c[3], c[4])] = float(c[5])
    return calls


def score_calls(calls, truth):
    """(recall, precision, tp, fp, fn) of a call set against the truth."""
    called = {(p, alt) for p, _, alt in calls}
    want = {(p, "ACGT"[b]) for p, b in truth.items()}
    tp = len(called & want)
    fp = len(called - want)
    fn = len(want - called)
    return tp / max(1, tp + fn), tp / max(1, tp + fp), tp, fp, fn


def read_alignments(directory: str) -> dict:
    """{read_id: path array} rebuilt from the align command's outputs."""
    out = {}
    for fn in os.listdir(directory):
        rows = np.loadtxt(os.path.join(directory, fn), dtype=np.int64,
                          comments="#", ndmin=2)
        path = np.full(int(rows[:, 2].max()), -1, np.int64)
        for i, s, e in rows:
            path[s:e] = i
        out[fn[:-4]] = path
    return out


def run_cli(argv) -> dict:
    """nadavca_tpu.cli.main in this process; returns its metrics."""
    from nadavca_tpu import cli

    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    text = err.getvalue()
    if rc != 0:
        raise RuntimeError(f"cli {argv[0]} exited {rc}:\n{text}")
    stats = {}
    for line in text.splitlines():
        if line.startswith("[metrics] "):
            snap = json.loads(line[len("[metrics] "):])
            stats = {**snap["counters"], **snap["gauges"]}
    stats["wall_s"] = wall
    return stats


# ---------------------------------------------------------------- phases
def phase_device(expect: int) -> dict:
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {devs[0].platform!r}")
    if len(devs) < expect:
        raise SystemExit(f"need {expect} GPUs, JAX found {len(devs)}")
    info = {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
    log(f"[device] {info}")
    return info


def phase_environment() -> bool:
    from nadavca_tpu.genome import Contig, Genome
    from nadavca_tpu.config import AlignConfig
    from nadavca_tpu.ops import cuda_dp
    from nadavca_tpu.pipeline import make_preprocessor
    from nadavca_tpu.utils.cache import compile_cache_dir
    from nadavca_tpu.utils.native_build import nvcc_path

    have = {}
    for mod in ("h5py", "yaml"):
        try:
            __import__(mod)
            have[mod] = True
        except ImportError:
            have[mod] = False
    log(f"[env] imports: {have}")
    log(f"[env] g++={shutil.which('g++')} nvcc={nvcc_path()}")
    tiny = Genome([Contig("chr", np.zeros(64, np.int8))])
    log(f"[env] prep engine: {make_preprocessor(tiny, AlignConfig()).engine}")
    log(f"[env] compile cache: {compile_cache_dir()}")
    t0 = time.perf_counter()
    lib = cuda_dp.build_library()
    log(f"[env] CUDA library {os.path.basename(lib)} ready in "
        f"{time.perf_counter() - t0:.1f} s")
    if not have["h5py"]:
        log("[env] h5py missing: cli._iter_raw_reads lists the read files "
            "but a pickle loader stands in for the fast5 decoder; fast5 "
            "decoding is not exercised")
    return have["h5py"]


def synthetic_batch(seed: int, R: int, read_len: int, band_width: int,
                    skip_prob: float = 0.0):
    """A padded (R, T) batch of simulated reads, bands from the true path."""
    import jax.numpy as jnp

    from nadavca_tpu.genome import Contig, Genome, kmer_ids
    from nadavca_tpu.io.simulator import simulate_squiggle
    from nadavca_tpu.kmer_model import default_model
    from nadavca_tpu.sched import build_chunked_bands

    rng = np.random.default_rng(seed)
    model = default_model()
    genome = Genome([Contig("chr", rng.integers(0, 4, 200_000).astype(np.int8))])
    sims = []
    for _ in range(R):
        start = int(rng.integers(0, 200_000 - read_len))
        w = genome.window("chr", start, start + read_len, 1)
        sig, path = simulate_squiggle(w, model, rng, mean_dwell=10.0,
                                      skip_prob=skip_prob)
        sims.append((w, sig, path))
    T = 128 * -(-max(len(s) for _, s, _ in sims) // 128)
    L = 256 * -(-read_len // 256)
    N = L - model.k + 1
    b = dict(x=np.zeros((R, T), np.float32), t_len=np.zeros(R, np.int32),
             mu=np.zeros((R, N), np.float32), sigma=np.ones((R, N), np.float32),
             n_ref=np.zeros(R, np.int32), codes=np.full((R, L), 4, np.int32),
             ids=np.full((R, N), -1, np.int32))
    anchors = np.zeros((R, T))
    for r, (w, sig, path) in enumerate(sims):
        t = len(sig)
        m, s = model.expected_signal(w)
        b["x"][r, :t] = sig
        b["t_len"][r] = t
        b["mu"][r, :len(m)] = m
        b["sigma"][r, :len(m)] = s
        b["n_ref"][r] = len(m)
        b["codes"][r, :len(w)] = w
        b["ids"][r, :len(m)] = kmer_ids(w, model.k)
        anchors[r, :t] = path
        anchors[r, t:] = path[-1]
    bands = build_chunked_bands(anchors, b["t_len"], b["n_ref"], band_width,
                                128)
    b["lo"], b["delta"] = bands.lo, bands.delta
    out = {k: jnp.asarray(v) for k, v in b.items()}
    out["lo_full"] = jnp.asarray(bands.expand(T))
    return out, model, sims


def phase_kernels(seed: int) -> None:
    import dataclasses

    import jax
    import jax.numpy as jnp

    from nadavca_tpu.config import AlignConfig
    from nadavca_tpu.ops import banded_dp, cuda_dp, dp_spec

    for band_width, read_len, skip in ((128, SHORT_LEN, False),
                                       (256, LONG_LEN, False),
                                       (128, SHORT_LEN, True)):
        cfg = dataclasses.replace(
            AlignConfig(), band_width=band_width, use_skip=skip,
            log_p_skip=-4.6 if skip else AlignConfig().log_p_skip)
        b, model, sims = synthetic_batch(seed, 512, read_len, band_width,
                                         skip_prob=0.05 if skip else 0.0)
        R, T = b["x"].shape
        tag = (f"[kernels B={band_width} R={R} T={T} L={b['codes'].shape[1]}"
               f"{' skip' if skip else ''}]")
        chunked = [b[k] for k in ("x", "t_len", "mu", "sigma", "n_ref", "lo",
                                  "delta")]
        t0 = time.perf_counter()
        cu = jax.jit(lambda *a: cuda_dp.cuda_viterbi_batch(*a, cfg))(*chunked)
        cu.path.block_until_ready()
        log(f"{tag} fill+backtrack compiled and ran in "
            f"{time.perf_counter() - t0:.1f} s")
        sc = banded_dp.banded_viterbi_batch(
            b["x"], b["t_len"], b["mu"], b["sigma"], b["n_ref"],
            b["lo_full"], cfg)
        s_cu, s_sc = np.asarray(cu.score), np.asarray(sc.score)
        p_cu, p_sc = np.asarray(cu.path), np.asarray(sc.path)
        live = np.arange(T)[None, :] < np.asarray(b["t_len"])[:, None]
        agree = float((p_cu == p_sc)[live].mean())
        per_read = np.array([(p_cu[r] == p_sc[r])[live[r]].mean()
                             for r in range(R)])
        dscore = np.abs(s_cu - s_sc)
        log(f"{tag} kernel vs scan: max |dscore| {dscore.max():.4g} "
            f"(tol {SCORE_ATOL} + {SCORE_RTOL}*|score|), path agreement "
            f"{agree:.6f} (min {PATH_AGREE_MIN}); worst read "
            f"{per_read.min():.6f} (min {READ_AGREE_MIN}); "
            f"{int((per_read < 1).sum())} of {R} reads differ")
        np.testing.assert_allclose(s_cu, s_sc, rtol=SCORE_RTOL, atol=SCORE_ATOL)
        check(agree >= PATH_AGREE_MIN, agree)
        check(per_read.min() >= READ_AGREE_MIN, per_read.min())
        if skip:  # non-vacuous: the paths really skip positions
            check((np.diff(p_sc, axis=1)[live[:, 1:]] == 2).any(), "skips")

        # the CUDA walk vs the plain-JAX walk of the same kernel bits
        def both(*a):
            bits, bits2, _, _ = cuda_dp.ffi_fill(*a, cfg)
            res = cuda_dp.cuda_viterbi_batch(*a, cfg)
            return res.path, cuda_dp.reference_backtrack(
                bits, bits2, a[5], a[6], res.final_j, a[1])

        p_k, p_r = jax.jit(both)(*chunked)
        check(np.array_equal(np.asarray(p_k), np.asarray(p_r)),
              "CUDA backtrack == plain-JAX walk")
        log(f"{tag} CUDA backtrack == plain-JAX walk of the kernel's bits")

        # the float64 oracle on the first reads and on the three that agree
        # least with the scan: the kernel's path must be optimal in f64 up
        # to TIE_TOL, so that any flip is a near-tie, not a fault
        lo_full = np.asarray(b["lo_full"])
        x64 = np.asarray(b["x"]).astype(np.float64)
        mu64 = np.asarray(b["mu"]).astype(np.float64)
        sg64 = np.asarray(b["sigma"]).astype(np.float64)
        worst = [int(r) for r in np.argsort(per_read, kind="stable")[:3]]
        for r in sorted({0, 1, 2, *worst}):
            t, n = int(b["t_len"][r]), int(b["n_ref"][r])
            args64 = (x64[r, :t], mu64[r, :n], sg64[r, :n],
                      lo_full[r, :t].astype(np.int64))
            score, path = dp_spec.banded_viterbi(*args64, cfg)
            gap_cu = score - dp_spec.path_score(*args64, p_cu[r, :t], cfg)
            gap_sc = score - dp_spec.path_score(*args64, p_sc[r, :t], cfg)
            a = float(np.mean(p_cu[r, :t] == path))
            log(f"{tag} read {r} vs f64 oracle: agreement with scan "
                f"{per_read[r]:.6f}, with oracle {a:.6f}; score "
                f"{s_cu[r]:.3f} vs {score:.3f}; f64 likelihood given up by "
                f"the kernel's path {gap_cu:.3g}, by the scan's {gap_sc:.3g} "
                f"(max {TIE_TOL})")
            check(a >= READ_AGREE_MIN and gap_cu <= TIE_TOL and np.isclose(
                s_cu[r], score, rtol=1e-4, atol=0.05),
                (r, a, gap_cu, s_cu[r], score))

        # rescore kernel vs XLA on the kernel's path
        args = (b["x"], cu.path, b["t_len"], b["codes"], b["ids"],
                jnp.asarray(model.level_mean), jnp.asarray(model.level_std))
        ll_cu = np.asarray(jax.jit(lambda *a: cuda_dp.cuda_local_rescore(
            *a, model.k, cfg, t_w=cfg.snp_local_window))(*args))
        ll_x = np.asarray(banded_dp.base_loglik_local_batch(
            *args, model.k, cfg, t_w=cfg.snp_local_window))
        d = np.abs(ll_cu - ll_x)
        log(f"{tag} rescore kernel vs XLA: max |d| {d.max():.4g} "
            f"(tol {RESCORE_ATOL} + {RESCORE_RTOL}*|ll|; summation order "
            f"and FMA contraction)")
        np.testing.assert_allclose(ll_cu, ll_x, rtol=RESCORE_RTOL,
                                   atol=RESCORE_ATOL)


def phase_gpu_tests() -> None:
    env = dict(os.environ, NADAVCA_TEST_PLATFORM="gpu",
               XLA_PYTHON_CLIENT_MEM_FRACTION="0.25")
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-m", "gpu", "-q",
         "-p", "no:cacheprovider", "tests/test_cuda_dp.py"],
        cwd=REPO, env=env, capture_output=True, text=True)
    tail = (r.stdout.strip().splitlines() or ["(no output)"])[-1]
    log(f"[gpu tests] {tail}")
    if r.returncode != 0 or " passed" not in tail or "skipped" in tail:
        raise RuntimeError(f"gpu-marked tests failed:\n{r.stdout[-6000:]}"
                           f"\n{r.stderr[-3000:]}")


def phase_main_path(root: str, data: str, truth: dict, smi: list) -> None:
    ref = os.path.join(root, "reference.fasta")
    runs = {}
    for name, extra in (("cuda", []), ("scan", ["--backend", "scan"]),
                        ("cuda-again", [])):
        vcf = os.path.join(root, f"{name}.vcf")
        g = run_cli(["snp", ref, data, "-o", vcf, "--batch-reads", "256"]
                    + extra)
        runs[name] = (vcf, g)
        log(f"[snp {name}] {g.get('reads_called')} reads, wall {g['wall_s']:.1f} s,"
            f" reads_per_s_e2e {g.get('reads_per_s_e2e')}, reads_per_s_steady "
            f"{g.get('reads_per_s_steady')} on {smi[0]} (informational)")
    calls = {k: read_vcf(v[0]) for k, v in runs.items()}
    recall, precision, tp, fp, fn = score_calls(calls["cuda"], truth)
    log(f"[snp cuda] {len(calls['cuda'])} calls: recall {recall:.3f} "
        f"(floor {RECALL_FLOOR}), precision {precision:.3f} "
        f"(floor {PRECISION_FLOOR}); tp {tp} fp {fp} fn {fn}")
    check(recall >= RECALL_FLOOR and precision >= PRECISION_FLOOR,
          (recall, precision))
    same = set(calls["cuda"]) == set(calls["scan"])
    dq = max([abs(calls["cuda"][c] - calls["scan"][c])
              for c in set(calls["cuda"]) & set(calls["scan"])] or [0.0])
    log(f"[snp cuda vs scan] call sets equal: {same}; max |dQUAL| {dq:.3f} "
        f"(tolerance {QUAL_TOL})")
    check(same, sorted(set(calls["cuda"]) ^ set(calls["scan"])))
    with open(runs["cuda"][0], "rb") as a, open(runs["cuda-again"][0], "rb") as b:
        log(f"[snp repeat] VCF bytes identical: {a.read() == b.read()} "
            "(not asserted: f32 scatter-add order on the GPU)")

    # align on the first file's reads, kernel route vs scan route
    sub = os.path.join(root, "align_in")
    os.makedirs(sub, exist_ok=True)
    first = sorted(os.listdir(data))[0]
    shutil.copy(os.path.join(data, first), sub)
    paths = {}
    for name, extra in (("cuda", []), ("scan", ["--backend", "scan"])):
        out = os.path.join(root, f"align_{name}")
        g = run_cli(["align", ref, sub, "-o", out, "--batch-reads", "256"]
                    + extra)
        paths[name] = read_alignments(out)
        log(f"[align {name}] {len(paths[name])} reads, wall {g['wall_s']:.1f} s")
    check(set(paths["cuda"]) == set(paths["scan"]), "same aligned reads")
    eq = tot = 0
    for rid, p in paths["cuda"].items():
        q = paths["scan"][rid]
        n = min(len(p), len(q))
        eq += int(np.sum(p[:n] == q[:n]))
        tot += max(len(p), len(q))
    log(f"[align cuda vs scan] {len(paths['cuda'])} reads, sample agreement "
        f"{eq / tot:.6f} (min {PATH_AGREE_MIN})")
    check(eq / tot >= PATH_AGREE_MIN, eq / tot)


# ------------------------------------------------------------ four cards
def child_cli(argv) -> int:
    """Run the CLI in this (child) process; report its devices first."""
    if not have_h5py():
        install_memory_reads()
    with contextlib.redirect_stdout(sys.stderr):
        rc = __import__("nadavca_tpu.cli", fromlist=["main"]).main(argv)
    import jax

    d = jax.devices()
    log("CHILD_DEVICE " + json.dumps({"platform": d[0].platform,
                                      "kind": d[0].device_kind,
                                      "count": len(d),
                                      "local": len(jax.local_devices())}))
    return rc


def _children(root: str, argvs, env=None):
    """Start one child per argv; its stdout/stderr go to files in ``root``
    (a full pipe would block a child that logs a lot)."""
    procs = []
    for argv in argvs:
        n = len(os.listdir(root))
        out = open(os.path.join(root, f"child{n}.out"), "w+")
        err = open(os.path.join(root, f"child{n}.err"), "w+")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child", "--",
             *argv], cwd=REPO, env=env, stdout=out, stderr=err), out, err))
    return procs


def _finish(procs, what, timeout=900):
    """Wait for every child; when one fails or time runs out, stop the rest
    (a group member left waiting in a collective would never exit)."""
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p, _, _ in procs):
            failed = [p for p, _, _ in procs if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p, _, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    devices = []
    for p, out, err in procs:
        out.seek(0)
        err.seek(0)
        text, errs = out.read(), err.read()
        out.close()
        err.close()
        if p.returncode != 0:
            raise RuntimeError(f"{what} failed ({p.returncode}):\n"
                               f"{text[-3000:]}\n{errs[-6000:]}")
        devices += [json.loads(l.split(" ", 1)[1]) for l in text.splitlines()
                    if l.startswith("CHILD_DEVICE ")]
    return devices


def phase_four_cards(root: str, data: str, truth: dict) -> dict:
    ref = os.path.join(root, "reference.fasta")
    base = ["snp", ref, data, "--batch-reads", "256"]
    vcf1, vcf4, vcfp = (os.path.join(root, n)
                        for n in ("one.vcf", "devices4.vcf", "procs4.vcf"))
    env1 = dict(os.environ, CUDA_VISIBLE_DEVICES="0")
    t0 = time.perf_counter()
    _finish(_children(root, [base + ["-o", vcf1]], env1), "1-card snp")
    log(f"[4 cards] 1-card snp done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dev4 = _finish(_children(root, [base + ["-o", vcf4, "--devices", "4"]]),
                   "snp --devices 4")
    log(f"[4 cards] snp --devices 4 done in {time.perf_counter() - t0:.1f} s "
        f"on {dev4}")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    devp = _finish(_children(root, [
        base + ["-o", vcfp, "--coordinator", f"localhost:{port}",
                "--num-processes", "4", "--process-id", str(i)]
        for i in range(4)]), "4-process snp")
    log(f"[4 cards] 4 processes x 1 card done in "
        f"{time.perf_counter() - t0:.1f} s on {devp}")
    one, four, procs = read_vcf(vcf1), read_vcf(vcf4), read_vcf(vcfp)
    recall, precision, *_ = score_calls(one, truth)
    log(f"[4 cards] 1-card: {len(one)} calls, recall {recall:.3f}, precision "
        f"{precision:.3f}; --devices 4: {len(four)} calls, equal "
        f"{set(four) == set(one)}; 4 processes: {len(procs)} calls, equal "
        f"{set(procs) == set(one)}")
    check(set(four) == set(one), sorted(set(four) ^ set(one)))
    check(set(procs) == set(one), sorted(set(procs) ^ set(one)))
    # one process per card: each sees one local device of the four
    check(all(d["local"] == 1 and d["count"] == 4 for d in devp
               if d["platform"] == "gpu"), devp)
    return {k: dev4[0][k] for k in ("platform", "kind", "count")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("cli_args", nargs="*", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    if args.child:
        return child_cli(args.cli_args)

    if args.devices == 1:
        # the device check comes first: a host without a GPU stops here
        os.environ.setdefault("XLA_PYTHON_CLIENT_MEM_FRACTION", "0.6")
        device = phase_device(1)
    smi = nvidia_smi()
    for line in smi:
        log(f"[nvidia-smi] {line}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        if args.devices == 4:
            # this process stays off JAX: every run is a child
            t0 = time.perf_counter()
            genome, reads, truth = simulate_dataset(args.seed)
            data = write_dataset(root, genome, reads, have_h5py())
            log(f"[data] {len(reads)} reads, {len(truth)} SNPs in "
                f"{time.perf_counter() - t0:.1f} s")
            device = phase_four_cards(root, data, truth)
        else:
            h5 = phase_environment()
            phase_kernels(args.seed)
            phase_gpu_tests()
            t0 = time.perf_counter()
            genome, reads, truth = simulate_dataset(args.seed)
            data = write_dataset(root, genome, reads, h5)
            if not h5:
                install_memory_reads()
            log(f"[data] {len(reads)} reads, {len(truth)} SNPs in "
                f"{time.perf_counter() - t0:.1f} s")
            phase_main_path(root, data, truth, smi)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
