"""Per-batch orchestration: reads → anchored, padded batches → device DP → SNPs.

This is the rebuild of the reference's L2 orchestration (SURVEY.md §3.1/§3.5):
host does ingest, normalization, anchoring, window/level precompute and batch
padding; ONE device_put ships the batch; the device runs banded Viterbi (CUDA
kernels on a GPU, lax.scan elsewhere), segment statistics, base-substitution
likelihoods and the genome scatter-add as one jitted program.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .anchor import Anchor, SeedIndex, anchor_basecall, signal_anchor_path
from .config import AlignConfig
from .genome import Genome, kmer_ids
from .kmer_model import KmerModel
from .ops import banded_dp, cuda_dp
from .sched.bands import ChunkedBands, build_chunked_bands

# read-axis granule: R rounds up to a multiple of it so partial batches of a
# bucket share executables (the kernels themselves take any R)
READ_GRANULE = 8


@dataclasses.dataclass
class ReadRecord:
    """A read after host-side preprocessing, ready for batching."""

    read_id: str
    signal: np.ndarray        # (T,) float32 normalized
    anchor: Anchor
    anchor_path: np.ndarray   # (T,) float64 window k-mer position per sample
    window_codes: np.ndarray  # (L,) int8
    # expected levels of the window, computed once during preprocessing and
    # reused by assemble_batch (profiling showed the duplicate
    # expected_signal call was ~15% of host prep)
    mu: Optional[np.ndarray] = None      # (N,) f32
    sigma: Optional[np.ndarray] = None   # (N,) f32


@dataclasses.dataclass
class Batch:
    """Padded device-ready batch plus host-side metadata."""

    x: np.ndarray             # (R, T) f32
    t_len: np.ndarray         # (R,) i32
    mu: np.ndarray            # (R, N) f32
    sigma: np.ndarray         # (R, N) f32
    n_ref: np.ndarray         # (R,) i32
    bands: ChunkedBands
    codes: np.ndarray         # (R, L) i32 window bases (4 = pad)
    ids: np.ndarray           # (R, N) i32 kmer ids (-1 = pad)
    window_start: np.ndarray  # (R,) i32 genome coord of window start
    window_len: np.ndarray    # (R,) i32 = L true bases
    strand: np.ndarray        # (R,) i32
    read_ids: List[str]
    contigs: List[str]        # contig per read (padded rows repeat the first)
    n_reads: int              # true (unpadded) read count

    @property
    def shapes(self):
        return (self.x.shape, self.mu.shape)


def preprocess_read(
    signal: np.ndarray,
    basecall: str,
    move_index: np.ndarray,
    index: SeedIndex,
    genome: Genome,
    read_id: str = "?",
    model: Optional[KmerModel] = None,
) -> Optional[ReadRecord]:
    """Anchor one normalized read; None if anchoring fails.

    When a pore model is given, the read is re-calibrated against it: a
    trimmed linear fit of the signal onto the expected levels along the
    anchor path refines the raw median/MAD normalization, whose shift is
    biased by the window's level composition (a read over a high-level
    region gets its whole signal shifted by the local level median — a
    systematic, cross-read-correlated error that fabricates confident SNPs).
    """
    a = anchor_basecall(index, basecall)
    if a is None:
        return None
    window = genome.window(a.contig, a.ref_start, a.ref_end, a.strand)
    path = signal_anchor_path(a, move_index, len(signal))
    signal = np.asarray(signal, np.float32)
    mu = sigma = None
    if model is not None:
        mu, sigma = model.expected_signal(window)
        if len(mu) > 1:
            ap = np.clip(np.round(path).astype(np.int64), 0, len(mu) - 1)
            pred = mu[ap].astype(np.float64)
            x = signal.astype(np.float64)
            keep = np.ones(len(x), bool)
            for _ in range(2):  # fit, trim outliers, refit
                vp = pred[keep].var()
                if vp < 1e-6 or keep.sum() < 16:
                    break
                aa = np.cov(pred[keep], x[keep])[0, 1] / vp
                bb = x[keep].mean() - aa * pred[keep].mean()
                resid = x - (aa * pred + bb)
                rs = resid[keep].std()
                # accept only a sane, well-correlated fit — a decorrelated
                # anchor (bad basecall / misanchor) would otherwise drive the
                # slope toward 0 and exploding 1/a scale corrections
                r2 = 1.0 - (resid[keep] ** 2).mean() / max(x[keep].var(), 1e-9)
                if 0.5 < aa < 2.0 and r2 > 0.5:
                    signal = ((x - bb) / aa).astype(np.float32)
                keep = np.abs(resid) < 3.0 * rs
    return ReadRecord(
        read_id=read_id,
        signal=signal,
        anchor=a,
        anchor_path=path,
        window_codes=window,
        mu=mu,
        sigma=sigma,
    )


def make_preprocessor(
    genome: Genome,
    cfg: AlignConfig,
    model: Optional[KmerModel] = None,
    mode: str = "auto",
):
    """Callable(raw_read) -> Optional[ReadRecord], native C++ or Python.

    mode: "auto" (native when the toolchain builds, else Python), "native",
    "python". The callable's ``engine`` attribute names the engine that was
    picked ("native" or "python"), since "auto" falls back silently. The
    native engine (csrc/prep.cpp) is ~3x faster per core and
    releases the GIL, so the CLI's thread workers scale with it.
    """
    from .io import fast5 as fast5mod

    if mode not in ("auto", "native", "python"):
        raise ValueError(f"unknown prep mode {mode!r}")
    if mode != "python":
        try:
            from . import prep_native

            native = prep_native.NativePrep(genome)

            def work_native(raw):
                if raw.basecall is None or raw.move_index is None:
                    return None
                return native.prep_read(
                    raw.signal_pa, raw.basecall, raw.move_index, cfg,
                    model=model, read_id=raw.read_id,
                )

            work_native.engine = "native"
            return work_native
        except Exception:
            if mode == "native":
                raise

    index = SeedIndex(genome)

    def work_python(raw):
        if raw.basecall is None or raw.move_index is None:
            return None
        sig = fast5mod.normalize_signal(raw.signal_pa, cfg.normalization)
        return preprocess_read(sig, raw.basecall, raw.move_index, index,
                               genome, raw.read_id, model=model)

    work_python.engine = "python"
    return work_python


def _round_up(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


def _bucket(v: int, edges) -> int:
    for e in edges:
        if v <= e:
            return e
    return _round_up(v, edges[-1] if edges else 1024)


def assemble_batch(
    records: Sequence[ReadRecord],
    model: KmerModel,
    cfg: AlignConfig,
    pad_reads_to: Optional[int] = None,
    pad_signal_to: Optional[int] = None,
    pad_window_to: Optional[int] = None,
) -> Batch:
    """Pad preprocessed reads into one device batch.

    Shapes are canonicalized — R rounds up to READ_GRANULE, T to the signal
    bucket edges, L to a 256 multiple — so repeated batches hit the same
    compiled executable (SURVEY.md §7.3 item 3: bucketed padding for shape
    stability). Multi-host callers pass pad_signal_to/pad_window_to (agreed
    across processes) so every process compiles the identical program; an
    empty ``records`` yields an all-padding batch (n_reads=0) for processes
    that run out of local reads before the globally-agreed batch count.
    """
    n = len(records)
    R = pad_reads_to or _round_up(max(n, 1), READ_GRANULE)
    assert R >= n, (R, n)
    T_raw = max([len(r.signal) for r in records] + [pad_signal_to or 1])
    T = _round_up(_bucket(T_raw, cfg.bucket_edges), cfg.signal_chunk)
    L_raw = max([len(r.window_codes) for r in records]
                + [pad_window_to or (model.k + 1)])
    L = _round_up(L_raw, 256)
    N = L - model.k + 1

    x = np.zeros((R, T), np.float32)
    t_len = np.zeros(R, np.int32)
    mu = np.zeros((R, N), np.float32)
    sigma = np.ones((R, N), np.float32)
    n_ref = np.zeros(R, np.int32)
    anchors = np.zeros((R, T), np.float64)
    codes = np.full((R, L), 4, np.int32)
    ids = np.full((R, N), -1, np.int32)
    wstart = np.zeros(R, np.int32)
    wlen = np.zeros(R, np.int32)
    strand = np.ones(R, np.int32)
    read_ids = []
    contigs = []

    for r, rec in enumerate(records):
        t = len(rec.signal)
        x[r, :t] = rec.signal
        t_len[r] = t
        if rec.mu is not None:
            m, s = rec.mu, rec.sigma
        else:
            m, s = model.expected_signal(rec.window_codes)
        mu[r, : len(m)] = m
        sigma[r, : len(m)] = s
        n_ref[r] = len(m)
        anchors[r, :t] = rec.anchor_path
        anchors[r, t:] = rec.anchor_path[-1] if t else 0
        lw = len(rec.window_codes)
        codes[r, :lw] = rec.window_codes
        ids[r, : len(m)] = kmer_ids(rec.window_codes, model.k)
        wstart[r] = rec.anchor.ref_start
        wlen[r] = lw
        strand[r] = rec.anchor.strand
        read_ids.append(rec.read_id)
        contigs.append(rec.anchor.contig)
    # padded rows: minimally alive so the DP is well-defined
    t_len[n:] = 1
    n_ref[n:] = 1

    contigs += [contigs[0] if contigs else ""] * (R - n)
    bands = build_chunked_bands(anchors, t_len, n_ref, cfg.band_width, cfg.signal_chunk)
    return Batch(
        x=x, t_len=t_len, mu=mu, sigma=sigma, n_ref=n_ref, bands=bands,
        codes=codes, ids=ids, window_start=wstart, window_len=wlen,
        strand=strand, read_ids=read_ids, contigs=contigs, n_reads=n,
    )


def device_backend() -> str:
    return jax.default_backend()


def path_to_segments(path: np.ndarray, t_len: int, n_ref: int):
    """Per-reference-position signal sample ranges from a Viterbi path.

    The path (window k-mer position per signal sample) is monotone
    nondecreasing, so each position's [start, end) range falls out of two
    bisections. Unvisited positions get (-1, -1). This is the reference's
    ``align`` output shape (SURVEY.md §2 "Output writers" row).
    """
    p = np.asarray(path[:t_len])
    pos = np.arange(n_ref)
    s = np.searchsorted(p, pos, side="left")
    e = np.searchsorted(p, pos, side="right")
    visited = e > s
    return np.where(visited, s, -1), np.where(visited, e, -1)


def device_compute(
    x, t_len, mu, sigma, n_ref, lo, delta, codes, ids, lm, ls,
    cfg: AlignConfig, backend: str, k: int,
):
    """The per-device compute body shared by EVERY execution path.

    Single-device (:func:`_device_step`) and multi-device
    (parallel/sharded.make_sharded_step) wrap this exact function, so the
    custom calls of the cuda backend are what runs under shard_map too —
    the two programs cannot diverge. lo/delta are always chunked
    (R, n_chunks); the scan backend expands them here. Returns (score,
    path (R, T) i32, base_ll (R, L, 4)).
    """
    if backend == "cuda":
        res = cuda_dp.cuda_viterbi_batch(
            x, t_len, mu, sigma, n_ref, lo, delta, cfg)
    else:
        T = x.shape[1]
        lo_full = jnp.repeat(lo, cfg.signal_chunk, axis=1)[:, :T]
        res = banded_dp.banded_viterbi_batch(
            x, t_len, mu, sigma, n_ref, lo_full, cfg)

    if cfg.snp_rescore == "local":
        rescore = (cuda_dp.cuda_local_rescore if backend == "cuda"
                   else banded_dp.base_loglik_local_batch)
        base_ll = rescore(x, res.path, t_len, codes, ids, lm, ls, k, cfg,
                          t_w=cfg.snp_local_window)
    else:
        stats = banded_dp.segment_stats_batch(res.path, x, t_len, mu.shape[1])
        base_ll = banded_dp.base_loglik_batch(codes, ids, stats, lm, ls, k)
    return res.score, res.path, base_ll


@functools.partial(jax.jit, static_argnames=("cfg", "backend", "k"))
def _device_step(
    x, t_len, mu, sigma, n_ref, lo, delta, codes, ids, lm, ls,
    cfg: AlignConfig, backend: str, k: int,
):
    """The whole per-batch device program as ONE jitted function (one
    dispatch per batch instead of one per op)."""
    return device_compute(
        x, t_len, mu, sigma, n_ref, lo, delta, codes, ids, lm, ls,
        cfg=cfg, backend=backend, k=k,
    )


BACKENDS = ("auto", "cuda", "scan")


def resolve_backend(cfg: AlignConfig, backend: str = "auto",
                    k: Optional[int] = None) -> str:
    """The device path for one batch config: ``"cuda"`` or ``"scan"``.

    auto: the Hopper kernels (ops/cuda_dp.py) on a GPU when they cover the
    config; the plain lax.scan path on any other platform (the CPU tests)
    and for configs the kernels do not cover — band widths other than
    128/256, a signal chunk other than 128, k outside 4..8. Asking for
    ``"cuda"`` where there is no GPU, or for an uncovered config, raises:
    nothing runs in an interpreter and nothing retries on the CPU.
    """
    k = cfg.k if k is None else k
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    on_gpu = device_backend() == "gpu"
    if backend == "auto":
        return "cuda" if on_gpu and cuda_dp.covers(cfg, k) else "scan"
    if backend == "cuda":
        if not on_gpu:
            raise RuntimeError(
                f"--backend cuda needs a GPU; JAX found {device_backend()!r}")
        if not cuda_dp.covers(cfg, k):
            raise ValueError(
                f"the cuda kernels do not cover band_width={cfg.band_width}, "
                f"signal_chunk={cfg.signal_chunk}, k={k}; use --backend scan")
    return backend


def stage_batch(batch: Batch, model: KmerModel, cfg: AlignConfig,
                backend: str) -> dict:
    """Host prep + device upload of everything _device_step consumes.

    Safe to call from a prefetch thread (jax dispatch is thread-safe), so
    the host→device transfer of batch N+1 overlaps the device compute of
    batch N.
    """
    return dict(
        x=jnp.asarray(batch.x), t_len=jnp.asarray(batch.t_len),
        mu=jnp.asarray(batch.mu), sigma=jnp.asarray(batch.sigma),
        n_ref=jnp.asarray(batch.n_ref), lo=jnp.asarray(batch.bands.lo),
        delta=jnp.asarray(batch.bands.delta),
        codes=jnp.asarray(batch.codes), ids=jnp.asarray(batch.ids),
        lm=jnp.asarray(model.level_mean), ls=jnp.asarray(model.level_std),
        backend=resolve_backend(cfg, backend, model.k), k=model.k,
    )


# stage_batch keys that are device arrays, in device_compute's order
STAGED_ARRAYS = ("x", "t_len", "mu", "sigma", "n_ref", "lo", "delta",
                 "codes", "ids", "lm", "ls")


def align_batch(
    batch: Batch,
    model: KmerModel,
    cfg: AlignConfig,
    backend: str = "auto",
    staged: Optional[dict] = None,
):
    """Run the device part on one batch: DP + base log-likelihoods.

    backend: "auto" (cuda kernels on a GPU, scan otherwise), "cuda",
    "scan" — see :func:`resolve_backend`. Pass ``staged`` (from
    :func:`stage_batch`, e.g. computed in a prefetch thread) to skip the
    in-line host prep + upload. Returns dict of device arrays: score (R,),
    path (R, T), base_loglik (R, L, 4).
    """
    a = staged if staged is not None else stage_batch(
        batch, model, cfg, backend)
    score, path, base_ll = _device_step(
        *(a[key] for key in STAGED_ARRAYS),
        cfg=cfg, backend=a["backend"], k=a["k"],
    )
    return {
        "score": score,
        "path": path,
        "base_loglik": base_ll,
    }
