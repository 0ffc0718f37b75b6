"""Public Python API: ``align_signal`` and ``call_snps``.

Reference parity for the documented library entry point (SURVEY.md §3.3:
``import nadavca; align_signal(reference, fast5_paths, config…)`` returns
per-read alignment objects — per-position signal ranges + likelihoods —
instead of writing files; reconstructed, mount empty). This rebuild keeps
that surface but batches reads onto the device: ingest/anchor on host,
bucketed padded batches, one jitted banded-Viterbi + rescore program per
bucket shape.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from . import call as callmod
from .config import AlignConfig, DEFAULT_CONFIG
from .genome import Genome
from .io import fast5 as fast5mod
from .io.fast5 import RawRead
from .kmer_model import KmerModel, default_model
from .pipeline import (Batch, ReadRecord, align_batch, assemble_batch,
                       make_preprocessor, path_to_segments)


@dataclasses.dataclass
class ReadAlignment:
    """Refined signal↔reference alignment of one read.

    ``seg_start``/``seg_end`` give, for each reference position in
    ``[ref_start, ref_end)``, the half-open range of signal sample indices
    aligned to it (-1/-1 if the Viterbi path never visits the position).
    ``base_loglik`` (optional) is the (window_len, 4) per-position
    base-substitution log-likelihood table the SNP caller consumes.
    """

    read_id: str
    contig: str
    strand: int               # +1 forward, -1 reverse
    ref_start: int            # genome coordinates of the aligned window
    ref_end: int
    seg_start: np.ndarray     # (window_len,) int
    seg_end: np.ndarray       # (window_len,) int
    score: float              # alignment log-likelihood
    base_loglik: Optional[np.ndarray] = None  # (window_len, 4) float32

    def __len__(self) -> int:
        return self.ref_end - self.ref_start


PathsLike = Union[str, Sequence[str]]


def _iter_raw(fast5: PathsLike) -> Iterator[RawRead]:
    """Yield raw reads from a fast5 file, a directory, or a list of either."""
    paths = [fast5] if isinstance(fast5, (str, os.PathLike)) else list(fast5)
    for p in paths:
        p = os.fspath(p)
        if os.path.isdir(p):
            yield from fast5mod.iter_fast5_dir(p)
            from .io import pod5 as pod5mod

            if pod5mod.HAVE_POD5:
                yield from pod5mod.iter_pod5_dir(p)
        else:
            yield from fast5mod.read_fast5(p)


def _as_genome(reference: Union[str, Genome]) -> Genome:
    if isinstance(reference, Genome):
        return reference
    return Genome.from_fasta(os.fspath(reference))


def _preprocess(
    raws: Iterable[RawRead],
    genome: Genome,
    model: KmerModel,
    cfg: AlignConfig,
    workers: int = 1,
    prep: str = "auto",
) -> List[ReadRecord]:
    work = make_preprocessor(genome, cfg, model=model, mode=prep)
    raws = list(raws)
    if workers > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(workers) as pool:
            results = list(pool.map(work, raws))
    else:
        results = [work(r) for r in raws]
    return [r for r in results if r is not None]


def _batches(
    records: Sequence[ReadRecord], batch_reads: int
) -> Iterator[List[ReadRecord]]:
    records = sorted(records, key=lambda r: len(r.signal))
    for i in range(0, len(records), batch_reads):
        yield list(records[i : i + batch_reads])


def _run_batches(
    records: Sequence[ReadRecord],
    genome: Genome,
    model: KmerModel,
    cfg: AlignConfig,
    backend: str,
    batch_reads: int,
) -> Iterator[Tuple[List[ReadRecord], Batch, dict]]:
    for group in _batches(records, batch_reads):
        batch = assemble_batch(group, model, cfg)
        out = align_batch(batch, model, cfg, backend=backend)
        yield group, batch, out


def align_signal(
    reference: Union[str, Genome],
    fast5: PathsLike,
    config: Optional[AlignConfig] = None,
    model: Optional[KmerModel] = None,
    backend: str = "auto",
    batch_reads: int = 256,
    compute_probabilities: bool = True,
    workers: int = 1,
    prep: str = "auto",
) -> List[ReadAlignment]:
    """Align raw signal of every read in ``fast5`` to ``reference``.

    Parameters mirror the reference's library entry point: ``reference`` is a
    FASTA path (or an already-loaded :class:`Genome`), ``fast5`` a file,
    directory, or list of either, ``config`` an :class:`AlignConfig`
    (defaults otherwise). Returns one :class:`ReadAlignment` per
    successfully anchored read, in input order; unanchorable or
    basecall-less reads are silently dropped (the reference skips them with
    a warning — SURVEY.md §5 failure-handling row).
    """
    cfg = config or DEFAULT_CONFIG
    genome = _as_genome(reference)
    model = model or default_model(cfg.k)
    records = _preprocess(_iter_raw(fast5), genome, model, cfg, workers,
                          prep=prep)
    order = {r.read_id: i for i, r in enumerate(records)}
    results: List[Optional[ReadAlignment]] = [None] * len(records)
    for group, batch, out in _run_batches(records, genome, model, cfg,
                                          backend, batch_reads):
        paths = np.asarray(out["path"])
        scores = np.asarray(out["score"])
        bll = np.asarray(out["base_loglik"]) if compute_probabilities else None
        for r in range(batch.n_reads):
            rec = group[r]
            seg_start, seg_end = path_to_segments(
                paths[r], int(batch.t_len[r]), int(batch.n_ref[r])
            )
            wlen = int(batch.window_len[r])
            results[order[rec.read_id]] = ReadAlignment(
                read_id=rec.read_id,
                contig=rec.anchor.contig,
                strand=rec.anchor.strand,
                ref_start=rec.anchor.ref_start,
                ref_end=rec.anchor.ref_end,
                seg_start=seg_start,
                seg_end=seg_end,
                score=float(scores[r]),
                base_loglik=bll[r, :wlen] if bll is not None else None,
            )
    return [a for a in results if a is not None]


def call_snps(
    reference: Union[str, Genome],
    fast5: PathsLike,
    config: Optional[AlignConfig] = None,
    model: Optional[KmerModel] = None,
    backend: str = "auto",
    batch_reads: int = 256,
    min_coverage: int = 2,
    workers: int = 1,
    prep: str = "auto",
) -> List[callmod.SnpCall]:
    """Signal-level SNP calls over all reads in ``fast5`` vs ``reference``.

    The library-API twin of the ``snp`` CLI subcommand (SURVEY.md §3.2):
    per-read base log-likelihoods from the banded DP are scatter-added into
    per-contig locus accumulators, converted to posteriors, and thresholded
    into :class:`~nadavca_tpu.call.SnpCall` records.
    """
    import jax.numpy as jnp

    cfg = config or DEFAULT_CONFIG
    genome = _as_genome(reference)
    model = model or default_model(cfg.k)
    records = _preprocess(_iter_raw(fast5), genome, model, cfg, workers,
                          prep=prep)
    accs = {c.name: callmod.make_accumulators(len(c), with_votes=True)
            for c in genome}
    for group, batch, out in _run_batches(records, genome, model, cfg,
                                          backend, batch_reads):
        by_contig: dict = {}
        for r in range(batch.n_reads):
            by_contig.setdefault(group[r].anchor.contig, []).append(r)
        for cname, rows in by_contig.items():
            rows_arr = np.asarray(rows, np.int32)
            acc, cov, votes = accs[cname]
            accs[cname] = callmod.accumulate_batch(
                acc, cov,
                out["base_loglik"][rows_arr],
                jnp.asarray(batch.window_start[rows_arr]),
                jnp.asarray(batch.window_len[rows_arr]),
                jnp.asarray(batch.strand[rows_arr]),
                votes=votes, cfg=cfg,
            )
    calls: List[callmod.SnpCall] = []
    if cfg.snp_joint_rescore:
        # records are still in memory here, so the joint pass needs no
        # re-ingest — it re-scores candidate clusters directly
        from . import joint

        records_by_id = {r.read_id: r for r in records}
        metas_by_contig: dict = {}
        for r in records:
            metas_by_contig.setdefault(r.anchor.contig, []).append(
                joint.ReadMeta(r.read_id, r.anchor.contig,
                               int(r.anchor.ref_start),
                               len(r.window_codes), int(r.anchor.strand)))
        for cname, (acc, cov, votes) in accs.items():
            calls.extend(joint.refine_contig_calls(
                np.asarray(acc), np.asarray(cov), np.asarray(votes),
                genome[cname].codes, cname, cfg, model,
                metas_by_contig.get(cname, []), records_by_id,
                min_coverage=min_coverage))
        return calls
    for cname, (acc, cov, votes) in accs.items():
        calls.extend(
            callmod.call_snps(
                np.asarray(acc), np.asarray(cov), genome[cname].codes, cname,
                cfg, min_coverage=min_coverage, votes=np.asarray(votes),
            )
        )
    return calls
