"""SNP calling: cross-read aggregation of base likelihoods → posteriors → VCF.

Parity target: the reference's estimator/SNP layer (SURVEY.md L3, "SNP caller
/ estimator" row and §3.2 — reconstructed; mount empty): per-read per-position
base log-likelihoods are summed across reads covering each locus, converted to
posteriors under a uniform prior, thresholded, and reported.

Device shape: the aggregation is a scatter-add of (R, L, 4) read windows
into a (G, 4) genome accumulator — a single fused XLA op per batch; across
devices the accumulators are sharded over the genome axis and merged by psum
(parallel/accumulators.py). Reverse-strand reads are handled by flipping the
window coordinates and complementing the base axis before the scatter.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .config import AlignConfig

# complement permutation of the base axis (A<->T, C<->G)
_COMP = np.array([3, 2, 1, 0], dtype=np.int32)


def scatter_values(
    base_ll: jax.Array,      # (R, L, 4) float32 per-read window log-likelihoods
    window_start: jax.Array, # (R,) int32 genome coord of window base 0 (fwd strand)
    window_len: jax.Array,   # (R,) int32 true window lengths
    strand: jax.Array,       # (R,) int32 +1 / -1
    G: int,
    cfg: AlignConfig,
):
    """The single source of truth for the locus scatter semantics.

    Maps one batch of read windows to flat scatter indices and values —
    consumed by :func:`accumulate_batch` (single-device, in-place) and by
    parallel/sharded.make_sharded_step (fresh deltas + psum), so the two
    aggregation paths produce identical state by construction.

    Per-read contributions are clipped to ±cfg.snp_ll_clip so a single
    misanchored read cannot dominate a locus, and each read casts at most one
    "vote" per position for a base whose margin over the runner-up exceeds
    cfg.snp_vote_margin (consumed by call_snps' min-alt-votes filter).

    Returns (flat_pos (R·L,) int32 with G as the overflow row, ll (R·L, 4)
    clipped+masked values, n_valid (R·L,) int32, votes_onehot (R·L, 4) int32).
    """
    R, L, _ = base_ll.shape
    li = jnp.arange(L, dtype=jnp.int32)[None, :]          # (1, L)
    rev = strand[:, None] < 0                              # (R, 1)
    # genome position of window base i
    pos_fwd = window_start[:, None] + li
    pos_rev = window_start[:, None] + (window_len[:, None] - 1 - li)
    pos = jnp.where(rev, pos_rev, pos_fwd)                 # (R, L)
    valid = (li < window_len[:, None]) & (pos >= 0) & (pos < G)
    pos_safe = jnp.where(valid, pos, G)                    # scatter into overflow row

    # complement base axis for reverse reads
    comp = jnp.asarray(_COMP)
    ll_rev = base_ll[:, :, comp]
    ll_raw = jnp.where(rev[:, :, None], ll_rev, base_ll)
    ll = jnp.clip(ll_raw, -cfg.snp_ll_clip, cfg.snp_ll_clip)
    ll = jnp.where(valid[:, :, None], ll, 0.0)

    # per-read confident votes (on UNclipped deltas): best base beats the
    # runner-up by the margin
    best = jnp.argmax(ll_raw, axis=2)                      # (R, L); ref col is 0
    best_v = jnp.max(ll_raw, axis=2)
    second = jnp.sort(ll_raw, axis=2)[:, :, 2]
    confident = (best_v - second >= cfg.snp_vote_margin) & valid
    onehot = jax.nn.one_hot(best, 4, dtype=jnp.int32) * confident[..., None]
    return (pos_safe.reshape(-1), ll.reshape(-1, 4),
            valid.reshape(-1).astype(jnp.int32), onehot.reshape(-1, 4))


@functools.partial(jax.jit, donate_argnames=("acc", "cov", "votes"),
                   static_argnames=("cfg",))
def accumulate_batch(
    acc: jax.Array,          # (G, 4) float32 genome log-likelihood accumulator
    cov: jax.Array,          # (G,) int32 read coverage counter
    base_ll: jax.Array,      # (R, L, 4) float32 per-read window log-likelihoods
    window_start: jax.Array, # (R,) int32 genome coord of window base 0 (fwd strand)
    window_len: jax.Array,   # (R,) int32 true window lengths
    strand: jax.Array,       # (R,) int32 +1 / -1
    votes: Optional[jax.Array] = None,  # (G, 4) int32 per-read alt-vote counter
    cfg: AlignConfig = AlignConfig(),
):
    """Scatter-add one batch of read windows into the genome accumulators."""
    G = acc.shape[0]
    flat_pos, ll, n_valid, onehot = scatter_values(
        base_ll, window_start, window_len, strand, G, cfg)
    acc_pad = jnp.concatenate([acc, jnp.zeros((1, 4), acc.dtype)], axis=0)
    acc_pad = acc_pad.at[flat_pos].add(ll)
    cov_pad = jnp.concatenate([cov, jnp.zeros((1,), cov.dtype)], axis=0)
    cov_pad = cov_pad.at[flat_pos].add(n_valid)
    if votes is None:
        return acc_pad[:G], cov_pad[:G]
    votes_pad = jnp.concatenate([votes, jnp.zeros((1, 4), votes.dtype)], axis=0)
    votes_pad = votes_pad.at[flat_pos].add(onehot)
    return acc_pad[:G], cov_pad[:G], votes_pad[:G]


def make_accumulators(genome_len: int, with_votes: bool = False):
    """Fresh (G, 4) log-likelihood and (G,) coverage accumulators."""
    acc = jnp.zeros((genome_len, 4), jnp.float32)
    cov = jnp.zeros((genome_len,), jnp.int32)
    if with_votes:
        return acc, cov, jnp.zeros((genome_len, 4), jnp.int32)
    return acc, cov


@functools.partial(jax.jit, static_argnames=("prior",))
def posteriors(acc: jax.Array, prior: float = 0.25) -> jax.Array:
    """(G, 4) posterior probabilities from aggregated log-likelihoods."""
    logp = acc + jnp.log(prior)
    return jax.nn.softmax(logp, axis=-1)


@dataclasses.dataclass
class SnpCall:
    contig: str
    position: int         # 0-based genome coordinate
    ref_base: str
    alt_base: str
    probability: float
    coverage: int


def candidate_hits(
    acc: np.ndarray,
    cov: np.ndarray,
    ref_codes: np.ndarray,
    cfg: AlignConfig = AlignConfig(),
    min_coverage: int = 1,
    votes: Optional[np.ndarray] = None,
):
    """Pre-prune candidate positions: (hit mask, best base, posterior).

    The filter stack of :func:`call_snps` WITHOUT cluster pruning — the
    joint-rescore pass (nadavca_tpu.joint) uses these as cluster seeds, so
    a true SNP suppressed by a stronger shifted neighbor is still in play.
    """
    post = np.asarray(posteriors(jnp.asarray(acc), cfg.snp_prior))
    cov = np.asarray(cov)
    best = post.argmax(axis=1)
    pbest = post.max(axis=1)
    ref = np.asarray(ref_codes)
    hit = (best != ref) & (pbest >= cfg.snp_threshold) & (cov >= min_coverage) & (ref < 4)
    if votes is not None:
        v = np.take_along_axis(np.asarray(votes), best[:, None], axis=1)[:, 0]
        hit &= v >= cfg.snp_min_alt_votes
    return hit, best, pbest


def call_snps(
    acc: np.ndarray,
    cov: np.ndarray,
    ref_codes: np.ndarray,
    contig: str,
    cfg: AlignConfig = AlignConfig(),
    min_coverage: int = 1,
    votes: Optional[np.ndarray] = None,
) -> List[SnpCall]:
    """Threshold posteriors into SNP calls (host side, tiny).

    Filters: posterior >= snp_threshold, coverage >= min_coverage, and (when
    a votes accumulator is provided) >= snp_min_alt_votes reads individually
    voting for the alt; finally cluster pruning keeps only the strongest call
    within any window of k-1 bases (neighbors of a true SNP share perturbed
    k-mers and would otherwise bleed into spurious calls).
    """
    hit, best, pbest = candidate_hits(acc, cov, ref_codes, cfg,
                                      min_coverage=min_coverage, votes=votes)
    cov = np.asarray(cov)
    ref = np.asarray(ref_codes)
    calls = []
    bases = "ACGT"
    acc_np = np.asarray(acc)
    strength = acc_np.max(axis=1) - np.take_along_axis(
        acc_np, ref[:, None].clip(0, 3), axis=1
    )[:, 0]
    idxs = list(np.nonzero(hit)[0])
    if cfg.snp_cluster_prune and idxs:
        keep = []
        for g in idxs:
            better = [h for h in idxs
                      if h != g and abs(h - g) < cfg.k and strength[h] > strength[g]]
            if not better:
                keep.append(g)
        idxs = keep
    for g in idxs:
        calls.append(
            SnpCall(
                contig=contig,
                position=int(g),
                ref_base=bases[ref[g]],
                alt_base=bases[best[g]],
                probability=float(pbest[g]),
                coverage=int(cov[g]),
            )
        )
    return calls


def write_vcf(path: str, calls: List[SnpCall], source: str = "nadavca_tpu") -> None:
    """Minimal VCF 4.2 output of SNP calls."""
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n")
        f.write(f"##source={source}\n")
        f.write('##INFO=<ID=DP,Number=1,Type=Integer,Description="Read coverage">\n')
        f.write('##INFO=<ID=PP,Number=1,Type=Float,Description="Posterior probability">\n')
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for c in calls:
            qual = min(999.0, -10.0 * np.log10(max(1e-100, 1.0 - c.probability)))
            f.write(
                f"{c.contig}\t{c.position + 1}\t.\t{c.ref_base}\t{c.alt_base}\t"
                f"{qual:.1f}\tPASS\tDP={c.coverage};PP={c.probability:.6f}\n"
            )


def write_alignment(path: str, read_id: str, contig: str, strand: int,
                    ref_start: int, ref_end: int,
                    seg_start: np.ndarray, seg_end: np.ndarray) -> None:
    """Per-read alignment output: reference position → signal sample range.

    Mirrors the reference's `align` output shape (header + per-position
    ranges; SURVEY.md "Output writers" row).
    """
    with open(path, "w") as f:
        strand_c = "+" if strand > 0 else "-"
        f.write(f"# read={read_id} contig={contig} strand={strand_c} "
                f"start={ref_start} end={ref_end}\n")
        for i, (s, e) in enumerate(zip(seg_start, seg_end)):
            if s >= 0:
                f.write(f"{i}\t{s}\t{e}\n")
