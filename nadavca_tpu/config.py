"""Configuration for the nanopore signal aligner / SNP caller.

Reference parity note: the reference tool (fmfi-compbio/nadavca) ships a YAML
defaults file inside the package and exposes a ``--configuration`` override on
the CLI (SURVEY.md L2/L4, "Config system" row of the component inventory; the
reference mount was empty at build time so no file:line citation is possible).
We keep the same shape — a single flat config, YAML-loadable — but make it a
frozen, hashable dataclass so it can be closed over by ``jax.jit`` without
retriggering traces.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AlignConfig:
    """Parameters of signal→reference alignment and SNP calling.

    Everything that shapes a compiled kernel (band width, bucket edges, k) is
    static here; anything that is per-run data (file paths, thresholds used
    host-side) is free to vary without recompilation.
    """

    # --- k-mer / pore model ---
    k: int = 6                    # k-mer length of the pore model (R9.4-era default)
    # --- signal normalization ---
    normalization: str = "mad"    # "mad" (median/MAD) or "meanstd"
    # --- banded DP ---
    band_width: int = 128         # total band width B; a multiple of 128 (the
                                  # CUDA fill covers 128 and 256: 4 or 8 slots
                                  # per lane of one warp)
    log_p_stay: float = -0.1054   # log prob of emitting another sample at same position (~0.9)
    log_p_move: float = -2.3026   # log prob of advancing one position (~0.1)
    log_p_skip: float = -1e30     # log prob of skipping a position (disabled by default)
    use_skip: bool = False        # enable the skip transition (advance by 2)
    # --- SNP calling ---
    snp_prior: float = 0.25       # uniform prior over the 4 bases
    snp_threshold: float = 0.9    # posterior threshold for emitting a call
    snp_rescore: str = "local"    # "local": restricted re-DP per substitution
                                  # (reference semantics, unbiased);
                                  # "fixed": closed-form fixed-path re-score (fast approx)
    snp_local_window: int = 192   # max samples per local re-DP window
    snp_ll_clip: float = 25.0     # per-read per-position |log-lik delta| cap
                                  # (bounds the influence of one bad read)
    snp_vote_margin: float = 3.0  # per-read margin for an alt "vote"
    snp_min_alt_votes: int = 3    # reads voting alt required for a call
                                  # (3 removes the 4x-coverage FP floor:
                                  # grid FP 14 -> 7 at recall cost only
                                  # below min_coverage — threshold sweep
                                  # 2026-08-20, BASELINE.md)
    snp_cluster_prune: bool = True  # suppress weaker calls within k of a stronger one
    # --- joint adjacent-hypothesis rescore (VERDICT r3 task 2) ---
    # the per-position model scores each substitution against ITS own local
    # signal window, so a true SNP's perturbed k-mers can make a neighbor
    # position's alt hypothesis score best (the adjacent-shift ambiguity —
    # the f64 oracle makes the same shifted call). The joint pass re-scores
    # every candidate cluster's hypothesis set {ref} ∪ {alt b @ p, |p-hit|<k}
    # by full re-ALIGNMENT of the same signal slice per hypothesis, and keeps
    # the argmax hypothesis.
    # DEFAULT OFF after measurement (BASELINE.md 2026-08-21 joint-rescore
    # note): on clean simulations the pass places every planted SNP at its
    # exact position (tests/test_joint.py), but under realistic error
    # processes (5% indels, 3% pore skips) per-read realignment deltas are
    # heavy-tailed and occasionally coherent in the wrong direction, and
    # every aggregation tried (raw sums, clipped sums, medians, locate-pass
    # trimming, accumulator gating) nets slightly WORSE grid F1 than the
    # per-position caller it refines. Kept as an opt-in pass; the
    # adjacent-shift ambiguity remains the documented accuracy tail.
    snp_joint_rescore: bool = False
    snp_joint_pad: int = 12         # context positions kept around the cluster
    # the joint pass REFINES the per-position caller, never overrides it
    # cheaply: a call moves to a different position/base only when the
    # per-read MEDIAN delta prefers it over the caller's pick by
    # snp_joint_repos_margin nats/read, with at least snp_joint_min_reads
    # fully-covering reads, onto a position with accumulator alt support.
    snp_joint_min_reads: int = 4
    snp_joint_repos_margin: float = 25.0
    # indel-tolerant joint slice scoring (VERDICT r4 next-round task 1b):
    # the r4 postmortem localized the joint pass's failures to READ-level
    # contamination — the simulator's 3% pore-skip process forces the
    # no-skip slice DP to misattribute samples (a skipped position must
    # still absorb >=1 sample), producing the heavy-tailed, occasionally
    # coherent-wrong per-read deltas. With snp_joint_skip the slice DPs
    # (locate + score) run with the skip transition enabled at
    # snp_joint_log_p_skip, so a genuinely skipped position costs one
    # bounded penalty instead of a distorted alignment.
    snp_joint_skip: bool = False
    snp_joint_log_p_skip: float = -3.5
    # exclude contaminated reads from the joint evidence (task 1a): a read's
    # locate-pass alignment yields a per-read quality score (mean per-sample
    # emission log-lik over the scored slice); reads more than
    # snp_joint_filter_mad MADs below the cluster median are dropped from
    # the delta matrix before aggregation. 0 disables the filter.
    snp_joint_filter_mad: float = 0.0
    # device routing for the joint pass's hypothesis-row DP slabs. "cpu"
    # (default): the host CPU scores them — right when clusters are few,
    # where per-slab host<->device transfers dominate. "default": run the
    # fixed-shape slabs on the default JAX device — for whole-genome
    # workloads, where the host CPU is the bottleneck (host timings in
    # BASELINE.md's joint-scale row; the device side is not measured).
    snp_joint_device: str = "cpu"
    # --- batching ---
    # signal-length buckets: ~1.25x geometric steps (128-aligned) bound the
    # worst-case padding waste at ~20% (power-of-two steps measured 38% on
    # 10k-sample reads); each distinct edge is one more cached XLA executable
    bucket_edges: tuple = (1024, 1280, 1664, 2176, 2816, 3584, 4480, 5632,
                           7040, 8832, 11136, 13952, 17536, 22016, 27520,
                           34432, 43136, 54016, 65536)
    signal_chunk: int = 128       # samples per band-offset update (kernel chunking)
    adaptive_band_threshold: int = 16384  # signal samples above which the wide band is used
    band_width_long: int = 256    # band width for long reads (adaptive band, config 3)
    # --- mesh ---
    data_axis: str = "data"       # mesh axis name for data-parallel read sharding
    genome_axis: str = "genome"   # mesh axis name for sharded locus accumulators

    def __post_init__(self):
        if self.band_width % 128 != 0:
            raise ValueError(f"band_width must be a multiple of 128, got {self.band_width}")
        if self.k < 1:
            raise ValueError("k must be >= 1")

    @classmethod
    def from_yaml(cls, path: str, **overrides) -> "AlignConfig":
        import yaml  # only --configuration needs it

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        raw.update(overrides)
        if "bucket_edges" in raw:
            raw["bucket_edges"] = tuple(raw["bucket_edges"])
        return cls(**raw)

    def to_yaml(self, path: str) -> None:
        import yaml

        d = dataclasses.asdict(self)
        d["bucket_edges"] = list(d["bucket_edges"])
        with open(path, "w") as f:
            yaml.safe_dump(d, f)


DEFAULT_CONFIG = AlignConfig()
