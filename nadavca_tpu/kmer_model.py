"""Pore model: k-mer → (level mean, level std) table and expected signal.

Parity target: the reference's ``KmerModel`` (SURVEY.md component inventory,
"Pore model" row — reconstructed; reference mount empty, no file:line citation
possible). Capabilities reproduced: load a 4^k-entry table mapping k-mers to
(level_mean, level_stdv), map a reference window to an expected-signal level
sequence, ship a default model in the package.

Because the real ONT R9.4 model file is not available in this sandbox, the
default model is a *synthetic but deterministic* table (seeded PRNG) with
realistic structure: levels dominated by the central bases, unit-scale spread,
per-kmer noise std in a plausible band. The loader also accepts the standard
ONT tsv format (``kmer\tlevel_mean\tlevel_stdv``) so a real model drops in.

Device note: ``expected_signal`` is a flat gather producing (mu, sigma)
float32 arrays per reference window; windows for a whole batch are assembled
host-side and shipped to device once per batch.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from .genome import kmer_ids


@dataclasses.dataclass
class KmerModel:
    k: int
    level_mean: np.ndarray  # (4^k,) float32, normalized scale
    level_std: np.ndarray   # (4^k,) float32

    def __post_init__(self):
        assert self.level_mean.shape == (4 ** self.k,)
        assert self.level_std.shape == (4 ** self.k,)

    # ------------------------------------------------------------------ load
    @classmethod
    def load_tsv(cls, path: str, normalize: str = "auto") -> "KmerModel":
        """Load an ONT-style tsv: columns kmer, level_mean, level_stdv[, ...].

        Handles the quirks of real ONT model files (e.g.
        ``r9.4_450bps.nucleotide.6mer.template.model``): a ``kmer\\tlevel_mean
        \\tlevel_stdv\\tsd_mean\\tsd_stdv\\tweight`` header, extra columns,
        comment lines, CRLF endings, and whitespace-delimited variants.

        ``normalize``: real ONT tables are in picoamps (~60–120 pA levels)
        while this pipeline MAD-normalizes the raw signal to zero-median /
        unit scale, so a pA-scale table must be standardized by the same
        affine map: mu' = (mu − mean(mu))/s, sigma' = sigma/s with
        s = std(mu). "auto" (default) standardizes iff the table looks
        pA-scale (std of the means > 3); "always"/"never" force it.
        """
        kmers, means, stds = [], [], []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#") or line.lower().startswith("kmer"):
                    continue
                parts = line.split("\t") if "\t" in line else line.split()
                if len(parts) < 3:
                    raise ValueError(f"{path}: bad model line {line!r}")
                kmers.append(parts[0].upper())
                means.append(float(parts[1]))
                stds.append(float(parts[2]))
        if not kmers:
            raise ValueError(f"{path}: no k-mer rows found")
        k = len(kmers[0])
        mean_arr = np.zeros(4 ** k, dtype=np.float64)
        std_arr = np.full(4 ** k, np.nan, dtype=np.float64)
        from .genome import encode_bases

        for km, m, s in zip(kmers, means, stds):
            if len(km) != k:
                raise ValueError(f"{path}: mixed k-mer lengths ({km!r} vs k={k})")
            codes = encode_bases(km)
            if (codes > 3).any():
                raise ValueError(f"{path}: non-ACGT k-mer {km!r}")
            idx = 0
            for c in codes:
                idx = idx * 4 + int(c)
            mean_arr[idx] = m
            std_arr[idx] = s
        if np.isnan(std_arr).any():
            n_missing = int(np.isnan(std_arr).sum())
            raise ValueError(
                f"model file {path} covers {4 ** k - n_missing}/{4 ** k} kmers")
        if normalize not in ("auto", "always", "never"):
            raise ValueError(f"normalize={normalize!r}")
        if normalize == "always" or (normalize == "auto" and mean_arr.std() > 3.0):
            s = mean_arr.std() or 1.0
            mean_arr = (mean_arr - mean_arr.mean()) / s
            std_arr = std_arr / s
        return cls(k, mean_arr.astype(np.float32), std_arr.astype(np.float32))

    @classmethod
    def synthetic(cls, k: int = 6, seed: int = 20260817) -> "KmerModel":
        """Deterministic synthetic model with pore-like structure.

        Each base position in the k-mer contributes to the level with a weight
        profile peaked at the pore's sensing position (~center), mimicking how
        real R9 models behave; per-kmer jitter and stds come from a seeded
        PRNG so the table is reproducible everywhere.
        """
        rng = np.random.default_rng(seed)
        n = 4 ** k
        # per-base contribution values, one row per position in the kmer
        base_vals = rng.normal(0.0, 1.0, size=(k, 4))
        # weight profile peaked near the center of the kmer
        pos = np.arange(k)
        center = (k - 1) / 2.0
        weights = np.exp(-0.5 * ((pos - center) / (k / 4.0)) ** 2)
        weights = weights / weights.sum()

        ids = np.arange(n)
        levels = np.zeros(n, dtype=np.float64)
        rem = ids.copy()
        for p in range(k - 1, -1, -1):
            digit = rem % 4
            rem = rem // 4
            levels += weights[p] * base_vals[p, digit]
        levels += rng.normal(0.0, 0.05, size=n)  # per-kmer idiosyncrasy
        # normalize table to zero mean / unit std so it matches MAD-normalized signal scale
        levels = (levels - levels.mean()) / levels.std()
        stds = np.exp(rng.normal(np.log(0.18), 0.15, size=n))  # ~0.13..0.25
        return cls(k, levels.astype(np.float32), stds.astype(np.float32))

    # ------------------------------------------------------- expected signal
    def expected_signal(self, codes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(mu, sigma) float32 arrays for every k-mer position of an encoded window.

        Output length is ``len(codes) - k + 1``; windows containing non-ACGT
        bases get mu=0, sigma=1 (neutral).
        """
        ids = kmer_ids(codes, self.k)
        valid = ids >= 0
        safe = np.where(valid, ids, 0)
        mu = np.where(valid, self.level_mean[safe], 0.0).astype(np.float32)
        sigma = np.where(valid, self.level_std[safe], 1.0).astype(np.float32)
        return mu, sigma

    def save_tsv(self, path: str) -> None:
        from .genome import decode_bases

        with open(path, "w") as f:
            f.write("kmer\tlevel_mean\tlevel_stdv\n")
            for idx in range(4 ** self.k):
                digits = []
                rem = idx
                for _ in range(self.k):
                    digits.append(rem % 4)
                    rem //= 4
                km = decode_bases(np.array(digits[::-1], dtype=np.int8))
                f.write(f"{km}\t{self.level_mean[idx]:.6f}\t{self.level_std[idx]:.6f}\n")


_DEFAULT_MODEL = None


def default_model(k: int = 6) -> KmerModel:
    """The packaged default model (synthetic, deterministic; see class doc)."""
    global _DEFAULT_MODEL
    if _DEFAULT_MODEL is None or _DEFAULT_MODEL.k != k:
        _DEFAULT_MODEL = KmerModel.synthetic(k=k)
    return _DEFAULT_MODEL
