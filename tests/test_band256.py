"""Band width 256 (the adaptive long-read band) through the scan backend,
checked against the float64 oracle."""

import numpy as np
import pytest

from nadavca_tpu.config import AlignConfig
from nadavca_tpu.io.simulator import random_genome, simulate_read
from nadavca_tpu.kmer_model import default_model
from nadavca_tpu.ops import banded_dp, dp_spec
from nadavca_tpu.sched import build_chunked_bands

CFG = AlignConfig(band_width=256, signal_chunk=128)


def test_scan_b256_matches_spec():
    rng = np.random.default_rng(17)
    model = default_model()
    genome = random_genome(rng, length=3000)
    reads = [
        simulate_read(genome, "ref", model, rng, read_len=ln, strand=1,
                      mean_dwell=8.0)
        for ln in (250, 300, 280, 260, 290, 270, 310, 240)
    ]
    R = 8
    T = 128 * ((max(len(r.signal) for r in reads) + 127) // 128)
    L = max(len(r.window_codes) for r in reads)
    N = L - model.k + 1
    x = np.zeros((R, T), np.float32)
    t_len = np.zeros(R, np.int32)
    mu = np.zeros((R, N), np.float32)
    sigma = np.ones((R, N), np.float32)
    n_ref = np.zeros(R, np.int32)
    anchors = np.zeros((R, T))
    for r, rd in enumerate(reads):
        t = len(rd.signal)
        x[r, :t] = rd.signal
        t_len[r] = t
        m, s = model.expected_signal(rd.window_codes)
        mu[r, : len(m)] = m
        sigma[r, : len(m)] = s
        n_ref[r] = len(m)
        anchors[r, :t] = rd.true_path
        anchors[r, t:] = rd.true_path[-1]
    bands = build_chunked_bands(anchors, t_len, n_ref, CFG.band_width,
                                CFG.signal_chunk)
    lo_full = bands.expand(T)
    scan_res = banded_dp.banded_viterbi_batch(x, t_len, mu, sigma, n_ref,
                                              lo_full, CFG)
    for r, rd in enumerate(reads):
        t = int(t_len[r])
        n = int(n_ref[r])
        score, path = dp_spec.banded_viterbi(
            rd.signal, mu[r, :n].astype(np.float64),
            sigma[r, :n].astype(np.float64), lo_full[r, :t].astype(np.int64),
            CFG)
        sp = np.asarray(scan_res.path[r, :t])
        assert np.mean(sp == path) > 0.999, f"read {r}: path vs spec"
        assert np.isclose(float(scan_res.score[r]), score, rtol=1e-4, atol=0.05)
