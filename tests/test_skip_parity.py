"""Skip-transition parity across the DP tiers (SURVEY.md §3.4's optional
``V[t−1, i−2]`` transition).

Tiers under test with ``cfg.use_skip=True``:
  1. float64 oracle      ops/dp_spec.py   (brute-force check in test_dp_spec)
  2. lax.scan            ops/banded_dp.py
  3. native C++ core     csrc/banded_dp.cpp via ops/cpu_ref.py
The CUDA kernels' skip plane is checked against the scan tier in
tests/test_cuda_dp.py.

Fixtures are simulated with real pore skip events (simulate_squiggle
``skip_prob``), so the recovered Viterbi paths genuinely contain advance-by-2
steps — asserted below to keep the suite non-vacuous. The restricted local
rescore is additionally checked on a skip path across its three batch tiers.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from nadavca_tpu.config import AlignConfig
from nadavca_tpu.genome import kmer_ids
from nadavca_tpu.io.simulator import random_genome, simulate_read
from nadavca_tpu.kmer_model import default_model
from nadavca_tpu.ops import banded_dp, cpu_ref, dp_spec
from nadavca_tpu.sched import build_chunked_bands

CFG = AlignConfig(band_width=128, signal_chunk=128, use_skip=True,
                  log_p_skip=-4.6)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(123)
    model = default_model()
    genome = random_genome(rng, length=3000)
    reads = [
        simulate_read(genome, "ref", model, rng, read_len=ln, strand=1,
                      mean_dwell=6.0, skip_prob=0.08)
        for ln in (200, 350, 260, 150, 300, 180, 220, 330)
    ]
    R = len(reads)
    T = 128 * ((max(len(r.signal) for r in reads) + 127) // 128)
    L = max(len(r.window_codes) for r in reads)
    N = L - model.k + 1
    x = np.zeros((R, T), np.float32)
    t_len = np.zeros(R, np.int32)
    mu = np.zeros((R, N), np.float32)
    sigma = np.ones((R, N), np.float32)
    n_ref = np.zeros(R, np.int32)
    anchors = np.zeros((R, T), np.float64)
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
    return dict(x=x, t_len=t_len, mu=mu, sigma=sigma, n_ref=n_ref,
                bands=bands, reads=reads, model=model)


def _spec_paths(b):
    lo_full = b["bands"].expand(b["x"].shape[1])
    out = []
    for r, rd in enumerate(b["reads"]):
        t = int(b["t_len"][r])
        n = int(b["n_ref"][r])
        score, path = dp_spec.banded_viterbi(
            rd.signal,
            b["mu"][r, :n].astype(np.float64),
            b["sigma"][r, :n].astype(np.float64),
            lo_full[r, :t].astype(np.int64),
            CFG,
        )
        out.append((score, path))
    return out


def _assert_has_skips(paths):
    """Non-vacuity: at least one advance-by-2 step somewhere in the batch."""
    n_skips = sum(int(np.sum(np.diff(p) == 2)) for p in paths)
    assert n_skips > 0, "fixture produced no skip transitions — test is vacuous"


def test_scan_skip_matches_spec(batch):
    b = batch
    lo_full = b["bands"].expand(b["x"].shape[1])
    scan_res = banded_dp.banded_viterbi_batch(
        b["x"], b["t_len"], b["mu"], b["sigma"], b["n_ref"], lo_full, CFG
    )
    spec = _spec_paths(b)
    paths = []
    for r, (score, path) in enumerate(spec):
        t = int(b["t_len"][r])
        sp = np.asarray(scan_res.path[r, :t])
        agree = np.mean(sp == path)
        assert agree > 0.999, f"read {r}: scan vs spec path agreement {agree}"
        assert np.isclose(float(scan_res.score[r]), score, rtol=1e-4, atol=0.05)
        paths.append(sp)
    _assert_has_skips(paths)


def test_cpu_skip_matches_spec(batch):
    b = batch
    lo_full = b["bands"].expand(b["x"].shape[1])
    paths = []
    for r, (score, path) in enumerate(_spec_paths(b)):
        t = int(b["t_len"][r])
        n = int(b["n_ref"][r])
        c_score, c_path = cpu_ref.banded_viterbi_cpu(
            b["reads"][r].signal.astype(np.float32),
            b["mu"][r, :n], b["sigma"][r, :n],
            lo_full[r, :t].astype(np.int32),
            CFG.band_width, CFG.log_p_stay, CFG.log_p_move,
            log_p_skip=CFG.log_p_skip, use_skip=True,
        )
        agree = np.mean(c_path == path)
        assert agree > 0.999, f"read {r}: C++ vs spec path agreement {agree}"
        assert np.isclose(c_score, score, rtol=1e-4, atol=0.05)
        paths.append(c_path)
    _assert_has_skips(paths)


def test_rescore_tiers_agree_on_skip_path(batch):
    """Restricted local re-DP on a path containing advance-by-2 steps: the
    float64 spec, the XLA batch and the C++ core must all implement the same
    skipped-position window semantics (empty sample range for a skipped
    position; window clamped to the path span)."""
    b = batch
    model = b["model"]
    reads = b["reads"]
    _assert_has_skips([rd.true_path for rd in reads])
    R = len(reads)
    T = b["x"].shape[1]
    L = max(len(rd.window_codes) for rd in reads)
    N = L - model.k + 1
    codes = np.full((R, L), 4, np.int32)
    ids = np.full((R, N), -1, np.int32)
    paths = np.zeros((R, T), np.int32)
    for r, rd in enumerate(reads):
        lw = len(rd.window_codes)
        codes[r, :lw] = rd.window_codes
        ids[r, : lw - model.k + 1] = kmer_ids(rd.window_codes, model.k)
        t = len(rd.signal)
        paths[r, :t] = rd.true_path
        paths[r, t:] = rd.true_path[-1]

    args = (jnp.asarray(b["x"]), jnp.asarray(paths), jnp.asarray(b["t_len"]),
            jnp.asarray(codes), jnp.asarray(ids),
            jnp.asarray(model.level_mean), jnp.asarray(model.level_std),
            model.k)
    ll_scan = np.asarray(banded_dp.base_loglik_local_batch(
        *args, CFG, t_w=CFG.snp_local_window))

    for r, rd in enumerate(reads):
        spec = dp_spec.base_substitution_loglik_local(
            rd.window_codes, rd.true_path, rd.signal.astype(np.float64),
            model.level_mean.astype(np.float64),
            model.level_std.astype(np.float64),
            model.k, CFG, max_window=CFG.snp_local_window,
        )
        lw = len(rd.window_codes)
        np.testing.assert_allclose(ll_scan[r, :lw], spec, rtol=5e-3, atol=5e-2)
        cpu = cpu_ref.base_loglik_local_cpu(
            rd.signal.astype(np.float32), rd.window_codes.astype(np.int32),
            rd.true_path.astype(np.int32),
            model.level_mean.astype(np.float32),
            model.level_std.astype(np.float32),
            model.k, CFG.log_p_stay, CFG.log_p_move,
            max_window=CFG.snp_local_window,
        )
        np.testing.assert_allclose(cpu, spec, rtol=5e-3, atol=5e-2)
