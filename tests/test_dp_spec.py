"""Tests of the numpy executable spec (the oracle itself).

Validates the banded Viterbi spec against (a) an independent brute-force
unbanded DP written here, and (b) simulated squiggles with known ground truth.
"""

import numpy as np
import pytest

from nadavca_tpu.config import AlignConfig
from nadavca_tpu.io.simulator import random_genome, simulate_read, simulate_squiggle
from nadavca_tpu.kmer_model import default_model
from nadavca_tpu.ops import dp_spec


def brute_force_viterbi(x, mu, sigma, cfg):
    """Independent O(T*N) unbanded Viterbi with the same transition model."""
    T, N = len(x), len(mu)
    V = np.full((T, N), dp_spec.NEG_INF)
    back = np.zeros((T, N), dtype=np.int64)
    emit = dp_spec.gaussian_logpdf(x[:, None], mu[None, :], sigma[None, :])
    V[0] = emit[0]
    for t in range(1, T):
        for i in range(N):
            best, adv = V[t - 1, i] + cfg.log_p_stay, 0
            if i >= 1 and V[t - 1, i - 1] + cfg.log_p_move > best:
                best, adv = V[t - 1, i - 1] + cfg.log_p_move, 1
            if cfg.use_skip and i >= 2 and V[t - 1, i - 2] + cfg.log_p_skip > best:
                best, adv = V[t - 1, i - 2] + cfg.log_p_skip, 2
            V[t, i] = emit[t, i] + best
            back[t, i] = adv
    i = int(np.argmax(V[T - 1]))
    score = float(V[T - 1, i])
    path = np.zeros(T, dtype=np.int64)
    path[T - 1] = i
    for t in range(T - 1, 0, -1):
        i -= back[t, i]
        path[t - 1] = i
    return score, path


@pytest.mark.parametrize("use_skip", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_banded_matches_bruteforce_when_band_covers_all(seed, use_skip):
    rng = np.random.default_rng(seed)
    model = default_model()
    genome = random_genome(rng, length=80)
    window = genome["ref"].codes
    x, true_path = simulate_squiggle(window, model, rng, mean_dwell=6.0)
    mu, sigma = model.expected_signal(window)
    mu, sigma = mu.astype(np.float64), sigma.astype(np.float64)
    cfg = AlignConfig(band_width=128, use_skip=use_skip,
                      log_p_skip=-4.0 if use_skip else -1e30)
    # band covers the whole reference (N < band_width) => must equal unbanded
    lo = dp_spec.make_band(np.zeros(len(x)), len(mu), cfg.band_width)
    score_b, path_b = dp_spec.banded_viterbi(x, mu, sigma, lo, cfg)
    score_f, path_f = brute_force_viterbi(x, mu, sigma, cfg)
    assert np.isclose(score_b, score_f, rtol=1e-12)
    np.testing.assert_array_equal(path_b, path_f)


def test_viterbi_recovers_true_path_low_noise():
    rng = np.random.default_rng(7)
    model = default_model()
    genome = random_genome(rng, length=400)
    window = genome["ref"].codes
    x, true_path = simulate_squiggle(window, model, rng, mean_dwell=9.0, noise_scale=0.5)
    mu, sigma = model.expected_signal(window)
    mu, sigma = mu.astype(np.float64), sigma.astype(np.float64)
    cfg = AlignConfig(band_width=128)
    lo = dp_spec.make_band(true_path.astype(np.float64), len(mu), cfg.band_width)
    _, path = dp_spec.banded_viterbi(x, mu, sigma, lo, cfg)
    # at low noise the recovered path should sit within a couple of positions
    # of the truth for the vast majority of samples
    err = np.abs(path - true_path)
    assert np.mean(err <= 2) > 0.95, f"mean |err|<=2 fraction: {np.mean(err <= 2)}"


def test_path_segments_roundtrip():
    path = np.array([0, 0, 1, 1, 1, 3, 3, 4])
    start, end = dp_spec.path_segments(path, 6)
    np.testing.assert_array_equal(start, [0, 2, -1, 5, 7, -1])
    np.testing.assert_array_equal(end, [2, 5, -1, 7, 8, -1])


def test_segment_stats_match_direct_sum():
    rng = np.random.default_rng(3)
    x = rng.normal(size=50)
    path = np.sort(rng.integers(0, 10, size=50))
    stats = dp_spec.segment_stats(path, x, 10)
    for i in range(10):
        sel = x[path == i]
        assert np.isclose(stats[i, 0], len(sel))
        assert np.isclose(stats[i, 1], sel.sum())
        assert np.isclose(stats[i, 2], (sel ** 2).sum())


def test_gaussian_segment_loglik_matches_pointwise():
    rng = np.random.default_rng(4)
    xs = rng.normal(size=20)
    mu, sigma = 0.3, 0.7
    stats = np.array([len(xs), xs.sum(), (xs ** 2).sum()])
    direct = dp_spec.gaussian_logpdf(xs, mu, sigma).sum()
    closed = dp_spec.gaussian_segment_loglik(stats, mu, sigma)
    assert np.isclose(direct, closed, rtol=1e-12)


def test_base_substitution_favors_true_base():
    """On a clean simulated read the reference base should win almost everywhere."""
    rng = np.random.default_rng(11)
    model = default_model()
    genome = random_genome(rng, length=300)
    read = simulate_read(genome, "ref", model, rng, read_len=300, strand=1,
                         mean_dwell=10.0, noise_scale=0.7)
    res = dp_spec.full_read_spec(
        read.signal, read.window_codes, model,
        anchor=read.true_path.astype(np.float64),
    )
    ll = res["base_loglik"]  # (L, 4), ref base normalized to 0
    L = ll.shape[0]
    k = model.k
    # interior positions (all k overlapping kmers exist)
    interior = slice(k, L - k)
    winners = np.argmax(ll[interior], axis=1)
    truth = read.window_codes[interior]
    frac = np.mean(winners == truth)
    assert frac > 0.9, f"true base wins at only {frac:.2%} of interior positions"


def test_base_substitution_detects_snp():
    """Mutate one base in the reference window; the signal (from the original)
    should vote for the original base at that position."""
    rng = np.random.default_rng(13)
    model = default_model()
    genome = random_genome(rng, length=200)
    window = genome["ref"].codes.copy()
    x, true_path = simulate_squiggle(window, model, rng, mean_dwell=10.0, noise_scale=0.7)
    pos = 100
    true_base = int(window[pos])
    mutated = window.copy()
    mutated[pos] = (true_base + 1) % 4  # the "reference" now disagrees with the signal
    res = dp_spec.full_read_spec(x, mutated, model, anchor=true_path.astype(np.float64))
    ll = res["base_loglik"]
    assert int(np.argmax(ll[pos])) == true_base
    # and the margin should be decisive
    assert ll[pos, true_base] - ll[pos, (true_base + 1) % 4] > 2.0


def _banded_read(seed, use_skip):
    rng = np.random.default_rng(seed)
    model = default_model()
    genome = random_genome(rng, length=600)
    read = simulate_read(genome, "ref", model, rng, read_len=500, strand=1,
                         mean_dwell=6.0, skip_prob=0.05 if use_skip else 0.0)
    mu, sigma = model.expected_signal(read.window_codes)
    cfg = AlignConfig(band_width=128, use_skip=use_skip,
                      log_p_skip=-4.6 if use_skip else -1e30)
    lo = dp_spec.make_band(read.true_path.astype(np.float64), len(mu),
                           cfg.band_width)
    return (read.signal, mu.astype(np.float64), sigma.astype(np.float64),
            lo, cfg)


@pytest.mark.parametrize("use_skip", [False, True])
def test_path_score_of_the_viterbi_path_is_its_score(use_skip):
    x, mu, sigma, lo, cfg = _banded_read(21, use_skip)
    score, path = dp_spec.banded_viterbi(x, mu, sigma, lo, cfg)
    assert len(mu) > cfg.band_width  # the band really cuts the reference
    assert np.isclose(dp_spec.path_score(x, mu, sigma, lo, path, cfg), score,
                      rtol=1e-12, atol=1e-9)
    if use_skip:  # non-vacuous: the skip transition is priced
        assert (np.diff(path) == 2).any()


@pytest.mark.parametrize("edit", ["shift_one_boundary", "leave_band",
                                  "step_back", "step_of_two_without_skip"])
def test_path_score_prices_other_paths_below_the_optimum(edit):
    """A legal detour scores lower than the optimum; a path the DP cannot
    produce scores NEG_INF."""
    x, mu, sigma, lo, cfg = _banded_read(22, False)
    score, path = dp_spec.banded_viterbi(x, mu, sigma, lo, cfg)
    alt = path.copy()
    t = int(np.nonzero(np.diff(path) == 1)[0][len(path) // 40]) + 1
    if edit == "shift_one_boundary":   # move one sample across a boundary
        alt[t] = path[t - 1]
        got = dp_spec.path_score(x, mu, sigma, lo, alt, cfg)
        assert dp_spec.NEG_INF < got < score
        return
    if edit == "leave_band":
        alt[t:] = np.maximum(alt[t:], lo[t:] + cfg.band_width)
    elif edit == "step_back":
        alt[t] = path[t] - 2
    else:  # one sample early to the next position: a step of 2, then 0
        t2 = t + int(np.argmax(np.diff(path[t:]) == 1)) + 1
        alt[t:t2] += 1
        assert np.all((alt >= lo) & (alt < lo + cfg.band_width))
    assert dp_spec.path_score(x, mu, sigma, lo, alt, cfg) == dp_spec.NEG_INF
