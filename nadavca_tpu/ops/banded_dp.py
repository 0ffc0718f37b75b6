"""Batched banded Viterbi in pure JAX (lax.scan) — the portable device path.

This is the jittable, any-backend implementation of the DP specified in
ops/dp_spec.py (which is the float64 oracle; see SURVEY.md §3.4). It processes
a padded batch of reads at once:

  * scan over the signal axis t (sequential — the DP recurrence),
  * vectorized over reads (batch) and band slots — the same parallel
    structure the CUDA fill kernel (ops/cuda_dp.py) maps onto one warp per
    read,
  * running per-step renormalization so float32 stays exact enough for
    call-level parity (SURVEY.md §7.3 item 1): subtracting a per-read
    constant per step leaves every argmax decision unchanged in exact
    arithmetic while keeping carried values O(1).

It runs on the CPU (tests) and for configurations the CUDA kernels do not
cover (pipeline.resolve_backend), and it is the reference those kernels are
checked against.

Shapes (R = reads in batch, T = padded signal length, B = band width,
N = padded reference window length in k-mer positions):
  x        (R, T)  float32   normalized signal, zero-padded
  t_len    (R,)    int32     true signal lengths
  mu,sigma (R, N)  float32   expected levels, padded
  n_ref    (R,)    int32     true window lengths (k-mer positions)
  lo       (R, T)  int32     band start per sample; nondecreasing; padded by
                             repeating the final value (so padding steps are
                             identity in both fill and backtrack)

Masking contract (tested): a read's results are bit-identical whether it runs
alone or padded inside any batch (SURVEY.md §4 item 3).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import AlignConfig

NEG_INF = -1e30
_HALF_LOG_2PI = 0.5 * float(np.log(2.0 * np.pi))

DEC_STAY = 0
DEC_MOVE = 1
DEC_SKIP = 2
DEC_START = 3


class ViterbiResult(NamedTuple):
    score: jax.Array      # (R,) float32 best final log-likelihood
    path: jax.Array       # (R, T) int32 reference k-mer position per sample
    final_j: jax.Array    # (R,) int32 argmax band slot at the end (debug)


def gaussian_logpdf(x, mu, sigma):
    z = (x - mu) / sigma
    return -0.5 * z * z - jnp.log(sigma) - _HALF_LOG_2PI


def _band_gather(arr, idx, fill):
    """arr (R, N) gathered at idx (R, B); out-of-range -> fill."""
    n = arr.shape[1]
    ok = (idx >= 0) & (idx < n)
    safe = jnp.clip(idx, 0, n - 1)
    return jnp.where(ok, jnp.take_along_axis(arr, safe, axis=1), fill)


def banded_viterbi_fill(x, t_len, mu, sigma, n_ref, lo,
                        cfg: AlignConfig, pin_start: bool = False):
    """The DP fill alone: (V_fin (R, B), acc (R,), decs (T-1, R, B) int8).

    ``decs[t-1]`` holds the decision entering time t per band slot
    (DEC_STAY/DEC_MOVE/DEC_SKIP, DEC_START where no predecessor exists,
    DEC_STAY on padding steps); V_fin + acc is the final column's score.
    """
    R, T = x.shape
    B = cfg.band_width
    j_idx = jnp.arange(B, dtype=jnp.int32)[None, :]  # (1, B)

    trans = [cfg.log_p_stay, cfg.log_p_move] + ([cfg.log_p_skip] if cfg.use_skip else [])
    n_trans = len(trans)
    trans_arr = jnp.asarray(trans, dtype=jnp.float32)

    def emit_at(t):
        i = lo[:, t][:, None] + j_idx  # (R, B) absolute positions
        m = _band_gather(mu, i, 0.0)
        s = _band_gather(sigma, i, 1.0)
        valid = i < n_ref[:, None]
        if cfg.use_skip:
            e = gaussian_logpdf(x[:, t][:, None], m, s)
            return jnp.where(valid, e, NEG_INF)
        # polynomial emission with the stay transition folded in — the
        # expression the CUDA fill (csrc/dp_kernels.cu) evaluates, so both
        # backends round alike. Returns e + log_p_stay; the t=0 free start
        # subtracts it back.
        inv2v = 0.5 / (s * s)
        em_const = jnp.where(valid, -jnp.log(s) - _HALF_LOG_2PI, NEG_INF)
        c2p = -inv2v
        c1p = (m + m) * inv2v
        c0p = em_const - m * m * inv2v + cfg.log_p_stay
        xc = x[:, t][:, None]
        return (c2p * xc + c1p) * xc + c0p

    # t = 0: free start anywhere in the band (or pinned to position 0)
    V0 = emit_at(0) if cfg.use_skip else emit_at(0) - cfg.log_p_stay
    if pin_start:
        i0 = lo[:, 0][:, None] + j_idx
        V0 = jnp.where(i0 == 0, V0, NEG_INF)
    m0 = jnp.max(V0, axis=1)
    m0 = jnp.where(m0 > NEG_INF / 2, m0, 0.0)
    V0 = V0 - m0[:, None]

    dcs = cfg.log_p_move - cfg.log_p_stay

    def step(carry, t):
        V, acc = carry  # V (R, B) renormalized; acc (R,) running offset
        d = (lo[:, t] - lo[:, t - 1])[:, None]  # (R, 1)

        def shifted(adv):
            jp = j_idx + d - adv  # (R, B) source band slot at t-1
            return _band_gather(V, jp, NEG_INF)

        if cfg.use_skip:
            cands = jnp.stack(
                [shifted(adv) + trans_arr[adv] for adv in range(n_trans)],
                axis=0
            )  # (n_trans, R, B)
            best = jnp.argmax(cands, axis=0).astype(jnp.int8)
            best_val = jnp.max(cands, axis=0)
        else:
            # folded-transition compare (the CUDA fill's expression)
            v0 = shifted(0)
            mv = shifted(1) + dcs
            best = (mv > v0).astype(jnp.int8)
            best_val = jnp.maximum(v0, mv)
        has_pred = best_val > NEG_INF / 2
        V_new = jnp.where(has_pred, emit_at(t) + best_val, NEG_INF)
        dec = jnp.where(has_pred, best, jnp.int8(DEC_START))

        m = jnp.maximum(jnp.max(V_new, axis=1), NEG_INF)  # (R,)
        # only renormalize when the row has any finite cell
        m = jnp.where(m > NEG_INF / 2, m, 0.0)
        V_new = V_new - m[:, None]
        acc_new = acc + m

        active = (t < t_len)[:, None]  # (R, 1) padding steps are identity
        V_out = jnp.where(active, V_new, V)
        acc_out = jnp.where(active[:, 0], acc_new, acc)
        dec_out = jnp.where(active, dec, jnp.int8(DEC_STAY))
        return (V_out, acc_out), dec_out

    (V_fin, acc_fin), decs = jax.lax.scan(step, (V0, m0), jnp.arange(1, T))
    return V_fin, acc_fin, decs


@functools.partial(jax.jit, static_argnames=("cfg", "pin_start", "pin_end"))
def banded_viterbi_batch(
    x: jax.Array,
    t_len: jax.Array,
    mu: jax.Array,
    sigma: jax.Array,
    n_ref: jax.Array,
    lo: jax.Array,
    cfg: AlignConfig = AlignConfig(),
    pin_start: bool = False,
    pin_end: bool = False,
) -> ViterbiResult:
    """Fill + backtrack of the banded Viterbi over a padded batch.

    ``pin_start``/``pin_end`` constrain the alignment to begin at reference
    position 0 / end at position n_ref-1 instead of floating freely within
    the band. The joint rescore pass (nadavca_tpu.joint) pins both: with
    free endpoints a whole-slice shift is nearly free, so adjacent-position
    hypotheses score almost identically — the very ambiguity the pass
    exists to break. Default off: the production aligner wants free ends
    (reads enter/leave the window mid-signal).
    """
    T = x.shape[1]
    B = cfg.band_width
    j_idx = jnp.arange(B, dtype=jnp.int32)[None, :]
    V_fin, acc_fin, decs = banded_viterbi_fill(
        x, t_len, mu, sigma, n_ref, lo, cfg, pin_start=pin_start)

    i_fin = lo[:, T - 1][:, None] + j_idx
    V_valid = jnp.where(i_fin < n_ref[:, None], V_fin, NEG_INF)
    if pin_end:
        V_valid = jnp.where(i_fin == (n_ref - 1)[:, None], V_valid, NEG_INF)
    j_end = jnp.argmax(V_valid, axis=1).astype(jnp.int32)
    score = acc_fin + jnp.take_along_axis(V_valid, j_end[:, None], axis=1)[:, 0]

    # ------------------------------------------------------------- backtrack
    def back_step(j, t):
        # j (R,) band slot at time t; produce slot at t-1 and position there
        dec_t = decs[t - 1]  # (R, B) decisions taken entering time t
        adv = jnp.take_along_axis(dec_t, j[:, None], axis=1)[:, 0].astype(jnp.int32)
        adv = jnp.where(adv == DEC_START, 0, adv)
        d = lo[:, t] - lo[:, t - 1]
        j_prev = j + d - adv
        return j_prev, lo[:, t - 1] + j_prev

    def back_scan(j, t):
        j_prev, pos_prev = back_step(j, t)
        return j_prev, pos_prev

    _, path_rev = jax.lax.scan(back_scan, j_end, jnp.arange(T - 1, 0, -1))
    # path_rev: (T-1, R) positions at t = T-2 .. 0
    path_body = jnp.flip(path_rev, axis=0).T  # (R, T-1) positions 0..T-2
    pos_last = (lo[:, T - 1] + j_end)[:, None]
    path = jnp.concatenate([path_body, pos_last], axis=1).astype(jnp.int32)
    return ViterbiResult(score=score, path=path, final_j=j_end)


@functools.partial(jax.jit, static_argnames=("n_ref_max",))
def segment_stats_batch(
    path: jax.Array, x: jax.Array, t_len: jax.Array, n_ref_max: int
) -> jax.Array:
    """Per-position sufficient statistics (n, Σx, Σx²) — (R, N, 3) float32.

    Samples beyond each read's true length contribute nothing. This is the
    fused-XLA replacement for the reference's per-position bookkeeping; the
    closed-form rescore in :func:`base_loglik_batch` consumes it.
    """
    R, T = x.shape
    t_mask = jnp.arange(T)[None, :] < t_len[:, None]
    w = t_mask.astype(x.dtype)

    def one(p, xi, wi):
        n = jax.ops.segment_sum(wi, p, num_segments=n_ref_max)
        s1 = jax.ops.segment_sum(wi * xi, p, num_segments=n_ref_max)
        s2 = jax.ops.segment_sum(wi * xi * xi, p, num_segments=n_ref_max)
        return jnp.stack([n, s1, s2], axis=-1)

    return jax.vmap(one)(path, x, w)


def gaussian_segment_loglik(stats, mu, sigma):
    n, s1, s2 = stats[..., 0], stats[..., 1], stats[..., 2]
    return -n * (jnp.log(sigma) + _HALF_LOG_2PI) - (
        s2 - 2.0 * mu * s1 + n * mu * mu
    ) / (2.0 * sigma * sigma)


@functools.partial(jax.jit, static_argnames=("k",))
def base_loglik_batch(
    window_codes: jax.Array,   # (R, L) int32 encoded bases (4 = pad/N)
    ids: jax.Array,            # (R, N) int32 kmer ids (-1 invalid), N = L-k+1
    stats: jax.Array,          # (R, N, 3) float32
    level_mean: jax.Array,     # (4^k,) float32
    level_std: jax.Array,      # (4^k,) float32
    k: int,
) -> jax.Array:
    """(R, L, 4) per-position per-base log-likelihoods, ref base = 0.

    Fixed-path rescoring as fused elementwise ops + table gathers: for base
    position i and candidate base b, the k k-mers overlapping i are re-scored
    in closed form from the segment statistics (SURVEY.md §7.3 item 5 — the 4
    substitutions ride a minor axis and vectorize on the VPU).
    """
    R, L = window_codes.shape
    N = ids.shape[1]
    valid_id = ids >= 0
    safe_ids = jnp.where(valid_id, ids, 0)
    cur_ll = gaussian_segment_loglik(
        stats, level_mean[safe_ids], level_std[safe_ids]
    )
    cur_ll = jnp.where(valid_id, cur_ll, 0.0)

    ref_base = window_codes  # (R, L)
    out = jnp.zeros((R, L, 4), dtype=jnp.float32)

    # offset o: base i sits at offset o of the kmer starting at p = i - o
    for o in range(k):
        pow4 = 4 ** (k - 1 - o)
        p = jnp.arange(L)[None, :] - o  # (1, L) kmer position index
        p_ok = (p >= 0) & (p < N)
        p_safe = jnp.clip(p, 0, N - 1)
        p_safe_b = jnp.broadcast_to(p_safe, (R, L))
        ids_p = jnp.take_along_axis(safe_ids, p_safe_b, axis=1)      # (R, L)
        ok = p_ok & jnp.take_along_axis(valid_id, p_safe_b, axis=1) & (ref_base < 4)
        stats_p = jnp.take_along_axis(
            stats, p_safe_b[..., None], axis=1
        )  # (R, L, 3)
        cur_p = jnp.take_along_axis(cur_ll, p_safe_b, axis=1)        # (R, L)
        for b in range(4):
            new_id = ids_p + (b - ref_base) * pow4
            new_id = jnp.clip(new_id, 0, level_mean.shape[0] - 1)
            ll = gaussian_segment_loglik(
                stats_p, level_mean[new_id], level_std[new_id]
            )
            delta = jnp.where(ok & (ref_base != b), ll - cur_p, 0.0)
            out = out.at[:, :, b].add(delta)
    return out


# ---------------------------------------------------------------- host-side
def make_band_batch(
    anchors: np.ndarray, t_len: np.ndarray, n_ref: np.ndarray, band_width: int
) -> np.ndarray:
    """Vectorized numpy band construction for a padded batch.

    anchors (R, T) float: approximate k-mer position per sample (padding
    repeated). Matches dp_spec.make_band per row; padding rows repeat the last
    valid lo so padded scan steps are identity.
    """
    R, T = anchors.shape
    B = band_width
    lo = np.round(anchors).astype(np.int64) - B // 2
    hi_clip = np.maximum(n_ref - B, 0)[:, None]
    lo = np.clip(lo, 0, hi_clip)
    lo = np.maximum.accumulate(lo, axis=1)
    # freeze lo beyond each read's end at its final valid value
    idx = np.minimum(np.arange(T)[None, :], np.maximum(t_len - 1, 0)[:, None])
    lo = np.take_along_axis(lo, idx, axis=1)
    return lo.astype(np.int32)


def local_segments(path, t_len, L: int, N: int, k: int, t_w: int):
    """Per window base i, the samples its local re-DP scores: (S, W, p_lo, kk).

    The k-mer positions overlapping base i are p_lo .. p_lo + kk - 1
    (clipped to the part of the window the path covers); the global path
    assigned them samples S .. S + W - 1, with W truncated at t_w. All four
    are (R, L) int32. Shared by the XLA re-DP below and the CUDA kernel
    (ops/cuda_dp.py), so both score the same samples.
    """
    T = path.shape[1]
    tmask = jnp.arange(T)[None, :] < t_len[:, None]
    path_safe = jnp.where(tmask, path, N)  # padding samples -> overflow segment

    # segment bounds from the monotone path by bisection: cnt[i] = #{t :
    # path[t] < i}, so S = cnt[p_lo], E = cnt[p_hi + 1]. This stays correct
    # when the path skips positions (cfg.use_skip): a skipped position
    # contributes no samples but the bounds of the surrounding visited
    # positions are exact.
    pos_all = jnp.arange(N + 1, dtype=jnp.int32)
    cnt = jax.vmap(
        lambda p: jnp.searchsorted(p, pos_all, side="left")
    )(path_safe).astype(jnp.int32)                           # (R, N + 1)

    first_pos = path[:, 0]                                   # (R,)
    last_t = jnp.maximum(t_len - 1, 0)
    last_pos = jnp.take_along_axis(path, last_t[:, None], axis=1)[:, 0]

    i_idx = jnp.arange(L, dtype=jnp.int32)[None, :]          # (1, L)
    p_lo = jnp.clip(i_idx - k + 1, 0, N - 1)
    p_hi = jnp.clip(i_idx, 0, N - 1)
    p_lo = jnp.maximum(p_lo, first_pos[:, None])             # (R, L)
    p_hi = jnp.minimum(p_hi, last_pos[:, None])
    kk = p_hi - p_lo + 1                                     # (R, L) positions in window

    S = jnp.take_along_axis(cnt, jnp.clip(p_lo, 0, N), axis=1)       # (R, L)
    E = jnp.take_along_axis(cnt, jnp.clip(p_hi + 1, 0, N), axis=1)
    W = jnp.clip(E - S, 0, t_w)
    return S, W, p_lo.astype(jnp.int32), kk.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("k", "t_w", "cfg"))
def base_loglik_local_batch(
    x: jax.Array,             # (R, T) f32
    path: jax.Array,          # (R, T) i32 — global Viterbi path
    t_len: jax.Array,         # (R,) i32
    window_codes: jax.Array,  # (R, L) i32 (4 = pad/N)
    ids: jax.Array,           # (R, N) i32 kmer ids (-1 invalid)
    level_mean: jax.Array,    # (4^k,) f32
    level_std: jax.Array,     # (4^k,) f32
    k: int,
    cfg: AlignConfig = AlignConfig(),
    t_w: int = 192,
) -> jax.Array:
    """(R, L, 4) base log-likelihoods via restricted local re-DP (batched).

    Vectorized form of dp_spec.base_substitution_loglik_local — the
    reference's second hot loop rebuilt as fused XLA: for every (read, base
    position, candidate base) a tiny Viterbi over the ≤k affected k-mer
    positions re-optimizes the local path, over the samples the global path
    assigned to those positions (truncated at t_w samples; the truncation
    drops the same evidence for every base so deltas stay comparable).
    """
    R, T = x.shape
    L = window_codes.shape[1]
    N = ids.shape[1]
    S, W, p_lo, kk = local_segments(path, t_len, L, N, k, t_w)
    i_idx = jnp.arange(L, dtype=jnp.int32)[None, :]          # (1, L)
    valid_i = (kk > 0) & (window_codes < 4)

    # gather sample windows: xs[r, i, s] = x[r, S[r,i] + s]
    samp = S[:, :, None] + jnp.arange(t_w, dtype=jnp.int32)[None, None, :]
    samp_ok = jnp.arange(t_w)[None, None, :] < W[:, :, None]
    samp_safe = jnp.clip(samp, 0, T - 1)
    xs = jnp.take_along_axis(
        x[:, None, :], samp_safe.reshape(R, L * t_w)[:, None, :], axis=2
    ).reshape(R, L, t_w)

    # substituted levels: for j in 0..k-1 at position p = p_lo + j
    j_idx = jnp.arange(k, dtype=jnp.int32)[None, None, :]    # (1, 1, k)
    p = p_lo[:, :, None] + j_idx                             # (R, L, k)
    j_ok = j_idx < kk[:, :, None]
    p_safe = jnp.clip(p, 0, N - 1)
    ids_p = jnp.take_along_axis(
        ids[:, None, :].repeat(1, axis=1), p_safe.reshape(R, L * k)[:, None, :], axis=2
    ).reshape(R, L, k)
    ids_ok = ids_p >= 0
    ref_base = window_codes                                   # (R, L)
    off = i_idx[:, :, None] - p                               # (R, L, k)
    inside = (off >= 0) & (off < k)
    pow4 = jnp.asarray([4 ** (k - 1 - o) for o in range(k)], jnp.int32)
    w4 = jnp.where(inside, pow4[jnp.clip(off, 0, k - 1)], 0)
    b_idx = jnp.arange(4, dtype=jnp.int32)[None, None, None, :]   # (1,1,1,4)
    nid = ids_p[..., None] + (b_idx - ref_base[:, :, None, None]) * w4[..., None]
    nid = jnp.clip(nid, 0, level_mean.shape[0] - 1)               # (R, L, k, 4)
    mu_s = level_mean[nid]
    sg_s = level_std[nid]
    em_const = -jnp.log(sg_s) - _HALF_LOG_2PI                     # (R, L, k, 4)
    inv2v = 0.5 / (sg_s * sg_s)
    pos_dead = ~(j_ok & ids_ok)                                   # (R, L, k)
    em_const = jnp.where(pos_dead[..., None], NEG_INF, em_const)

    # restricted Viterbi: state (R, L, k, 4), scan over local samples
    neg = jnp.full((R, L, 1, 4), NEG_INF, jnp.float32)

    def step(v, s):
        xcol = jax.lax.dynamic_index_in_dim(xs, s, axis=2, keepdims=True)  # (R,L,1)
        d = xcol[..., None] - mu_s                                 # (R, L, k, 4)
        emit = em_const - d * d * inv2v
        stay = v + cfg.log_p_stay
        move = jnp.concatenate([neg, v[:, :, :-1, :]], axis=2) + cfg.log_p_move
        v_new = emit + jnp.maximum(stay, move)
        first = s == 0
        init = jnp.where(j_idx[..., None] == 0, emit, NEG_INF)
        v_new = jnp.where(first, init, v_new)
        act = (s < W)[:, :, None, None]
        return jnp.where(act, v_new, v), None

    v0 = jnp.full((R, L, k, 4), NEG_INF, jnp.float32)
    v_fin, _ = jax.lax.scan(step, v0, jnp.arange(t_w, dtype=jnp.int32))

    score = jnp.take_along_axis(
        v_fin, jnp.clip(kk - 1, 0, k - 1)[:, :, None, None].astype(jnp.int32), axis=2
    )[:, :, 0, :]                                              # (R, L, 4)
    ref_score = jnp.take_along_axis(
        score, jnp.clip(ref_base, 0, 3)[:, :, None].astype(jnp.int32), axis=2
    )
    out = score - ref_score
    all_ok = valid_i & (W > 0) & jnp.all(jnp.where(j_ok, ids_ok, True), axis=2)
    return jnp.where(all_ok[:, :, None], out, 0.0).astype(jnp.float32)
