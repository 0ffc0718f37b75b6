"""Hopper kernels for the banded Viterbi and the local rescore, via jax.ffi.

The CUDA source is csrc/dp_kernels.cu (its header describes the kernels).
This module builds it with nvcc for ``sm_90a`` at first use, registers the
three FFI targets, and wraps them as jittable functions with the contracts
of the lax.scan backend (ops/banded_dp.py):

  * :func:`cuda_viterbi_batch` — fill + backtrack, same result as
    ``banded_viterbi_batch`` on the expanded bands;
  * :func:`cuda_local_rescore` — same result as ``base_loglik_local_batch``.

Decision bit layout (shared by the fill, the backtrack and the plain-JAX
references below): ``bits[r, t, q]`` is a uint32 whose bit l is the
decision entering time t at band slot ``j = l * Q + q`` (Q = B / 32) — the
``__ballot_sync`` of one warp whose lane l holds slots l*Q .. l*Q + Q - 1.
Plane 1 (``bits``) marks a move (advance 1); plane 2 (``bits2``, present
only with cfg.use_skip) marks a skip (advance 2). Bits at t = 0 and at
t >= t_len carry no decision and are never read.

CUDA code has no interpret mode, so the arithmetic that surrounds the
custom calls (padding, layout, score/argmax) is written once and takes the
fill and backtrack as arguments: the CPU tests pass :func:`reference_fill`
and :func:`reference_backtrack`, plain JAX with the kernels' exact
contracts, where the GPU passes the FFI calls.
"""

from __future__ import annotations

import ctypes
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np

from ..config import AlignConfig
from . import banded_dp
from .banded_dp import NEG_INF, ViterbiResult

CHUNK = 128                  # samples per band chunk the kernels are built for
BAND_WIDTHS = (128, 256)     # one warp holds B/32 slots per lane: Q = 4 or 8
K_RANGE = range(4, 9)        # k-mer lengths the rescore kernel is built for

_SRC = os.path.join(os.path.dirname(__file__), "..", "..", "csrc",
                    "dp_kernels.cu")
_TARGETS = {
    "nadavca_viterbi_fill": "NadavcaViterbiFill",
    "nadavca_viterbi_backtrack": "NadavcaViterbiBacktrack",
    "nadavca_local_rescore": "NadavcaLocalRescore",
}
_LOCK = threading.Lock()
_LIB = None


def covers(cfg: AlignConfig, k: int) -> bool:
    """Whether the kernels implement this configuration.

    Band widths other than 128/256, another chunk size, or k outside 4..8
    run on the lax.scan backend (pipeline.resolve_backend).
    """
    return (cfg.band_width in BAND_WIDTHS and cfg.signal_chunk == CHUNK
            and k in K_RANGE)


def build_library() -> str:
    """Compile csrc/dp_kernels.cu for sm_90a (cached by content); path."""
    from ..utils.native_build import build_cuda_shared

    return build_cuda_shared(_SRC, "dp_kernels", [jax.ffi.include_dir()],
                             key=jax.__version__)


def ensure_registered() -> None:
    """Build, load and register the FFI targets; needs a GPU."""
    global _LIB
    if jax.default_backend() != "gpu":
        raise RuntimeError(
            "the cuda backend needs a GPU; JAX's default backend is "
            f"{jax.default_backend()!r} (use --backend scan)")
    with _LOCK:
        if _LIB is not None:
            return
        lib = ctypes.cdll.LoadLibrary(build_library())
        for target, symbol in _TARGETS.items():
            jax.ffi.register_ffi_target(
                target, jax.ffi.pycapsule(getattr(lib, symbol)),
                platform="CUDA")
        _LIB = lib


# ----------------------------------------------------------- bit layout
def pack_bits(b: jax.Array) -> jax.Array:
    """(R, T, B) bool → (R, T, B/32) uint32 in the kernels' layout."""
    R, T, B = b.shape
    q = B // 32
    lanes = b.reshape(R, T, 32, q).astype(jnp.uint32)      # slot l*Q + q
    shifts = jnp.arange(32, dtype=jnp.uint32)[None, None, :, None]
    return jnp.sum(lanes << shifts, axis=2, dtype=jnp.uint32)


def unpack_bit(bits: jax.Array, j: jax.Array) -> jax.Array:
    """bits (R, Q) words of one step, j (R,) slots → (R,) int32 bit."""
    q = bits.shape[1]
    word = jnp.take_along_axis(bits, (j % q)[:, None], axis=1)[:, 0]
    return ((word >> (j // q).astype(jnp.uint32)) & 1).astype(jnp.int32)


# ------------------------------------------------------ plain references
def reference_fill(x, t_len, mu, sigma, n_ref, lo, delta, cfg: AlignConfig):
    """The fill kernel's contract in plain JAX (the lax.scan fill, packed).

    Returns (bits, bits2, v_fin (R, B), acc (R,)); bits2 is a (1, 1, 1)
    placeholder without cfg.use_skip, as for the kernel.
    """
    T = x.shape[1]
    lo_full = jnp.repeat(lo, CHUNK, axis=1)[:, :T]
    v_fin, acc, decs = banded_dp.banded_viterbi_fill(
        x, t_len, mu, sigma, n_ref, lo_full, cfg)
    R, B = v_fin.shape
    dec = jnp.concatenate([jnp.zeros((1, R, B), decs.dtype), decs], axis=0)
    dec = jnp.transpose(dec, (1, 0, 2))                    # (R, T, B)
    bits = pack_bits(dec == banded_dp.DEC_MOVE)
    bits2 = (pack_bits(dec == banded_dp.DEC_SKIP) if cfg.use_skip
             else jnp.zeros((1, 1, 1), jnp.uint32))
    return bits, bits2, v_fin, acc


def reference_backtrack(bits, bits2, lo, delta, j_end, t_len):
    """The backtrack kernel's walk in plain JAX: one T-step lax.scan.

    j(t-1) = j(t) + d(t) - adv(t), with d(t) the chunk's band jump at
    t % CHUNK == 0 and adv read from the packed bits (0 at t >= t_len).
    Returns path (R, T) int32 = lo + j.
    """
    R, T, _ = bits.shape
    skip = bits2.shape[1] == T

    def step(j, t):
        adv = unpack_bit(jax.lax.dynamic_index_in_dim(bits, t, 1, False), j)
        if skip:
            adv = adv + 2 * unpack_bit(
                jax.lax.dynamic_index_in_dim(bits2, t, 1, False), j)
        adv = jnp.where(t < t_len, adv, 0)
        d = jnp.where(t % CHUNK == 0, delta[:, t // CHUNK], 0)
        j_prev = j + d - adv
        return j_prev, lo[:, (t - 1) // CHUNK] + j_prev

    _, pos_rev = jax.lax.scan(step, j_end.astype(jnp.int32),
                              jnp.arange(T - 1, 0, -1))
    path_body = jnp.flip(pos_rev, axis=0).T                 # t = 0 .. T-2
    pos_last = (lo[:, -1] + j_end)[:, None]
    return jnp.concatenate([path_body, pos_last], axis=1).astype(jnp.int32)


# ------------------------------------------------------------ FFI calls
def ffi_fill(x, t_len, mu, sigma, n_ref, lo, delta, cfg: AlignConfig):
    ensure_registered()
    R, T = x.shape
    B = cfg.band_width
    q = B // 32
    planes = (R, T, q) if cfg.use_skip else (1, 1, 1)
    return jax.ffi.ffi_call("nadavca_viterbi_fill", (
        jax.ShapeDtypeStruct((R, T, q), jnp.uint32),
        jax.ShapeDtypeStruct(planes, jnp.uint32),
        jax.ShapeDtypeStruct((R, B), jnp.float32),
        jax.ShapeDtypeStruct((R,), jnp.float32),
    ))(x, t_len, mu, sigma, n_ref, lo, delta,
       log_p_stay=np.float32(cfg.log_p_stay),
       log_p_move=np.float32(cfg.log_p_move),
       log_p_skip=np.float32(cfg.log_p_skip))


def ffi_backtrack(bits, bits2, lo, delta, j_end, t_len):
    ensure_registered()
    R, T, _ = bits.shape
    return jax.ffi.ffi_call(
        "nadavca_viterbi_backtrack",
        jax.ShapeDtypeStruct((R, T), jnp.int32),
    )(bits, bits2, lo, delta, j_end, t_len)


# -------------------------------------------------------------- wrappers
def cuda_viterbi_batch(x, t_len, mu, sigma, n_ref, lo, delta,
                       cfg: AlignConfig, fill=ffi_fill,
                       backtrack=ffi_backtrack) -> ViterbiResult:
    """Fill + backtrack on chunked bands; banded_viterbi_batch's contract.

    lo/delta are the (R, n_chunks) chunked bands. T is padded to
    n_chunks * CHUNK for the kernels (padding samples are past t_len) and
    the path is cut back to T. ``fill``/``backtrack`` default to the custom
    calls; the CPU tests pass the plain references.
    """
    R, T = x.shape
    n_chunks = lo.shape[1]
    Tp = n_chunks * CHUNK
    if Tp < T:
        raise ValueError(f"bands cover {Tp} samples, signal has {T}")
    i32 = jnp.int32
    x_p = jnp.pad(x.astype(jnp.float32), ((0, 0), (0, Tp - T)))
    lo = lo.astype(i32)
    delta = delta.astype(i32)
    t_len = t_len.astype(i32)
    n_ref = n_ref.astype(i32)
    bits, bits2, v_fin, acc = fill(
        x_p, t_len, mu.astype(jnp.float32), sigma.astype(jnp.float32),
        n_ref, lo, delta, cfg)
    lane = jnp.arange(cfg.band_width, dtype=i32)[None, :]
    i_fin = lo[:, -1][:, None] + lane
    v_valid = jnp.where(i_fin < n_ref[:, None], v_fin, NEG_INF)
    j_end = jnp.argmax(v_valid, axis=1).astype(i32)
    score = acc + jnp.take_along_axis(v_valid, j_end[:, None], axis=1)[:, 0]
    path = backtrack(bits, bits2, lo, delta, j_end, t_len)
    return ViterbiResult(score=score, path=path[:, :T], final_j=j_end)


def cuda_local_rescore(x, path, t_len, window_codes, ids, level_mean,
                       level_std, k: int, cfg: AlignConfig, t_w: int = 192):
    """(R, L, 4) base log-likelihoods; base_loglik_local_batch's contract."""
    ensure_registered()
    R, L = window_codes.shape
    N = ids.shape[1]
    S, W, p_lo, kk = banded_dp.local_segments(path, t_len, L, N, k, t_w)
    i32 = jnp.int32
    return jax.ffi.ffi_call(
        "nadavca_local_rescore",
        jax.ShapeDtypeStruct((R, L, 4), jnp.float32),
    )(x.astype(jnp.float32), S, W, p_lo, kk, window_codes.astype(i32),
      ids.astype(i32), level_mean.astype(jnp.float32),
      level_std.astype(jnp.float32),
      log_p_stay=np.float32(cfg.log_p_stay),
      log_p_move=np.float32(cfg.log_p_move), k=np.int32(k))
