"""The cuda backend's contracts, on the CPU and (marked ``gpu``) on the card.

CUDA code has no interpret mode, so the CPU tests pin everything around the
custom calls: the decision bit layout, the plain-JAX fill/backtrack
references that stand in for the kernels (they must reproduce the lax.scan
path exactly), the wrapper's padding, backend selection, and that the
custom calls lower inside shard_map. The ``gpu`` tests run the compiled
kernels against those references; they skip without a GPU
(``NADAVCA_TEST_PLATFORM=gpu python -m pytest -m gpu tests/test_cuda_dp.py``).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nadavca_tpu.config import AlignConfig
from nadavca_tpu.genome import kmer_ids
from nadavca_tpu.io.simulator import random_genome, simulate_read
from nadavca_tpu.kmer_model import default_model
from nadavca_tpu.ops import banded_dp, cuda_dp
from nadavca_tpu.sched import build_chunked_bands

CASES = [(128, False), (256, False), (128, True), (256, True)]


def _cfg(band_width, use_skip):
    return AlignConfig(band_width=band_width, use_skip=use_skip,
                       log_p_skip=-4.6 if use_skip else -1e30)


def _batch(band_width, use_skip, lengths=(200, 350, 260, 150, 300), seed=5):
    rng = np.random.default_rng(seed)
    model = default_model()
    genome = random_genome(rng, length=3000)
    reads = [simulate_read(genome, "ref", model, rng, read_len=ln, strand=1,
                           mean_dwell=6.0,
                           skip_prob=0.05 if use_skip else 0.0)
             for ln in lengths]
    R = len(reads)
    T = 128 * ((max(len(r.signal) for r in reads) + 127) // 128)
    L = max(len(r.window_codes) for r in reads)
    N = L - model.k + 1
    b = dict(x=np.zeros((R, T), np.float32), t_len=np.zeros(R, np.int32),
             mu=np.zeros((R, N), np.float32), sigma=np.ones((R, N), np.float32),
             n_ref=np.zeros(R, np.int32), codes=np.full((R, L), 4, np.int32),
             ids=np.full((R, N), -1, np.int32))
    anchors = np.zeros((R, T))
    for r, rd in enumerate(reads):
        t = len(rd.signal)
        b["x"][r, :t] = rd.signal
        b["t_len"][r] = t
        m, s = model.expected_signal(rd.window_codes)
        b["mu"][r, :len(m)] = m
        b["sigma"][r, :len(m)] = s
        b["n_ref"][r] = len(m)
        b["codes"][r, :len(rd.window_codes)] = rd.window_codes
        b["ids"][r, :len(m)] = kmer_ids(rd.window_codes, model.k)
        anchors[r, :t] = rd.true_path
        anchors[r, t:] = rd.true_path[-1]
    bands = build_chunked_bands(anchors, b["t_len"], b["n_ref"], band_width,
                                128)
    b["lo"], b["delta"] = bands.lo, bands.delta
    b["lo_full"] = bands.expand(T)
    return {k: np.asarray(v) for k, v in b.items()}, model


def _chunked(b):
    return [jnp.asarray(b[k]) for k in
            ("x", "t_len", "mu", "sigma", "n_ref", "lo", "delta")]


def _scan(b, cfg):
    return banded_dp.banded_viterbi_batch(
        b["x"], b["t_len"], b["mu"], b["sigma"], b["n_ref"], b["lo_full"], cfg)


@pytest.mark.parametrize("band_width,use_skip", CASES)
def test_packed_scan_decisions_walk_to_scan_path(band_width, use_skip):
    """Scan decisions packed in the kernels' bit layout and walked by the
    plain-JAX backtrack reproduce the scan backend's path and score."""
    cfg = _cfg(band_width, use_skip)
    b, _ = _batch(band_width, use_skip)
    ref = _scan(b, cfg)
    out = cuda_dp.cuda_viterbi_batch(
        *_chunked(b), cfg, fill=cuda_dp.reference_fill,
        backtrack=cuda_dp.reference_backtrack)
    np.testing.assert_array_equal(np.asarray(out.path), np.asarray(ref.path))
    np.testing.assert_array_equal(np.asarray(out.score), np.asarray(ref.score))
    if use_skip:  # non-vacuous: the paths really advance by 2 somewhere
        assert (np.diff(np.asarray(ref.path), axis=1) == 2).any()


@pytest.mark.parametrize("band_width", [128, 256])
def test_bit_layout_slot_mapping(band_width):
    """Bit l of word q is slot l*Q + q — what one warp's ballots produce."""
    rng = np.random.default_rng(band_width)
    dec = rng.random((3, 5, band_width)) < 0.3
    bits = np.asarray(cuda_dp.pack_bits(jnp.asarray(dec)))
    q = band_width // 32
    assert bits.shape == (3, 5, q) and bits.dtype == np.uint32
    for j in (0, 1, q - 1, q, band_width - 1):
        lane, word = divmod(j, q)
        np.testing.assert_array_equal((bits[..., word] >> lane) & 1,
                                      dec[..., j])
        got = cuda_dp.unpack_bit(jnp.asarray(bits[:, 2]),
                                 jnp.full((3,), j, jnp.int32))
        np.testing.assert_array_equal(np.asarray(got), dec[:, 2, j])


@pytest.mark.parametrize("cut", [1, 37, 127])
def test_wrapper_pads_signal_to_chunks(cut):
    """T that is not a chunk multiple is padded for the kernels and the path
    is cut back to T; an odd read count needs no padding at all."""
    cfg = _cfg(128, False)
    b, _ = _batch(128, False, lengths=(200, 150, 180))
    T = b["x"].shape[1]
    t_max = int(b["t_len"].max())
    Tc = max(T - cut, t_max)
    seen = []

    def fill(x, *rest):
        seen.append(x.shape)
        return cuda_dp.reference_fill(x, *rest)

    args = _chunked(b)
    args[0] = args[0][:, :Tc]
    out = cuda_dp.cuda_viterbi_batch(*args, cfg, fill=fill,
                                     backtrack=cuda_dp.reference_backtrack)
    assert seen == [(3, T)]
    assert out.path.shape == (3, Tc)
    ref = _scan(b, cfg)
    np.testing.assert_array_equal(np.asarray(out.path),
                                  np.asarray(ref.path)[:, :Tc])


def test_reference_backtrack_ignores_bits_past_read_end():
    """The fill leaves decisions at t >= t_len unwritten; the walk must not
    read them."""
    cfg = _cfg(128, False)
    b, _ = _batch(128, False)
    bits, bits2, v_fin, acc = cuda_dp.reference_fill(*_chunked(b), cfg)
    T = b["x"].shape[1]
    garbage = jnp.asarray(np.arange(T)[None, :, None] >= b["t_len"][:, None, None])
    noisy = jnp.where(garbage, jnp.uint32(0xA5A5A5A5), bits)
    out = cuda_dp.cuda_viterbi_batch(
        *_chunked(b), cfg,
        fill=lambda *a: (noisy, bits2, v_fin, acc),
        backtrack=cuda_dp.reference_backtrack)
    np.testing.assert_array_equal(np.asarray(out.path),
                                  np.asarray(_scan(b, cfg).path))


@pytest.mark.parametrize("cfg_kw,k,covered", [
    ({}, 6, True),
    ({"band_width": 256}, 6, True),
    ({"band_width": 384}, 6, False),
    ({"signal_chunk": 64}, 6, False),
    ({}, 3, False),
])
def test_kernel_coverage(cfg_kw, k, covered):
    assert cuda_dp.covers(AlignConfig(**cfg_kw), k) is covered


def test_resolve_backend_on_cpu():
    from nadavca_tpu.pipeline import resolve_backend

    cfg = AlignConfig()
    assert resolve_backend(cfg) == "scan"
    assert resolve_backend(cfg, "scan") == "scan"
    with pytest.raises(RuntimeError, match="needs a GPU"):
        resolve_backend(cfg, "cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        resolve_backend(cfg, "pallas")


def test_kernels_refuse_to_run_off_gpu():
    with pytest.raises(RuntimeError, match="needs a GPU"):
        cuda_dp.ensure_registered()


def test_custom_calls_lower_inside_shard_map(monkeypatch):
    """The multi-device step wraps the cuda device_compute in shard_map
    unchanged: exported for CUDA, each custom call sees per-shard shapes."""
    from nadavca_tpu.parallel import sharded

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    monkeypatch.setattr(cuda_dp, "ensure_registered", lambda: None)
    cfg = AlignConfig()
    mesh = sharded.make_mesh(4, cfg.data_axis)
    R, T, N, L, G = 16, 256, 251, 256, 4096
    i32 = jnp.int32
    staged = dict(
        x=jnp.zeros((R, T)), t_len=jnp.ones(R, i32), mu=jnp.zeros((R, N)),
        sigma=jnp.ones((R, N)), n_ref=jnp.full(R, N, i32),
        lo=jnp.zeros((R, 2), i32), delta=jnp.zeros((R, 2), i32),
        codes=jnp.zeros((R, L), i32), ids=jnp.zeros((R, N), i32),
        lm=jnp.zeros(4096), ls=jnp.ones(4096))
    step = sharded.make_sharded_step(mesh, cfg, G, backend="cuda", k=6,
                                     with_path=False)
    acc, cov, votes = sharded.make_accumulators_sharded(mesh, cfg, G)
    w = jnp.zeros(R, i32)
    targets = list(cuda_dp._TARGETS)
    exp = jax.export.export(
        step, platforms=["cuda"],
        disabled_checks=[jax.export.DisabledSafetyCheck.custom_call(t)
                         for t in targets],
    )(sharded.shard_staged(mesh, cfg, staged), w, w, w, acc, cov, votes)
    text = exp.mlir_module()
    for t in targets:
        assert f"custom_call @{t}" in text, t
    assert "tensor<4x256xf32>" in text  # the per-device shard of x


# ------------------------------------------------------------ on the card
@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (NADAVCA_TEST_PLATFORM=gpu on the card)")


@pytest.mark.gpu
@pytest.mark.parametrize("band_width,use_skip", CASES)
def test_kernel_fill_and_backtrack_match_scan(gpu, band_width, use_skip):
    """Scores agree to float32 rounding. The kernel renormalizes per chunk
    and the scan per sample, so a near-tied decision can flip, moving a
    short run of samples: the share of live samples on the same position
    must be >= 0.999 over the batch and >= 0.99 for every read. That a
    flip is a near-tie is checked with the float64 oracle: the kernel's
    path gives up at most 0.05 of log-likelihood (float32 rounding over a
    read), where a wrong decision would give up its whole margin."""
    from nadavca_tpu.ops import dp_spec

    cfg = _cfg(band_width, use_skip)
    b, _ = _batch(band_width, use_skip)
    ref = _scan(b, cfg)
    out = jax.jit(lambda *a: cuda_dp.cuda_viterbi_batch(*a, cfg))(*_chunked(b))
    np.testing.assert_allclose(np.asarray(out.score), np.asarray(ref.score),
                               rtol=1e-5, atol=1e-2)
    live = np.arange(b["x"].shape[1])[None, :] < b["t_len"][:, None]
    path = np.asarray(out.path)
    same = path == np.asarray(ref.path)
    assert same[live].mean() >= 0.999, same[live].mean()
    for r in range(len(b["t_len"])):
        assert same[r][live[r]].mean() >= 0.99, r
        t, n = int(b["t_len"][r]), int(b["n_ref"][r])
        args64 = (b["x"][r, :t].astype(np.float64),
                  b["mu"][r, :n].astype(np.float64),
                  b["sigma"][r, :n].astype(np.float64), b["lo_full"][r, :t])
        best, _ = dp_spec.banded_viterbi(*args64, cfg)
        gap = best - dp_spec.path_score(*args64, path[r, :t], cfg)
        assert gap <= 0.05, (r, gap)


@pytest.mark.gpu
@pytest.mark.parametrize("band_width,use_skip", CASES)
def test_kernel_backtrack_matches_reference_walk(gpu, band_width, use_skip):
    """Both walks decode the same path from the same (kernel) bits."""
    cfg = _cfg(band_width, use_skip)
    b, _ = _batch(band_width, use_skip)
    args = _chunked(b)

    def both(*a):
        bits, bits2, v_fin, acc = cuda_dp.ffi_fill(*a, cfg)
        res = cuda_dp.cuda_viterbi_batch(*a, cfg)
        walk = cuda_dp.reference_backtrack(bits, bits2, a[5], a[6],
                                           res.final_j, a[1])
        return res.path, walk

    p_kernel, p_ref = jax.jit(both)(*args)
    np.testing.assert_array_equal(np.asarray(p_kernel), np.asarray(p_ref))


@pytest.mark.gpu
@pytest.mark.parametrize("use_skip", [False, True])
def test_kernel_rescore_matches_xla(gpu, use_skip):
    cfg = _cfg(128, use_skip)
    b, model = _batch(128, use_skip)
    path = _scan(b, cfg).path
    args = (jnp.asarray(b["x"]), path, jnp.asarray(b["t_len"]),
            jnp.asarray(b["codes"]), jnp.asarray(b["ids"]),
            jnp.asarray(model.level_mean), jnp.asarray(model.level_std),
            model.k, cfg)
    ref = banded_dp.base_loglik_local_batch(*args, t_w=cfg.snp_local_window)
    out = jax.jit(lambda *a: cuda_dp.cuda_local_rescore(
        *a, model.k, cfg, t_w=cfg.snp_local_window))(*args[:7])
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-4, atol=1e-2)
