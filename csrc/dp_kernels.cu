// Hopper kernels for the device path: banded Viterbi fill, its backtrack,
// and the restricted local re-DP behind the SNP base likelihoods.
//
// Built by nadavca_tpu/ops/cuda_dp.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I <jax.ffi.include_dir()>
// and called through jax.ffi. Each handler only enqueues work on the stream
// XLA hands it.
//
// Fill: one warp per read. Lane l holds band slots j = l*Q + q (q < Q,
// B = 32*Q) of the DP column V in registers for the whole read, so V[j-1] is
// in-register except at q = 0, where one __shfl_up_sync brings the previous
// lane's last slot. The band start is constant within a 128-sample chunk
// (sched/bands.py) and jumps by delta >= 0 between chunks; that realignment
// goes through shared memory once per chunk. Stay/move decisions are packed
// 1 bit per cell with __ballot_sync: word q of step t holds, in bit l, the
// decision of slot l*Q + q. The column is renormalized once per chunk by a
// warp max-reduction (a per-read constant shift: argmax decisions are
// unchanged in exact arithmetic and carried values stay O(chunk)).
//
// The arithmetic mirrors the lax.scan backend (ops/banded_dp.py): the
// polynomial emission with the stay transition folded in, the folded
// transition compare, the free start at t = 0, and the skip transition as a
// second decision plane.

#include <cuda_runtime.h>

#include <cstdint>
#include <string>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kHalfLog2Pi = 0.918938533204672742f;
constexpr int kChunk = 128;          // samples per band chunk
constexpr int kReadsPerBlock = 4;    // one warp per read
constexpr unsigned kFull = 0xffffffffu;

// ------------------------------------------------------------------ fill
template <int Q, bool SKIP>
__global__ void __launch_bounds__(32 * kReadsPerBlock)
fill_kernel(const float* __restrict__ x, const int* __restrict__ t_len,
            const float* __restrict__ mu, const float* __restrict__ sigma,
            const int* __restrict__ n_ref, const int* __restrict__ lo,
            const int* __restrict__ delta, int R, int T, int N, int n_chunks,
            float log_p_stay, float log_p_move, float log_p_skip,
            uint32_t* __restrict__ bits, uint32_t* __restrict__ bits2,
            float* __restrict__ v_out, float* __restrict__ acc_out) {
  constexpr int B = 32 * Q;
  __shared__ float v_sh[kReadsPerBlock][B];
  __shared__ float x_sh[kReadsPerBlock][kChunk];
  const int w = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * kReadsPerBlock + w;
  if (r >= R) return;  // whole warp; no block-wide barrier below

  const int tl = t_len[r];
  const int nr = n_ref[r];
  const float* xr = x + static_cast<size_t>(r) * T;
  const float* mur = mu + static_cast<size_t>(r) * N;
  const float* sgr = sigma + static_cast<size_t>(r) * N;
  const float dcs = log_p_move - log_p_stay;

  float v[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) v[q] = kNegInf;
  float acc = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * kChunk;
    if (t0 >= tl) break;  // warp-uniform: the rest of the read is padding
    const int lo_c = lo[r * n_chunks + c];
    // cells just left of the new band (old slots d-1, d-2) feed the first
    // step's move/skip into slots 0 and 1
    float edge1 = kNegInf, edge2 = kNegInf;
    if (c > 0) {
      const int d = delta[r * n_chunks + c];
      if (d != 0) {
#pragma unroll
        for (int q = 0; q < Q; ++q) v_sh[w][lane * Q + q] = v[q];
        __syncwarp();
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int src = lane * Q + q + d;
          v[q] = src < B ? v_sh[w][src] : kNegInf;
        }
        if (d - 1 < B) edge1 = v_sh[w][d - 1];
        if (d >= 2 && d - 2 < B) edge2 = v_sh[w][d - 2];
        __syncwarp();
      }
    }

    float c0[Q], c1[Q], c2[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int pos = lo_c + lane * Q + q;
      const float m = pos < N ? mur[pos] : 0.f;
      const float s = pos < N ? sgr[pos] : 1.f;
      if (SKIP) {
        // the scan's Gaussian log-density, term for term:
        // -0.5 z^2 - log(sigma) - log(2 pi)/2 with z = (x - mu) / sigma
        c0[q] = pos < nr ? logf(s) : kNegInf;
        c1[q] = m;
        c2[q] = s;
      } else {
        const float inv2v = 0.5f / (s * s);
        const float em = pos < nr ? -logf(s) - kHalfLog2Pi : kNegInf;
        c2[q] = -inv2v;
        c1[q] = (m + m) * inv2v;
        c0[q] = em - m * m * inv2v + log_p_stay;
      }
    }
    for (int i = lane; i < kChunk; i += 32) x_sh[w][i] = xr[t0 + i];
    __syncwarp();

    const int s_end = min(kChunk, tl - t0);
    for (int s = 0; s < s_end; ++s) {
      const float xv = x_sh[w][s];
      const bool first = (c == 0 && s == 0);
      float up1 = __shfl_up_sync(kFull, v[Q - 1], 1);
      float up2 = SKIP ? __shfl_up_sync(kFull, v[Q - 2], 1) : kNegInf;
      if (lane == 0) {
        up1 = s == 0 ? edge1 : kNegInf;
        up2 = s == 0 ? edge2 : kNegInf;
      }
      float nv[Q];
      bool b1[Q], b2[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const float vm1 = q > 0 ? v[q - 1] : up1;
        if (SKIP) {
          const float vm2 = q > 1 ? v[q - 2] : (q == 1 ? up1 : up2);
          const float z = (xv - c1[q]) / c2[q];
          const float emit =
              c0[q] > kNegInf ? -0.5f * z * z - c0[q] - kHalfLog2Pi : kNegInf;
          const float stay = v[q] + log_p_stay;
          const float move = vm1 + log_p_move;
          bool mv = move > stay;
          float best = fmaxf(stay, move);
          const float skip = vm2 + log_p_skip;
          const bool sk = skip > best;
          mv = mv && !sk;
          best = fmaxf(best, skip);
          nv[q] = first ? emit : emit + best;
          b1[q] = mv && !first;
          b2[q] = sk && !first;
        } else {
          const float emit = (c2[q] * xv + c1[q]) * xv + c0[q];
          const float mv = vm1 + dcs;
          const float best = fmaxf(v[q], mv);
          nv[q] = first ? emit - log_p_stay : emit + best;
          b1[q] = (mv > v[q]) && !first;
          b2[q] = false;
        }
      }
      // lane q keeps word q, so one coalesced store writes the step's Q words
      unsigned mine = 0, mine2 = 0;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        v[q] = nv[q];
        const unsigned word = __ballot_sync(kFull, b1[q]);
        if (lane == q) mine = word;
        if (SKIP) {
          const unsigned word2 = __ballot_sync(kFull, b2[q]);
          if (lane == q) mine2 = word2;
        }
      }
      if (lane < Q) {
        const size_t base = (static_cast<size_t>(r) * T + t0 + s) * Q;
        bits[base + lane] = mine;
        if (SKIP) bits2[base + lane] = mine2;
      }
    }

    // chunk-end renormalization
    float m = v[0];
#pragma unroll
    for (int q = 1; q < Q; ++q) m = fmaxf(m, v[q]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    if (!(m > kNegInf / 2)) m = 0.f;
#pragma unroll
    for (int q = 0; q < Q; ++q) v[q] -= m;
    acc += m;
    __syncwarp();  // x_sh is rewritten by the next chunk
  }

#pragma unroll
  for (int q = 0; q < Q; ++q)
    v_out[static_cast<size_t>(r) * B + lane * Q + q] = v[q];
  if (lane == 0) acc_out[r] = acc;
}

// ------------------------------------------------------------- backtrack
// One warp per read walks the chunks from the end: the lanes stage the
// chunk's decision words in shared memory, lane 0 walks its 128 steps, and
// the lanes store the chunk's positions with coalesced writes. Decisions at
// t >= t_len are never read (the fill does not write them).
template <int Q, bool SKIP>
__global__ void __launch_bounds__(32 * kReadsPerBlock)
backtrack_kernel(const uint32_t* __restrict__ bits,
                 const uint32_t* __restrict__ bits2,
                 const int* __restrict__ lo, const int* __restrict__ delta,
                 const int* __restrict__ j_end, const int* __restrict__ t_len,
                 int R, int T, int n_chunks, int* __restrict__ path) {
  constexpr int B = 32 * Q;
  constexpr int W2 = SKIP ? kChunk * Q : 1;
  __shared__ uint32_t w_sh[kReadsPerBlock][kChunk * Q];
  __shared__ uint32_t w2_sh[kReadsPerBlock][W2];
  __shared__ int p_sh[kReadsPerBlock][kChunk];
  const int w = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * kReadsPerBlock + w;
  if (r >= R) return;

  const int tl = t_len[r];
  int j = j_end[r];
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * kChunk;
    const int lo_c = lo[r * n_chunks + c];
    const int d_c = delta[r * n_chunks + c];
    if (t0 < tl) {
      const size_t off = (static_cast<size_t>(r) * T + t0) * Q;
      for (int i = lane; i < kChunk * Q; i += 32) {
        w_sh[w][i] = bits[off + i];
        if (SKIP) w2_sh[w][i] = bits2[off + i];
      }
    }
    __syncwarp();
    if (lane == 0) {
      for (int s = kChunk - 1; s >= 0; --s) {
        const int t = t0 + s;
        p_sh[w][s] = lo_c + j;
        int adv = 0;
        if (t < tl && t > 0) {
          const int jj = min(max(j, 0), B - 1);
          const int idx = s * Q + jj % Q;
          adv = (w_sh[w][idx] >> (jj / Q)) & 1u;
          if (SKIP) adv += 2 * ((w2_sh[w][idx] >> (jj / Q)) & 1u);
        }
        j += (s == 0 ? d_c : 0) - adv;
      }
    }
    __syncwarp();
    for (int i = lane; i < kChunk; i += 32)
      path[static_cast<size_t>(r) * T + t0 + i] = p_sh[w][i];
    __syncwarp();
  }
}

// --------------------------------------------------------------- rescore
// Restricted local re-DP (ops/banded_dp.base_loglik_local_batch): one
// thread per (read, window base). Its K x 4 Viterbi states (K k-mer
// positions, 4 candidate bases) live in registers across the <= t_w
// samples the global path assigned to those positions; the substituted
// levels come from the 4^k-entry model table, which stays in L1/L2.
template <int K>
__global__ void rescore_kernel(const float* __restrict__ x,
                               const int* __restrict__ seg_s,
                               const int* __restrict__ seg_w,
                               const int* __restrict__ p_lo,
                               const int* __restrict__ kk_arr,
                               const int* __restrict__ codes,
                               const int* __restrict__ ids,
                               const float* __restrict__ lm,
                               const float* __restrict__ ls, int R, int T,
                               int L, int N, int n_levels, float log_p_stay,
                               float log_p_move, float* __restrict__ out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= R * L) return;
  const int r = idx / L;
  const int i = idx % L;
  const int wlen = seg_w[idx];
  const int kk = kk_arr[idx];
  const int ref = codes[idx];
  const int plo = p_lo[idx];
  float* o = out + static_cast<size_t>(idx) * 4;

  bool ok = kk > 0 && ref < 4 && wlen > 0;
  float mu[K][4], em[K][4], iv[K][4];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int p = plo + j;
    const int id = (ok && j < kk) ? ids[static_cast<size_t>(r) * N + p] : 0;
    if (j < kk && id < 0) ok = false;
    const int off = i - p;
    const int pw = (off >= 0 && off < K) ? (1 << (2 * (K - 1 - off))) : 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      int nid = id + (b - ref) * pw;
      nid = min(max(nid, 0), n_levels - 1);
      const float sg = ls[nid];
      mu[j][b] = lm[nid];
      iv[j][b] = 0.5f / (sg * sg);
      em[j][b] = j < kk ? -logf(sg) - kHalfLog2Pi : kNegInf;
    }
  }
  if (!ok) {
#pragma unroll
    for (int b = 0; b < 4; ++b) o[b] = 0.f;
    return;
  }

  float v[K][4];
  const float* xr = x + static_cast<size_t>(r) * T + seg_s[idx];
  for (int s = 0; s < wlen; ++s) {
    const float xv = xr[s];
#pragma unroll
    for (int j = K - 1; j >= 0; --j) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float d = xv - mu[j][b];
        const float e = em[j][b] - d * d * iv[j][b];
        if (s == 0) {
          v[j][b] = j == 0 ? e : kNegInf;
        } else {
          const float stay = v[j][b] + log_p_stay;
          const float move = (j > 0 ? v[j - 1][b] : kNegInf) + log_p_move;
          v[j][b] = e + fmaxf(stay, move);
        }
      }
    }
  }
  float sc[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    sc[b] = v[0][b];
#pragma unroll
    for (int j = 1; j < K; ++j)
      if (j == kk - 1) sc[b] = v[j][b];
  }
  float ref_sc = sc[0];
#pragma unroll
  for (int b = 1; b < 4; ++b)
    if (b == ref) ref_sc = sc[b];
#pragma unroll
  for (int b = 0; b < 4; ++b) o[b] = sc[b] - ref_sc;
}

ffi::Error launch_error(const char* what) {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string(what) + ": " +
                                cudaGetErrorString(err));
  return ffi::Error::Success();
}

// ------------------------------------------------------------- handlers
ffi::Error FillImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> x,
                    ffi::Buffer<ffi::S32> t_len, ffi::Buffer<ffi::F32> mu,
                    ffi::Buffer<ffi::F32> sigma, ffi::Buffer<ffi::S32> n_ref,
                    ffi::Buffer<ffi::S32> lo, ffi::Buffer<ffi::S32> delta,
                    float log_p_stay, float log_p_move, float log_p_skip,
                    ffi::ResultBuffer<ffi::U32> bits,
                    ffi::ResultBuffer<ffi::U32> bits2,
                    ffi::ResultBuffer<ffi::F32> v_out,
                    ffi::ResultBuffer<ffi::F32> acc_out) {
  const int R = static_cast<int>(x.dimensions()[0]);
  const int T = static_cast<int>(x.dimensions()[1]);
  const int N = static_cast<int>(mu.dimensions()[1]);
  const int n_chunks = static_cast<int>(lo.dimensions()[1]);
  const int Q = static_cast<int>(bits->dimensions()[2]);
  // bits2 is (R, T, Q) with skip and a (1, 1, 1) placeholder without
  const bool skip = bits2->element_count() > 1;
  if (T != n_chunks * kChunk)
    return ffi::Error::InvalidArgument("fill: T must be n_chunks * 128");
  if (R == 0) return ffi::Error::Success();
  const dim3 grid((R + kReadsPerBlock - 1) / kReadsPerBlock);
  const dim3 block(32 * kReadsPerBlock);
#define NADAVCA_FILL(QQ, SK)                                                 \
  fill_kernel<QQ, SK><<<grid, block, 0, stream>>>(                           \
      x.typed_data(), t_len.typed_data(), mu.typed_data(),                   \
      sigma.typed_data(), n_ref.typed_data(), lo.typed_data(),               \
      delta.typed_data(), R, T, N, n_chunks, log_p_stay, log_p_move,         \
      log_p_skip, bits->typed_data(), bits2->typed_data(),                   \
      v_out->typed_data(), acc_out->typed_data())
  if (Q == 4 && !skip) NADAVCA_FILL(4, false);
  else if (Q == 4 && skip) NADAVCA_FILL(4, true);
  else if (Q == 8 && !skip) NADAVCA_FILL(8, false);
  else if (Q == 8 && skip) NADAVCA_FILL(8, true);
  else return ffi::Error::InvalidArgument("fill: band width must be 128 or 256");
#undef NADAVCA_FILL
  return launch_error("viterbi fill");
}

ffi::Error BacktrackImpl(cudaStream_t stream, ffi::Buffer<ffi::U32> bits,
                         ffi::Buffer<ffi::U32> bits2,
                         ffi::Buffer<ffi::S32> lo, ffi::Buffer<ffi::S32> delta,
                         ffi::Buffer<ffi::S32> j_end,
                         ffi::Buffer<ffi::S32> t_len,
                         ffi::ResultBuffer<ffi::S32> path) {
  const int R = static_cast<int>(bits.dimensions()[0]);
  const int T = static_cast<int>(bits.dimensions()[1]);
  const int Q = static_cast<int>(bits.dimensions()[2]);
  const int n_chunks = static_cast<int>(lo.dimensions()[1]);
  const bool skip = bits2.element_count() > 1;
  if (T != n_chunks * kChunk)
    return ffi::Error::InvalidArgument("backtrack: T must be n_chunks * 128");
  if (R == 0) return ffi::Error::Success();
  const dim3 grid((R + kReadsPerBlock - 1) / kReadsPerBlock);
  const dim3 block(32 * kReadsPerBlock);
#define NADAVCA_BACK(QQ, SK)                                                 \
  backtrack_kernel<QQ, SK><<<grid, block, 0, stream>>>(                      \
      bits.typed_data(), bits2.typed_data(), lo.typed_data(),                \
      delta.typed_data(), j_end.typed_data(), t_len.typed_data(), R, T,      \
      n_chunks, path->typed_data())
  if (Q == 4 && !skip) NADAVCA_BACK(4, false);
  else if (Q == 4 && skip) NADAVCA_BACK(4, true);
  else if (Q == 8 && !skip) NADAVCA_BACK(8, false);
  else if (Q == 8 && skip) NADAVCA_BACK(8, true);
  else return ffi::Error::InvalidArgument("backtrack: band width must be 128 or 256");
#undef NADAVCA_BACK
  return launch_error("viterbi backtrack");
}

ffi::Error RescoreImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> x,
                       ffi::Buffer<ffi::S32> seg_s, ffi::Buffer<ffi::S32> seg_w,
                       ffi::Buffer<ffi::S32> p_lo, ffi::Buffer<ffi::S32> kk,
                       ffi::Buffer<ffi::S32> codes, ffi::Buffer<ffi::S32> ids,
                       ffi::Buffer<ffi::F32> lm, ffi::Buffer<ffi::F32> ls,
                       float log_p_stay, float log_p_move, int32_t k,
                       ffi::ResultBuffer<ffi::F32> out) {
  const int R = static_cast<int>(x.dimensions()[0]);
  const int T = static_cast<int>(x.dimensions()[1]);
  const int L = static_cast<int>(seg_s.dimensions()[1]);
  const int N = static_cast<int>(ids.dimensions()[1]);
  const int n_levels = static_cast<int>(lm.dimensions()[0]);
  if (R * L == 0) return ffi::Error::Success();
  const int threads = 128;
  const dim3 grid((R * L + threads - 1) / threads);
#define NADAVCA_RESCORE(KK)                                                  \
  rescore_kernel<KK><<<grid, threads, 0, stream>>>(                          \
      x.typed_data(), seg_s.typed_data(), seg_w.typed_data(),                \
      p_lo.typed_data(), kk.typed_data(), codes.typed_data(),                \
      ids.typed_data(), lm.typed_data(), ls.typed_data(), R, T, L, N,        \
      n_levels, log_p_stay, log_p_move, out->typed_data())
  switch (k) {
    case 4: NADAVCA_RESCORE(4); break;
    case 5: NADAVCA_RESCORE(5); break;
    case 6: NADAVCA_RESCORE(6); break;
    case 7: NADAVCA_RESCORE(7); break;
    case 8: NADAVCA_RESCORE(8); break;
    default: return ffi::Error::InvalidArgument("rescore: k must be in 4..8");
  }
#undef NADAVCA_RESCORE
  return launch_error("local rescore");
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(NadavcaViterbiFill, FillImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Attr<float>("log_p_stay")
                                  .Attr<float>("log_p_move")
                                  .Attr<float>("log_p_skip")
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>());

XLA_FFI_DEFINE_HANDLER_SYMBOL(NadavcaViterbiBacktrack, BacktrackImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>());

XLA_FFI_DEFINE_HANDLER_SYMBOL(NadavcaLocalRescore, RescoreImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Attr<float>("log_p_stay")
                                  .Attr<float>("log_p_move")
                                  .Attr<int32_t>("k")
                                  .Ret<ffi::Buffer<ffi::F32>>());
