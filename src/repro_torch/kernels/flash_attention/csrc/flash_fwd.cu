// Forward GQA attention with an online softmax, float32, for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_fwd :80, _flash_fwd_kernel :30, pallas_call :100): per
// (batch, query head) it computes softmax(softcap(q k^T / sqrt(hd)) + mask) v
// with a causal and an optional sliding-window mask, both position axes
// starting at 0, masked scores at -1e30 (never -inf, so no row gives NaN),
// f32 running max, sum and accumulator, and a final divide by max(l, 1e-30).
// Query head h reads KV head h / (H / KVH); no head is replicated.  When
// asked (lse not null), it also writes each row's log-sum-exp
// m + log(max(l, 1e-30)) as (B, H, S) float32, which the backward
// (flash_bwd.cu) recomputes the softmax from.
//
// What bounds it: at the serving shapes (qwen2-0.5b prefill: B 4, H 14,
// S = T = 512, hd 64) the work is ~4 S T hd / 2 float operations per head
// against 4 (2 S + 2 T) hd bytes, far above the float32 ridge, so the bound
// is the float32 FMA rate.  This first kernel runs on the CUDA cores in
// float32 (no wgmma, no TMA): correct and simple before fast.
//
// Design.  One CTA per (64-row query tile, query head, batch), 256 threads:
// four threads per query row, each owning hd/4 of the row's head dims, so
// q and the accumulator stay in registers at hd 128 (32 + 32 floats).  K/V
// tiles of 64 rows are staged in dynamic shared memory; a score is the
// four partial dot products summed with two xor-shuffles.  Each tile's
// scores go to shared memory, the running max and sum move once per tile,
// then p = exp(s - m) weighs the V rows.  Tiles wholly above the causal
// diagonal or wholly outside the window are skipped.  S and T need not be
// multiples of the tile: query rows past S write nothing, key rows past T
// get weight exactly 0 and are never read.  hd is a template parameter
// (16, 64, 80, 128: the slice's configs); the wrapper raises on any other.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BLOCK_Q = 64;
constexpr int BLOCK_K = 64;
constexpr int TPR = 4;                  // threads per query row
constexpr int THREADS = BLOCK_Q * TPR;  // 256
constexpr int S_LD = BLOCK_K + 1;       // padded score row: no bank conflicts
constexpr float MASKED = -1e30f;        // the reference's masked score

struct Strides {
  long long b, h, s;  // batch, head and sequence strides; head dims are contiguous
};

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * BLOCK_K * HD + BLOCK_Q * S_LD);
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, long long n_heads, long long group, long long S,
                 long long T, Strides qs, Strides ks, Strides vs, Strides os,
                 float scale, int causal, long long window, float softcap) {
  constexpr int DPT = HD / TPR;  // head dims per thread
  extern __shared__ float smem[];
  float* k_tile = smem;                   // [BLOCK_K][HD]
  float* v_tile = k_tile + BLOCK_K * HD;  // [BLOCK_K][HD]
  float* s_tile = v_tile + BLOCK_K * HD;  // [BLOCK_Q][S_LD]

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int lane = tid % TPR;
  const long long h = blockIdx.y;
  const long long b = blockIdx.z;
  const long long kvh = h / group;
  const long long q0 = static_cast<long long>(blockIdx.x) * BLOCK_Q;
  const long long qi = q0 + row;
  const bool live = qi < S;

  float qr[DPT], acc[DPT];
  const float* qp = q + b * qs.b + h * qs.h + qi * qs.s + lane * DPT;
#pragma unroll
  for (int d = 0; d < DPT; ++d) {
    qr[d] = live ? qp[d] : 0.f;
    acc[d] = 0.f;
  }
  float m = MASKED, l = 0.f;

  // keys any row of this tile can see
  long long k_lo = 0, k_hi = T;
  if (causal) k_hi = min(T, min(S, q0 + BLOCK_Q));
  if (window > 0) k_lo = max(0LL, q0 - window + 1);
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;

  for (long long k0 = (k_lo / BLOCK_K) * BLOCK_K; k0 < k_hi; k0 += BLOCK_K) {
    for (int i = tid; i < BLOCK_K * HD; i += THREADS) {
      const int r = i / HD, d = i % HD;
      const long long kp = k0 + r;
      const bool in = kp < T;
      k_tile[i] = in ? kb[kp * ks.s + d] : 0.f;
      v_tile[i] = in ? vb[kp * vs.s + d] : 0.f;
    }
    __syncthreads();

    float tile_max = MASKED;
    for (int j = 0; j < BLOCK_K; ++j) {
      const float* kr = k_tile + j * HD + lane * DPT;
      float part = 0.f;
#pragma unroll
      for (int d = 0; d < DPT; ++d) part += qr[d] * kr[d];
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const long long kp = k0 + j;
      float s;
      if (kp >= T) {
        s = -INFINITY;  // past the keys: weight exactly 0
      } else {
        s = part * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        bool ok = !causal || qi >= kp;
        if (window > 0) ok = ok && (qi - kp) < window;
        if (!ok) s = MASKED;
      }
      tile_max = fmaxf(tile_max, s);
      if (lane == 0) s_tile[row * S_LD + j] = s;
    }
    __syncwarp();

    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc[d] *= alpha;
    for (int j = 0; j < BLOCK_K; ++j) {
      const float p = expf(s_tile[row * S_LD + j] - m_new);
      l += p;
      const float* vr = v_tile + j * HD + lane * DPT;
#pragma unroll
      for (int d = 0; d < DPT; ++d) acc[d] += p * vr[d];
    }
    m = m_new;
    __syncthreads();  // the tiles are overwritten next
  }

  if (live) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    float* op = o + b * os.b + h * os.h + qi * os.s + lane * DPT;
#pragma unroll
    for (int d = 0; d < DPT; ++d) op[d] = acc[d] * inv;
    if (lse != nullptr && lane == 0) lse[(b * n_heads + h) * S + qi] = m + logf(fmaxf(l, 1e-30f));
  }
}

template <int HD>
cudaError_t launch(const float* q, const float* k, const float* v, float* o, float* lse,
                   long long B, long long H, long long KVH, long long S, long long T,
                   Strides qs, Strides ks, Strides vs, Strides os, float scale,
                   int causal, long long window, float softcap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((S + BLOCK_Q - 1) / BLOCK_Q),
                  static_cast<unsigned>(H), static_cast<unsigned>(B));
  flash_fwd_kernel<HD><<<grid, THREADS, smem, stream>>>(
      q, k, v, o, lse, H, H / KVH, S, T, qs, ks, vs, os, scale, causal, window, softcap);
  return cudaGetLastError();
}

}  // namespace

// q (B, H, S, hd), k and v (B, KVH, T, hd), o (B, H, S, hd), each given by
// its batch, head and sequence strides in elements (head dims contiguous);
// lse (B, H, S) contiguous, or null.  window <= 0: no window; softcap <= 0:
// no cap.  Returns a cudaError_t.
extern "C" int flash_fwd_f32(const float* q, const float* k, const float* v, float* o,
                             float* lse, long long B, long long H, long long KVH, long long S,
                             long long T, long long hd,
                             long long q_sb, long long q_sh, long long q_ss,
                             long long k_sb, long long k_sh, long long k_ss,
                             long long v_sb, long long v_sh, long long v_ss,
                             long long o_sb, long long o_sh, long long o_ss,
                             float scale, int causal, long long window, float softcap,
                             cudaStream_t stream) {
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_ss};
  switch (hd) {
    case 16:
      return launch<16>(q, k, v, o, lse, B, H, KVH, S, T, qs, ks, vs, os, scale, causal, window,
                        softcap, stream);
    case 64:
      return launch<64>(q, k, v, o, lse, B, H, KVH, S, T, qs, ks, vs, os, scale, causal, window,
                        softcap, stream);
    case 80:
      return launch<80>(q, k, v, o, lse, B, H, KVH, S, T, qs, ks, vs, os, scale, causal, window,
                        softcap, stream);
    case 128:
      return launch<128>(q, k, v, o, lse, B, H, KVH, S, T, qs, ks, vs, os, scale, causal, window,
                         softcap, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
