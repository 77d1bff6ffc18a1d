// Backward of the forward GQA attention (flash_fwd.cu), float32, for sm_90a:
// the FlashAttention-2 backward on the CUDA cores.
//
// The reference has no backward kernel: its models differentiate the XLA
// chunked attention (src/repro/models/attention.py, chunked_attention :72),
// the oracle of its Pallas forward (src/repro/kernels/flash_attention/
// kernel.py, pallas_call :100).  This is the gradient of that function for
// the port's B.6: with the forward's row log-sum-exp lse_i (written by
// flash_fwd.cu), for every visible (query i, key j) pair of a head
//
//   raw  = q_i . k_j / sqrt(hd)
//   s    = raw                     or  c tanh(raw / c)   (softcap c)
//   P    = exp(s - lse_i)          (the forward's softmax, recomputed)
//   dV_j += P dO_i
//   dS   = P (dO_i . v_j - D_i),   D_i = dO_i . O_i
//   draw = dS                      or  dS (1 - tanh^2(raw / c))
//   dQ_i += draw k_j / sqrt(hd),   dK_j += draw q_i / sqrt(hd)
//
// with the forward's masks: causal and sliding window, both position axes
// from 0, masked pairs at -1e30 (so P = 0 exactly, as in the reference),
// keys past T and queries past S not taking part.  Query head h reads KV
// head h / (H / KVH).
//
// What bounds it: ~8 hd float operations per visible pair (four dot
// products and axpys) against (4 S + 4 T) hd floats moved per head, far
// above the float32 ridge at the training shapes: the float32 FMA rate.
// This first version runs on the CUDA cores in float32 (no wgmma, no TMA).
//
// Design, three kernels on the stream:
//   1. bwd_delta: D_i = dO_i . O_i, one warp per query row.
//   2. bwd_dkdv: one CTA per (64-row key tile, KV head, batch), four
//      threads per key row, each owning hd/4 interleaved head dims of the
//      row's k, v, dK and dV in registers.  It loops over the query tiles
//      of all G = H / KVH query heads of its KV head that can see the key
//      tile, staging each 64-row tile of q and dO (and its lse and D) in
//      shared memory, so dK and dV of a KV head are summed in registers by
//      one CTA: GQA needs no atomics.
//   3. bwd_dq: one CTA per (64-row query tile, query head, batch), four
//      threads per query row holding q, dO and dQ in registers, looping
//      over the 64-row K/V tiles (in shared memory) the tile can see.
// A dot product is the four threads' partial sums joined by two
// xor-shuffles.  Tiles wholly outside the causal/window band are skipped,
// as in the forward.  hd is a template parameter (16, 64, 80, 128).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BLOCK = 64;               // query rows and key rows per tile
constexpr int TPR = 4;                  // threads per row
constexpr int THREADS = BLOCK * TPR;    // 256
constexpr int DELTA_ROWS = 8;           // query rows (warps) per CTA of bwd_delta

struct Strides {
  long long b, h, s;  // batch, head and sequence strides; head dims are contiguous
};

struct Shape {
  long long n_heads, group, S, T;
  float scale, softcap;  // softcap <= 0: none
  int causal;
  long long window;      // <= 0: none
};

__device__ __forceinline__ bool visible(const Shape& sh, long long qi, long long kp) {
  bool ok = !sh.causal || qi >= kp;
  if (sh.window > 0) ok = ok && (qi - kp) < sh.window;
  return ok;
}

// d(loss)/d(q.k) of one visible pair from the joined dot products q.k and
// dO.v: the forward's score (the same operations as flash_fwd.cu), its
// softmax weight p, and the chain through the softcap and the scale.
__device__ __forceinline__ float pair_grad(const Shape& sh, float qk, float dov, float lse,
                                           float delta, float* p) {
  float s = qk * sh.scale;
  float dcap = 1.f;
  if (sh.softcap > 0.f) {
    const float t = tanhf(s / sh.softcap);
    s = sh.softcap * t;
    dcap = 1.f - t * t;
  }
  *p = expf(s - lse);
  return *p * (dov - delta) * dcap * sh.scale;
}

__device__ __forceinline__ float join(float part) {
  part += __shfl_xor_sync(0xffffffffu, part, 1);
  part += __shfl_xor_sync(0xffffffffu, part, 2);
  return part;
}

template <int HD>
__global__ void bwd_delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                                 float* __restrict__ delta, long long rows, long long H,
                                 long long S, Strides os, Strides dos) {
  const long long row = static_cast<long long>(blockIdx.x) * DELTA_ROWS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warps leave together
  const long long b = row / (H * S), h = (row / S) % H, i = row % S;
  const float* op = o + b * os.b + h * os.h + i * os.s;
  const float* dp = dout + b * dos.b + h * dos.h + i * dos.s;
  float acc = 0.f;
  for (int d = lane; d < HD; d += 32) acc += op[d] * dp[d];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dk, float* __restrict__ dv, Shape sh, Strides qs,
                Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs) {
  constexpr int DPT = HD / TPR;  // head dims per thread: lane, lane + 4, ...
  extern __shared__ float smem[];
  float* q_t = smem;                  // [BLOCK][HD]
  float* do_t = q_t + BLOCK * HD;     // [BLOCK][HD]
  float* lse_t = do_t + BLOCK * HD;   // [BLOCK]
  float* dl_t = lse_t + BLOCK;        // [BLOCK]

  const int tid = threadIdx.x;
  const int r = tid / TPR, lane = tid % TPR;
  const long long kvh = blockIdx.y, b = blockIdx.z;
  const long long k0 = static_cast<long long>(blockIdx.x) * BLOCK;
  const long long kp = k0 + r;
  const bool live = kp < sh.T;

  float kr[DPT], vr[DPT], dkr[DPT], dvr[DPT];
  const float* kb = k + b * ks.b + kvh * ks.h + kp * ks.s + lane;
  const float* vb = v + b * vs.b + kvh * vs.h + kp * vs.s + lane;
#pragma unroll
  for (int t = 0; t < DPT; ++t) {
    kr[t] = live ? kb[TPR * t] : 0.f;
    vr[t] = live ? vb[TPR * t] : 0.f;
    dkr[t] = 0.f;
    dvr[t] = 0.f;
  }

  // query rows that can see a key of this tile
  long long q_lo = 0, q_hi = sh.S;
  if (sh.causal) q_lo = k0;
  if (sh.window > 0) q_hi = min(sh.S, min(sh.T, k0 + BLOCK) - 1 + sh.window);

  for (long long g = 0; g < sh.group; ++g) {
    const long long h = kvh * sh.group + g;
    const float* qh = q + b * qs.b + h * qs.h;
    const float* doh = dout + b * dos.b + h * dos.h;
    const long long row0 = (b * sh.n_heads + h) * sh.S;
    for (long long q0 = (q_lo / BLOCK) * BLOCK; q0 < q_hi; q0 += BLOCK) {
      for (int i = tid; i < BLOCK * HD; i += THREADS) {
        const int rr = i / HD, d = i % HD;
        const long long qi = q0 + rr;
        const bool in = qi < sh.S;
        q_t[i] = in ? qh[qi * qs.s + d] : 0.f;
        do_t[i] = in ? doh[qi * dos.s + d] : 0.f;
      }
      for (int i = tid; i < BLOCK; i += THREADS) {
        const long long qi = q0 + i;
        lse_t[i] = qi < sh.S ? lse[row0 + qi] : 0.f;
        dl_t[i] = qi < sh.S ? delta[row0 + qi] : 0.f;
      }
      __syncthreads();
      for (int j = 0; j < BLOCK; ++j) {
        const float* qrow = q_t + j * HD + lane;
        const float* dorow = do_t + j * HD + lane;
        float qk = 0.f, dov = 0.f;
#pragma unroll
        for (int t = 0; t < DPT; ++t) {
          qk += qrow[TPR * t] * kr[t];
          dov += dorow[TPR * t] * vr[t];
        }
        qk = join(qk);
        dov = join(dov);
        const long long qi = q0 + j;
        if (!live || qi >= sh.S || !visible(sh, qi, kp)) continue;
        float p;
        const float ds = pair_grad(sh, qk, dov, lse_t[j], dl_t[j], &p);
#pragma unroll
        for (int t = 0; t < DPT; ++t) {
          dvr[t] += p * dorow[TPR * t];
          dkr[t] += ds * qrow[TPR * t];
        }
      }
      __syncthreads();  // the tiles are overwritten next
    }
  }
  if (live) {
    float* dkp = dk + b * dks.b + kvh * dks.h + kp * dks.s + lane;
    float* dvp = dv + b * dvs.b + kvh * dvs.h + kp * dvs.s + lane;
#pragma unroll
    for (int t = 0; t < DPT; ++t) {
      dkp[TPR * t] = dkr[t];
      dvp[TPR * t] = dvr[t];
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, Shape sh, Strides qs, Strides ks, Strides vs,
              Strides dos, Strides dqs) {
  constexpr int DPT = HD / TPR;
  extern __shared__ float smem[];
  float* k_t = smem;                 // [BLOCK][HD]
  float* v_t = k_t + BLOCK * HD;     // [BLOCK][HD]

  const int tid = threadIdx.x;
  const int r = tid / TPR, lane = tid % TPR;
  const long long h = blockIdx.y, b = blockIdx.z;
  const long long kvh = h / sh.group;
  const long long q0 = static_cast<long long>(blockIdx.x) * BLOCK;
  const long long qi = q0 + r;
  const bool live = qi < sh.S;

  float qr[DPT], dor[DPT], dqr[DPT];
  const float* qp = q + b * qs.b + h * qs.h + qi * qs.s + lane;
  const float* dop = dout + b * dos.b + h * dos.h + qi * dos.s + lane;
#pragma unroll
  for (int t = 0; t < DPT; ++t) {
    qr[t] = live ? qp[TPR * t] : 0.f;
    dor[t] = live ? dop[TPR * t] : 0.f;
    dqr[t] = 0.f;
  }
  const long long row = (b * sh.n_heads + h) * sh.S + qi;
  const float lse_i = live ? lse[row] : 0.f;
  const float delta_i = live ? delta[row] : 0.f;

  // keys any row of this tile can see (the forward's band)
  long long k_lo = 0, k_hi = sh.T;
  if (sh.causal) k_hi = min(sh.T, min(sh.S, q0 + BLOCK));
  if (sh.window > 0) k_lo = max(0LL, q0 - sh.window + 1);
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;

  for (long long k0 = (k_lo / BLOCK) * BLOCK; k0 < k_hi; k0 += BLOCK) {
    for (int i = tid; i < BLOCK * HD; i += THREADS) {
      const int rr = i / HD, d = i % HD;
      const long long kp = k0 + rr;
      const bool in = kp < sh.T;
      k_t[i] = in ? kb[kp * ks.s + d] : 0.f;
      v_t[i] = in ? vb[kp * vs.s + d] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < BLOCK; ++j) {
      const float* krow = k_t + j * HD + lane;
      const float* vrow = v_t + j * HD + lane;
      float qk = 0.f, dov = 0.f;
#pragma unroll
      for (int t = 0; t < DPT; ++t) {
        qk += qr[t] * krow[TPR * t];
        dov += dor[t] * vrow[TPR * t];
      }
      qk = join(qk);
      dov = join(dov);
      const long long kp = k0 + j;
      if (!live || kp >= sh.T || !visible(sh, qi, kp)) continue;
      float p;
      const float ds = pair_grad(sh, qk, dov, lse_i, delta_i, &p);
#pragma unroll
      for (int t = 0; t < DPT; ++t) dqr[t] += ds * krow[TPR * t];
    }
    __syncthreads();
  }
  if (live) {
    float* dqp = dq + b * dqs.b + h * dqs.h + qi * dqs.s + lane;
#pragma unroll
    for (int t = 0; t < DPT; ++t) dqp[TPR * t] = dqr[t];
  }
}

template <int HD>
cudaError_t launch(const float* q, const float* k, const float* v, const float* o,
                   const float* lse, const float* dout, float* delta, float* dq, float* dk,
                   float* dv, long long B, long long KVH, Shape sh, Strides qs, Strides ks,
                   Strides vs, Strides os, Strides dos, Strides dqs, Strides dks, Strides dvs,
                   cudaStream_t stream) {
  const long long rows = B * sh.n_heads * sh.S;
  bwd_delta_kernel<HD><<<static_cast<unsigned>((rows + DELTA_ROWS - 1) / DELTA_ROWS),
                         DELTA_ROWS * 32, 0, stream>>>(o, dout, delta, rows, sh.n_heads, sh.S,
                                                       os, dos);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr size_t kv_smem = sizeof(float) * (2 * BLOCK * HD + 2 * BLOCK);
  err = cudaFuncSetAttribute(bwd_dkdv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kv_smem));
  if (err != cudaSuccess) return err;
  const dim3 kv_grid(static_cast<unsigned>((sh.T + BLOCK - 1) / BLOCK),
                     static_cast<unsigned>(KVH), static_cast<unsigned>(B));
  bwd_dkdv_kernel<HD><<<kv_grid, THREADS, kv_smem, stream>>>(q, k, v, dout, lse, delta, dk, dv,
                                                             sh, qs, ks, vs, dos, dks, dvs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr size_t q_smem = sizeof(float) * 2 * BLOCK * HD;
  err = cudaFuncSetAttribute(bwd_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(q_smem));
  if (err != cudaSuccess) return err;
  const dim3 q_grid(static_cast<unsigned>((sh.S + BLOCK - 1) / BLOCK),
                    static_cast<unsigned>(sh.n_heads), static_cast<unsigned>(B));
  bwd_dq_kernel<HD><<<q_grid, THREADS, q_smem, stream>>>(q, k, v, dout, lse, delta, dq, sh, qs,
                                                         ks, vs, dos, dqs);
  return cudaGetLastError();
}

}  // namespace

// q, o, dout, dq (B, H, S, hd); k, v, dk, dv (B, KVH, T, hd), each given by
// its batch, head and sequence strides in elements (head dims contiguous);
// lse and delta (scratch) (B, H, S) contiguous.  window <= 0: no window;
// softcap <= 0: no cap.  Returns a cudaError_t.
extern "C" int flash_bwd_f32(const float* q, const float* k, const float* v, const float* o,
                             const float* lse, const float* dout, float* delta, float* dq,
                             float* dk, float* dv, long long B, long long H, long long KVH,
                             long long S, long long T, long long hd,
                             long long q_sb, long long q_sh, long long q_ss,
                             long long k_sb, long long k_sh, long long k_ss,
                             long long v_sb, long long v_sh, long long v_ss,
                             long long o_sb, long long o_sh, long long o_ss,
                             long long do_sb, long long do_sh, long long do_ss,
                             long long dq_sb, long long dq_sh, long long dq_ss,
                             long long dk_sb, long long dk_sh, long long dk_ss,
                             long long dv_sb, long long dv_sh, long long dv_ss,
                             float scale, int causal, long long window, float softcap,
                             cudaStream_t stream) {
  const Shape sh{H, H / KVH, S, T, scale, softcap, causal, window};
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_ss}, dos{do_sb, do_sh, do_ss}, dqs{dq_sb, dq_sh, dq_ss},
      dks{dk_sb, dk_sh, dk_ss}, dvs{dv_sb, dv_sh, dv_ss};
#define FLASH_BWD_CASE(HD)                                                                 \
  case HD:                                                                                 \
    return launch<HD>(q, k, v, o, lse, dout, delta, dq, dk, dv, B, KVH, sh, qs, ks, vs, os, \
                      dos, dqs, dks, dvs, stream);
  switch (hd) {
    FLASH_BWD_CASE(16)
    FLASH_BWD_CASE(64)
    FLASH_BWD_CASE(80)
    FLASH_BWD_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef FLASH_BWD_CASE
}
