// The backward of the RWKV6 WKV recurrence (B.7's forward, wkv6.cu), float32,
// for sm_90a.
//
// The TPU kernel src/repro/kernels/rwkv6_scan/kernel.py (wkv6_scan,
// pallas_call :65) has no backward: the reference differentiates its XLA
// scan (src/repro/models/ssm.py:138).  The port trains RWKV on the card
// through this kernel (ops.py, WKV6).  Per (batch, head), with S_t the
// state before step t (S_0 = s0, zero when none is given) and G the adjoint
// of the state after step t (G = dS_T, zero when none is given, after the
// last step):
//
//     dr_t = (S_t + u (.) k_t v_t^T) dy_t
//     dk_t = G v_t + u (.) r_t (dy_t . v_t)
//     dv_t = G^T k_t + (sum_i r_t[i] u[i] k_t[i]) dy_t
//     dw_t[i] = sum_j G[i, j] S_t[i, j]
//     du += r_t (.) k_t (dy_t . v_t)              (summed over t and b)
//     G <- diag(w_t) G + r_t dy_t^T,              ds0 = G at the end.
//
// Every element (i, j) of S and of G evolves on its own; only the outputs
// sum across them: dr, dk, dw and du over the columns j of a row, dv over
// the rows i.  The u terms are folded into those sums: dr_t[i] = sum_j
// dy_j (S_ij + u_i k_i v_j), dk_t[i] = sum_j v_j (G_ij + u_i r_i dy_j) and
// dv_t[j] = sum_i k_i (G_ij + u_i r_i dy_j).
//
// S_t is never rebuilt by dividing by w_t (the model's w = exp(-exp(.))
// reaches 0).  The kernel runs two sweeps.  The forward sweep runs the
// recurrence from s0, writes dr_t, sums du's row partials, and saves S at
// the start of every chunk of C steps (the checkpoints, B * H * ceil(T / C)
// * hd^2 floats of scratch the wrapper allocates: 16 MB at rwkv6-7b's
// training shape B 2, H 64, T 64, hd 64 with C = 8).  The reverse sweep
// takes the chunks from the last: it recomputes the chunk's states from its
// checkpoint into shared memory (C hd^2 floats), then walks the chunk's
// steps backwards with G in registers.  So the forward's arithmetic runs
// twice and the states of one chunk at a time are kept.
//
// What bounds it: per (i, j, t) 14 float operations (the recurrence
// recomputed once, S dy, G's update, G v, G^T k, G (.) S), and per (i, t)
// 16 more for the u terms, which the function needs per row only (this
// kernel folds them into every (i, j), which the bound does not count),
// against 9 hd floats per (b, h, t) in and out (r, k, v, w, dy read; dr,
// dk, dv, dw written): about 0.39 hd operations per byte, at hd 64 25,
// above the float32 ridge of 20 (67 TFLOP/s over 3.35 TB/s): the
// operations, 7.14 us at the training shape against 5.6 us for the bytes.
//
// Design (a simple kernel first).  One CTA per (head, batch), 4 hd threads:
// thread tid owns row i = tid / 4 of S and G and the columns j = q + 4 m
// (q = tid % 4, m < hd / 4), so the four lanes of a row are neighbours and
// a row's sums are two xor-shuffles, and a warp holds 8 whole rows.  Per
// chunk r, k, w, v and dy are staged in shared memory by plain loads (any
// strides with contiguous head dims); a lane reads its row's r, k, w once
// per step and v_j, dy_j as broadcasts.  A thread's states of the chunk sit
// in shared memory in a thread-private layout (no barrier needed), as do
// its checkpoints in device memory.  dv's sum over rows is a reduce-scatter
// of shuffles over the warp's 8 rows (lane bits 2..4: each lane ends with
// hd / 32 finished column sums, or one after a butterfly at hd 16), written
// per warp and step to shared memory and summed over the warps in a fixed
// order once per chunk.  du's row sums are written per batch and summed
// over the batches in order by a second, small kernel: no float atomics
// anywhere, so two calls give the same bits.  hd is a template parameter
// (16: C 32, 64 threads; 64: C 8, 256 threads, 154 KB of shared memory);
// the wrapper raises on any other.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

struct Strides {
  long long b, h, t;  // batch, head and time strides; head dims are contiguous
};

template <int HD>
struct Chunk;
template <>
struct Chunk<16> {
  static constexpr int C = 32;
};
template <>
struct Chunk<64> {
  static constexpr int C = 8;
};

template <int HD>
struct Cfg {
  static constexpr int NT = 4 * HD;      // threads: four per row
  static constexpr int M = HD / 4;       // columns per thread
  static constexpr int NW = NT / 32;     // warps, 8 rows each
  static constexpr int C = Chunk<HD>::C; // steps per chunk (checkpoint stride)
  static constexpr int IN = 5 * C * HD;  // staged r, k, w, v, dy
  static constexpr int ST = C * HD * HD; // the chunk's states, thread-private
  static constexpr int PART = C * NW * HD;  // dv's per-warp sums
  static constexpr size_t SMEM = sizeof(float) * (IN + ST + PART);
  static_assert(HD % 32 == 0 || HD == 16, "8 rows per warp, 4 lanes per row");
};

struct Args {
  const float* src[4];  // r, k, w, v at (0, 0, 0, 0), strides `in`
  const float* dy;      // strides `dys`
  const float* u;
  const float* s0;  // (B, H, hd, hd) or null
  const float* ds;  // (B, H, hd, hd) or null
  float* grad[4];   // dr, dk, dw, dv, strides `out`
  float* du_part;   // (B, H, hd)
  float* ds0;       // (B, H, hd, hd) or null
  float* ckpt;      // (B, H, chunks, hd, hd), thread-private layout
  long long H, T;
  Strides in, dys, out;
};

// every thread: the chunk's n rows of r, k, w, v and dy into sin ([5][C][HD])
template <int HD>
__device__ __forceinline__ void stage(float* sin, const Args& a, long long base,
                                      long long dybase, long long t0, int n) {
  using K = Cfg<HD>;
  for (int idx = threadIdx.x; idx < 5 * n * HD; idx += K::NT) {
    const int x = idx / (n * HD), rem = idx % (n * HD);
    const long long t = t0 + rem / HD;
    const int d = rem % HD;
    sin[x * K::C * HD + rem] =
        x < 4 ? a.src[x][base + t * a.in.t + d] : a.dy[dybase + t * a.dys.t + d];
  }
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One level of dv's reduce-scatter over the rows of a warp: lanes that
// differ in `bit` swap halves of their column slots and keep the sum of
// one half each (slot base advances by HALF for the upper lane); with one
// slot left, a butterfly.
template <int M, int HALF>
__device__ __forceinline__ void halve(float (&p)[M], int lane, int bit, int& base) {
  const bool upper = (lane & bit) != 0;
  if constexpr (HALF >= 1) {
#pragma unroll
    for (int e = 0; e < HALF; ++e) {
      const float send = upper ? p[e] : p[e + HALF];
      const float keep = upper ? p[e + HALF] : p[e];
      p[e] = keep + __shfl_xor_sync(0xffffffffu, send, bit);
    }
    base += upper ? HALF : 0;
  } else {
    p[0] += __shfl_xor_sync(0xffffffffu, p[0], bit);
  }
}

template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::NT) wkv6_bwd_kernel(const __grid_constant__ Args a) {
  using K = Cfg<HD>;
  constexpr int M = K::M, C = K::C, NT = K::NT, NW = K::NW;
  constexpr int KEPT = M >= 8 ? M / 8 : 1;  // dv's column sums per lane
  extern __shared__ __align__(16) float smem[];
  float* sin = smem;            // [5][C][HD]: r, k, w, v, dy
  float* sst = smem + K::IN;    // [C][M][NT]
  float* spart = sst + K::ST;   // [C][NW][HD]
  const float* rr = sin;
  const float* kk = sin + C * HD;
  const float* ww = sin + 2 * C * HD;
  const float* vv = sin + 3 * C * HD;
  const float* dd = sin + 4 * C * HD;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = tid >> 2, q = tid & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const long long bh = static_cast<long long>(b) * a.H + h;
  const long long base = b * a.in.b + h * a.in.h;
  const long long dybase = b * a.dys.b + h * a.dys.h;
  const long long obase = b * a.out.b + h * a.out.h;
  const long long state = bh * HD * HD + static_cast<long long>(i) * HD + q;
  const int n_chunks = static_cast<int>((a.T + C - 1) / C);
  float* ck = a.ckpt + bh * n_chunks * HD * HD + tid;  // [chunk][M][NT]
  const float ui = a.u[h * HD + i];

  // -- forward sweep: dr, du's partials, the checkpoints
  float S[M];
#pragma unroll
  for (int m = 0; m < M; ++m) S[m] = a.s0 ? a.s0[state + 4 * m] : 0.f;
  float du = 0.f;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const long long t0 = static_cast<long long>(ch) * C;
    const int n = static_cast<int>(min(static_cast<long long>(C), a.T - t0));
    __syncthreads();  // every thread is done with the last chunk's inputs
    stage<HD>(sin, a, base, dybase, t0, n);
    __syncthreads();
#pragma unroll
    for (int m = 0; m < M; ++m) ck[(ch * M + m) * NT] = S[m];
    for (int c = 0; c < n; ++c) {
      const float ri = rr[c * HD + i], ki = kk[c * HD + i], wi = ww[c * HD + i];
      const float uk = ui * ki;
      float p = 0.f, vd = 0.f;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float vj = vv[c * HD + q + 4 * m], dj = dd[c * HD + q + 4 * m];
        p = fmaf(fmaf(uk, vj, S[m]), dj, p);
        vd = fmaf(vj, dj, vd);
        S[m] = fmaf(wi, S[m], ki * vj);
      }
      p = quad_sum(p);
      du = fmaf(ri * ki, vd, du);
      if (q == 0) a.grad[0][obase + (t0 + c) * a.out.t + i] = p;
    }
  }
  du = quad_sum(du);
  if (q == 0) a.du_part[bh * HD + i] = du;

  // -- reverse sweep, chunk by chunk from the last: dk, dw, dv, ds0
  float G[M];
#pragma unroll
  for (int m = 0; m < M; ++m) G[m] = a.ds ? a.ds[state + 4 * m] : 0.f;
  for (int ch = n_chunks - 1; ch >= 0; --ch) {
    const long long t0 = static_cast<long long>(ch) * C;
    const int n = static_cast<int>(min(static_cast<long long>(C), a.T - t0));
    __syncthreads();  // the last chunk's inputs and dv partials are read
    stage<HD>(sin, a, base, dybase, t0, n);
    __syncthreads();
    // the chunk's states S_t, recomputed from its checkpoint
#pragma unroll
    for (int m = 0; m < M; ++m) S[m] = ck[(ch * M + m) * NT];
    for (int c = 0; c < n; ++c) {
      const float ki = kk[c * HD + i], wi = ww[c * HD + i];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        sst[(c * M + m) * NT + tid] = S[m];
        S[m] = fmaf(wi, S[m], ki * vv[c * HD + q + 4 * m]);
      }
    }
    for (int c = n - 1; c >= 0; --c) {
      const float ri = rr[c * HD + i], ki = kk[c * HD + i], wi = ww[c * HD + i];
      const float ur = ui * ri;
      float dk = 0.f, dw = 0.f, part[M];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float vj = vv[c * HD + q + 4 * m], dj = dd[c * HD + q + 4 * m];
        const float g = fmaf(ur, dj, G[m]);
        dk = fmaf(vj, g, dk);
        part[m] = ki * g;
        dw = fmaf(G[m], sst[(c * M + m) * NT + tid], dw);
        G[m] = fmaf(wi, G[m], ri * dj);
      }
      dk = quad_sum(dk);
      dw = quad_sum(dw);
      if (q == 0) {
        a.grad[1][obase + (t0 + c) * a.out.t + i] = dk;
        a.grad[2][obase + (t0 + c) * a.out.t + i] = dw;
      }
      int slot = 0;
      halve<M, M / 2>(part, lane, 16, slot);
      halve<M, M / 4>(part, lane, 8, slot);
      halve<M, M / 8>(part, lane, 4, slot);
      if (M >= 8 || (lane & 4) == 0) {
#pragma unroll
        for (int e = 0; e < KEPT; ++e) spart[(c * NW + warp) * HD + q + 4 * (slot + e)] = part[e];
      }
    }
    __syncthreads();
    for (int idx = tid; idx < n * HD; idx += NT) {
      const int c = idx / HD, j = idx % HD;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) s += spart[(c * NW + w) * HD + j];
      a.grad[3][obase + (t0 + c) * a.out.t + j] = s;
    }
  }
  if (a.ds0) {
#pragma unroll
    for (int m = 0; m < M; ++m) a.ds0[state + 4 * m] = G[m];
  }
}

// du[h, i] = sum over b, in order, of the per-batch row sums
__global__ void wkv6_du_kernel(const float* __restrict__ part, float* __restrict__ du,
                               long long B, long long n) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float s = 0.f;
  for (long long b = 0; b < B; ++b) s += part[b * n + idx];
  du[idx] = s;
}

template <int HD>
cudaError_t launch(const Args& a, long long B, float* du, cudaStream_t stream) {
  using K = Cfg<HD>;
  if (a.H > INT_MAX || B > 65535 || a.T > (1LL << 30)) return cudaErrorInvalidValue;
  static const cudaError_t attr =
      cudaFuncSetAttribute(wkv6_bwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(K::SMEM));
  if (attr != cudaSuccess) return attr;
  const dim3 grid(static_cast<unsigned>(a.H), static_cast<unsigned>(B));
  wkv6_bwd_kernel<HD><<<grid, K::NT, K::SMEM, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = a.H * HD;
  constexpr int THREADS = 256;
  wkv6_du_kernel<<<static_cast<unsigned>((n + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      a.du_part, du, B, n);
  return cudaGetLastError();
}

}  // namespace

// Steps per chunk (the checkpoint stride) at head dim hd, 0 where the kernel
// is not built for hd: the wrapper sizes the checkpoint scratch by it.
extern "C" int wkv6_bwd_chunk(long long hd) {
  return hd == 16 ? Cfg<16>::C : hd == 64 ? Cfg<64>::C : 0;
}

// r, k, v, w (B, H, T, hd) sharing one set of batch, head and time strides
// (elements; head dims contiguous); u (H, hd) contiguous; s0, ds (B, H, hd,
// hd) contiguous or null (zero); dy (B, H, T, hd) by its own strides; dr,
// dk, dv, dw (B, H, T, hd) sharing one set of strides; du (H, hd); ds0 (B,
// H, hd, hd) contiguous or null (not written); ckpt B * H * ceil(T / C) *
// hd^2 floats and du_part B * H * hd floats of scratch.  Returns a
// cudaError_t.
extern "C" int wkv6_bwd_f32(const float* r, const float* k, const float* v, const float* w,
                            const float* u, const float* s0, const float* dy, const float* ds,
                            float* dr, float* dk, float* dv, float* dw, float* du, float* ds0,
                            float* ckpt, float* du_part, long long B, long long H, long long T,
                            long long hd, long long in_sb, long long in_sh, long long in_st,
                            long long dy_sb, long long dy_sh, long long dy_st, long long out_sb,
                            long long out_sh, long long out_st, cudaStream_t stream) {
  Args a = {};
  a.src[0] = r;
  a.src[1] = k;
  a.src[2] = w;
  a.src[3] = v;
  a.dy = dy;
  a.u = u;
  a.s0 = s0;
  a.ds = ds;
  a.grad[0] = dr;
  a.grad[1] = dk;
  a.grad[2] = dw;
  a.grad[3] = dv;
  a.du_part = du_part;
  a.ds0 = ds0;
  a.ckpt = ckpt;
  a.H = H;
  a.T = T;
  a.in = Strides{in_sb, in_sh, in_st};
  a.dys = Strides{dy_sb, dy_sh, dy_st};
  a.out = Strides{out_sb, out_sh, out_st};
  switch (hd) {
    case 16:
      return launch<16>(a, B, du, stream);
    case 64:
      return launch<64>(a, B, du, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
