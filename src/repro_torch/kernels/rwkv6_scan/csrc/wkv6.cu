// The RWKV6 WKV recurrence with data-dependent decay, float32, for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_scan/kernel.py
// (wkv6_scan :57, _wkv6_kernel :30, pallas_call :65).  Per (batch, head),
// with an hd x hd float32 state S:
//
//     y_t = r_t^T (S + u (.) k_t v_t^T)        (u: the head's bonus)
//     S  <- diag(w_t) S + k_t v_t^T             (w_t: the decay, in (0, 1))
//
// The TPU kernel starts S at zero and drops it at the end; this one starts
// from a given state (zero when none is given) and, when asked, writes the
// final S (B, H, hd, hd), which models/ssm.py's rwkv_forward returns and
// the decode cache carries.
//
// What bounds it: 4 hd^2 float operations per (b, h, t) against 4 * 5 hd
// bytes in and out, so at hd 64 it is far above the float32 ridge; the
// bound is the float32 FMA rate, but a single recurrence per head leaves
// little parallelism (B H CTAs of hd threads: 256 CTAs at rwkv6-7b's B 4).
//
// Design.  One CTA per (head, batch) with hd threads.  Thread j keeps
// column j of S in registers (hd floats).  Time runs in chunks of 32 steps:
// the chunk's r, k, w and v rows are staged in shared memory with one
// coalesced load, then each step reads r_t, k_t, w_t and u as broadcasts.
// T is arbitrary (no block_t divisibility).  hd is a template parameter
// (16 and 64: the slice's configs); the wrapper raises on any other.

#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 32;

struct Strides {
  long long b, h, t;  // batch, head and time strides; head dims are contiguous
};

template <int HD>
__global__ void __launch_bounds__(HD)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ s_out,
            long long H, long long T, Strides in, Strides out) {
  __shared__ float r_c[CHUNK][HD], k_c[CHUNK][HD], w_c[CHUNK][HD], v_c[CHUNK][HD];
  __shared__ float u_s[HD];

  const int j = threadIdx.x;
  const long long h = blockIdx.x;
  const long long b = blockIdx.y;
  const long long state = (b * H + h) * HD * HD;  // (B, H, hd, hd) contiguous

  float S[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) S[i] = s0 ? s0[state + i * HD + j] : 0.f;
  u_s[j] = u[h * HD + j];

  const long long base = b * in.b + h * in.h;
  float* yb = y + b * out.b + h * out.h;
  for (long long t0 = 0; t0 < T; t0 += CHUNK) {
    const int n = static_cast<int>(min(static_cast<long long>(CHUNK), T - t0));
    for (int c = 0; c < n; ++c) {
      const long long at = base + (t0 + c) * in.t + j;
      r_c[c][j] = r[at];
      k_c[c][j] = k[at];
      w_c[c][j] = w[at];
      v_c[c][j] = v[at];
    }
    __syncthreads();
    for (int c = 0; c < n; ++c) {
      const float vj = v_c[c][j];
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < HD; ++i) {
        const float kv = k_c[c][i] * vj;
        acc += r_c[c][i] * (S[i] + u_s[i] * kv);
        S[i] = w_c[c][i] * S[i] + kv;
      }
      yb[(t0 + c) * out.t + j] = acc;
    }
    __syncthreads();  // the chunk is overwritten next
  }
  if (s_out) {
#pragma unroll
    for (int i = 0; i < HD; ++i) s_out[state + i * HD + j] = S[i];
  }
}

template <int HD>
cudaError_t launch(const float* r, const float* k, const float* v, const float* w,
                   const float* u, const float* s0, float* y, float* s_out, long long B,
                   long long H, long long T, Strides in, Strides out, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(H), static_cast<unsigned>(B));
  wkv6_kernel<HD><<<grid, HD, 0, stream>>>(r, k, v, w, u, s0, y, s_out, H, T, in, out);
  return cudaGetLastError();
}

}  // namespace

// r, k, v, w (B, H, T, hd) sharing one set of batch, head and time strides
// (elements; head dims contiguous); u (H, hd) contiguous; s0 (B, H, hd, hd)
// contiguous or null (zero state); y (B, H, T, hd) by its own strides;
// s_out (B, H, hd, hd) contiguous or null (not written).  Returns a
// cudaError_t.
extern "C" int wkv6_f32(const float* r, const float* k, const float* v, const float* w,
                        const float* u, const float* s0, float* y, float* s_out,
                        long long B, long long H, long long T, long long hd,
                        long long in_sb, long long in_sh, long long in_st,
                        long long y_sb, long long y_sh, long long y_st,
                        cudaStream_t stream) {
  const Strides in{in_sb, in_sh, in_st}, out{y_sb, y_sh, y_st};
  switch (hd) {
    case 16:
      return launch<16>(r, k, v, w, u, s0, y, s_out, B, H, T, in, out, stream);
    case 64:
      return launch<64>(r, k, v, w, u, s0, y, s_out, B, H, T, in, out, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
