// The RWKV6 WKV recurrence with data-dependent decay, for sm_90a: float32
// or bfloat16 inputs, float32 arithmetic and state.
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
// Arithmetic.  Since r_t^T (u (.) k_t v_t^T) = v_t (sum_i r_i u_i k_i), the
// bonus is one scalar per (b, h, t), computed once per step; what is left
// per (i, j, t) is
//
//     acc_j  = fma(r_i, S_ij, acc_j)
//     S_ij   = fma(w_i, S_ij, k_i * v_j)
//
// three instructions, five float operations.  y_j = (the lanes' partial
// sums of acc_j, joined by a tree) + v_j * bonus.  The summation order is
// not the plain version's (ref.py keeps the reference's); the two agree to
// a few ulp of max |y| per step (tests/test_torch_wkv6.py models this
// order on the CPU).
//
// What bounds it: 5 hd^2 float operations per (b, h, t) against 4 * 5 hd
// bytes in and out (r, k, v, w read, y written), so 0.25 hd operations per
// byte: at hd 64 that is 16, below the card's float32 ridge (67 TFLOP/s
// over 3.35 TB/s = 20), so the bytes bound it, with the operations close
// behind.  At rwkv6-7b's prefill (B 4, H 64, T 256) the bytes take 26.3 us
// and the operations 20 us.
//
// Design.  One CTA per (head, batch).  The previous design (one thread per
// column of S, hd threads) issued a scalar shared-memory load for every
// (i, j, t) and left 2 warps per CTA.  Here each thread owns an R x J tile
// of S in registers: R rows of the key index i (four-row groups g, g + NG,
// ..., so that the NG lanes of a column group read NG distinct float4 and
// no two share a bank) and J columns.  Per step a thread reads its rows of
// r_t, k_t, w_t as float4 and its J values of v_t: at hd 64 (R 8, J 4, 128
// threads) 28 floats for 32 (i, j) pairs, against 4 per pair before.
//
// The NG lanes of a column group are neighbours in a warp, and their
// partial sums are joined by a reduce-scatter of __shfl_xor_sync over SB
// steps at once: the first levels halve the columns a lane keeps (a lane's
// J column slots are its columns permuted by its own lane bits, so that
// what it sends and what it keeps sit in fixed slots: no selects), the next
// halve the steps, and a butterfly sums whatever is left.  At hd 64 with
// SB = 4 that is 14 shuffles for 4 steps, after which every lane holds two
// finished (step, column) sums, adds v_j * bonus and stores them: no lane
// idles and no branch splits the batch, so the compiler schedules the
// batch's loads, FMAs and shuffles as one block (unrolling the loop over
// batches as well did not help: tests/wkv6_variants.py).  The bonuses of a
// chunk are computed before its steps by P = threads / C lanes per step (u
// stays in registers for the whole scan) and kept in shared memory.
//
// Staging.  Time runs in chunks of C steps.  A chunk of r, k, w and v lands
// in one of two shared buffers by four TMA requests (a 4-d tensor map over
// each (B, H, T, hd) view, rows past T zero-filled, completion counted on
// the buffer's mbarrier; the helpers in tma_rows.cuh, shared with the
// backward), issued one chunk ahead, so chunk c + 1 lands
// while chunk c runs.  (A first version copied each row by its own
// cp.async.bulk, 128 requests per chunk: the copy engine then took longer
// than the chunk's arithmetic; tests/wkv6_variants.py.)  TMA needs every
// row on 16 bytes (the model's views are: row strides of D floats); for
// other layouts, or where the driver refuses a map, the kernel is the
// template that loads each chunk with plain loads (the same arithmetic).
// T is arbitrary: full batches of SB steps, then single steps.  hd is a
// template parameter (8: R 4, J 1, 16 threads; 16: R 4, J 2, 32 threads;
// 32: R 4, J 4, 64 threads; 64: R 8, J 4, 128 threads: the reference
// kernel's test widths and the configs'); the wrapper raises on any other.
//
// bfloat16.  As the TPU kernel does, bfloat16 r, k, v, w and u are widened
// to float32 as they are read and y is rounded to bfloat16 (to nearest
// even) as it is written; the arithmetic, s0 and the final state stay
// float32.  A bfloat16 chunk lands raw by the same four TMA requests (a
// bfloat16 map of each view: rows on 16 bytes, i.e. strides of multiples of
// 8 elements) into one of two buffers at half the float32 bytes, one chunk
// ahead, and the steps and the bonus pass read it as it lies: four values
// by one 8-byte load, widened by two integer operations a pair (a bfloat16
// is the high half of its float32).  The steps' shared-memory reads halve,
// but each row is widened once per column group, about a quarter more
// instructions per step in a scan at the SM's issue rate: it takes ~12 %
// longer than float32.  Widening each chunk once into float32 buffers
// cost more when measured, whole after it lands or a slice under each
// batch of steps (PERF.md, the bfloat16 variants).  The steps' arithmetic
// is the float32 kernel's, so y and the state match it bit for bit.  Rows
// off 16 bytes come by the plain loads, widened on the way into float32
// buffers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

#include "tma_rows.cuh"

namespace {

template <int HD>
struct Shape;
template <>
struct Shape<8> {
  static constexpr int R = 4, J = 1, C = 16, SB = 4;
};
template <>
struct Shape<16> {
  static constexpr int R = 4, J = 2, C = 32, SB = 4;
};
template <>
struct Shape<32> {
  static constexpr int R = 4, J = 4, C = 32, SB = 4;
};
template <>
struct Shape<64> {
  static constexpr int R = 8, J = 4, C = 32, SB = 4;
};

__host__ __device__ constexpr int log2i(int x) { return x <= 1 ? 0 : 1 + log2i(x / 2); }

template <int HD>
struct Cfg {
  static constexpr int R = Shape<HD>::R;    // rows of S per thread
  static constexpr int J = Shape<HD>::J;    // columns of S per thread
  static constexpr int C = Shape<HD>::C;    // steps per chunk
  static constexpr int SB = Shape<HD>::SB;  // steps per reduce-scatter
  static constexpr int NG = HD / R;         // lanes that split a column group's rows
  static constexpr int NT = NG * (HD / J);
  // the CTA's lanes in the shuffles (hd 8 runs 16 threads: half a warp)
  static constexpr unsigned MASK = NT >= 32 ? 0xffffffffu : (1u << NT) - 1u;
  static constexpr int NQ = R / 4;          // float4 row groups per thread
  static constexpr int P = NT / C;          // lanes per step of the bonus pass
  static constexpr int PQ = HD / P / 4;     // float4 row groups per bonus lane
  static constexpr int TILE = C * HD;       // values of one tensor's chunk
  static constexpr int BUF = 4 * TILE;      // values of one buffer: r, k, w, v
  static_assert(R % 4 == 0 && HD % R == 0 && HD % J == 0, "tile");
  static_assert(NG <= 32 && 32 % NG == 0 && J <= NG, "a column group within a warp");
  static_assert((J & (J - 1)) == 0 && (NG & (NG - 1)) == 0 && (SB & (SB - 1)) == 0,
                "powers of two");
  static_assert(C % SB == 0, "batches");
  static_assert(NT % C == 0 && (P & (P - 1)) == 0 && P <= 32 && HD % (4 * P) == 0,
                "bonus lanes");
};

template <class In>
struct Args {
  CUtensorMap map[4];  // r, k, w, v rows for TMA (the TMA template)
  const In* src[4];    // r, k, w, v at (0, 0, 0, 0)
  const In* u;
  const float* s0;
  In* y;
  float* s_out;
  long long H, T;
  Strides in, out;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// y's element type from the float32 sum (bfloat16: rounded to nearest even)
template <class In>
__device__ __forceinline__ In from_f32(float x) {
  if constexpr (std::is_same<In, float>::value)
    return x;
  else
    return __float2bfloat16_rn(x);
}

// thread 0: the chunk of C rows from row t0 on of (head, batch) of every
// map into buf (r, k, w, v, dense, in the inputs' type; rows past T
// zero-filled), counted on bar.  A CTA barrier in front of it orders every
// read of buf before these writes; the fence carries that order to the copy
// engine.
template <int HD, class In>
__device__ __forceinline__ void tma_chunk(In* buf, const Args<In>& a, int t0, int head,
                                          int batch, uint64_t* bar) {
  using K = Cfg<HD>;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_expect(bar, static_cast<unsigned>(sizeof(In) * K::BUF));
#pragma unroll
  for (int x = 0; x < 4; ++x)
    tma_rows(reinterpret_cast<float*>(buf + x * K::TILE), &a.map[x], t0, head, batch, bar);
}

// four values from element 4 i of a chunk's row in shared memory (a
// bfloat16 value is the high half of its float32: two integer operations
// widen a pair), and one value
__device__ __forceinline__ float4 load4(const float* row, int i) {
  return reinterpret_cast<const float4*>(row)[i];
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* row, int i) {
  const uint2 x = reinterpret_cast<const uint2*>(row)[i];
  return make_float4(__uint_as_float(x.x << 16), __uint_as_float(x.x & 0xffff0000u),
                     __uint_as_float(x.y << 16), __uint_as_float(x.y & 0xffff0000u));
}

__device__ __forceinline__ float load1(const float* row, int i) { return row[i]; }
__device__ __forceinline__ float load1(const __nv_bfloat16* row, int i) {
  return __bfloat162float(row[i]);
}

// every thread: the chunk's n rows of r, k, w, v into buf with plain loads
// (the layouts TMA does not take; bfloat16 widened here); a CTA barrier
// follows
template <int HD, class In>
__device__ __forceinline__ void load_chunk(float* buf, const Args<In>& a, long long base,
                                           long long t0, int n) {
  using K = Cfg<HD>;
  for (int idx = threadIdx.x; idx < 4 * n * HD; idx += K::NT) {
    const int x = idx / (n * HD), rem = idx % (n * HD);
    buf[x * K::TILE + rem] = to_f32(a.src[x][base + (t0 + rem / HD) * a.in.t + rem % HD]);
  }
}

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// SB consecutive steps from step c of the chunk in cur: the state update
// of this thread's tile and, once the lanes' sums are joined, y.
template <int HD, int SB, class In, class Buf>
__device__ __forceinline__ void steps(float (&S)[Cfg<HD>::NQ][4][Cfg<HD>::J], const Buf* cur,
                                      const float* bonus, int c, int g, int cg, int mcol,
                                      In* yt, long long yst) {
  using K = Cfg<HD>;
  constexpr int J = K::J, NG = K::NG, NQ = K::NQ;
  constexpr int LCOL = log2i(J);  // levels halving columns
  constexpr int LSTEP = log2i(SB) < log2i(NG) - LCOL ? log2i(SB) : log2i(NG) - LCOL;
  constexpr int LDUP = log2i(NG) - LCOL - LSTEP;  // levels left: a butterfly
  const Buf* vv = cur + 3 * K::TILE;
  float acc[SB][J];
#pragma unroll
  for (int s = 0; s < SB; ++s) {
    const Buf* r4 = cur + (c + s) * HD;
    const Buf* k4 = cur + K::TILE + (c + s) * HD;
    const Buf* w4 = cur + 2 * K::TILE + (c + s) * HD;
    float vj[J];
#pragma unroll
    for (int jj = 0; jj < J; ++jj) {
      vj[jj] = load1(vv, (c + s) * HD + J * cg + (jj ^ mcol));
      acc[s][jj] = 0.f;
    }
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const float4 rq = load4(r4, g + NG * q), kq = load4(k4, g + NG * q),
                   wq = load4(w4, g + NG * q);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ri = comp(rq, e), ki = comp(kq, e), wi = comp(wq, e);
#pragma unroll
        for (int jj = 0; jj < J; ++jj) {
          acc[s][jj] = fmaf(ri, S[q][e][jj], acc[s][jj]);
          S[q][e][jj] = fmaf(wi, S[q][e][jj], ki * vj[jj]);
        }
      }
    }
  }
  // columns: slot jj holds column jj ^ mcol, so at the level of lane bit
  // `bit` every lane keeps slots [0, half) and sends [half, 2 half)
#pragma unroll
  for (int l = 0; l < LCOL; ++l) {
    const int bit = NG >> (l + 1), half = J >> (l + 1);
#pragma unroll
    for (int s = 0; s < SB; ++s)
#pragma unroll
      for (int e = 0; e < half; ++e)
        acc[s][e] += __shfl_xor_sync(K::MASK, acc[s][e + half], bit);
  }
  // steps: the upper lane of each pair keeps the later half
  float val[SB];
#pragma unroll
  for (int s = 0; s < SB; ++s) val[s] = acc[s][0];
  int sbase = 0;
#pragma unroll
  for (int l = 0; l < LSTEP; ++l) {
    const int bit = NG >> (LCOL + l + 1), half = SB >> (l + 1);
    const bool upper = (g & bit) != 0;
#pragma unroll
    for (int e = 0; e < half; ++e) {
      const float send = upper ? val[e] : val[e + half];
      const float keep = upper ? val[e + half] : val[e];
      val[e] = keep + __shfl_xor_sync(K::MASK, send, bit);
    }
    sbase += upper ? half : 0;
  }
#pragma unroll
  for (int l = 0; l < LDUP; ++l) {
    const int bit = NG >> (LCOL + LSTEP + l + 1);
#pragma unroll
    for (int e = 0; e < (SB >> LSTEP); ++e) val[e] += __shfl_xor_sync(K::MASK, val[e], bit);
  }
  if ((g & ((1 << LDUP) - 1)) == 0) {
    const int j = J * cg + mcol;
#pragma unroll
    for (int e = 0; e < (SB >> LSTEP); ++e) {
      const int t = c + sbase + e;
      yt[t * yst + j] = from_f32<In>(fmaf(load1(vv, t * HD + j), bonus[t], val[e]));
    }
  }
}

template <int HD, bool TMA, class In>
__global__ void __launch_bounds__(Cfg<HD>::NT)
wkv6_keysplit_kernel(const __grid_constant__ Args<In> a) {
  using K = Cfg<HD>;
  constexpr int J = K::J, C = K::C, NG = K::NG, NQ = K::NQ, P = K::P, SB = K::SB;
  // the chunks as TMA lands them (bfloat16 stays raw), else as the loads
  // widen them
  using Buf = std::conditional_t<TMA, In, float>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Buf* smem = reinterpret_cast<Buf*>(smem_raw);                // [2][BUF]
  float* bonus = reinterpret_cast<float*>(smem + 2 * K::BUF);  // [2][C]
  uint64_t* bar = reinterpret_cast<uint64_t*>(bonus + 2 * C);

  const int tid = threadIdx.x;
  const int g = tid % NG;   // row group: rows 4 (g + NG q) + e
  const int cg = tid / NG;  // column group: columns J cg + (jj ^ mcol)
  int mcol = 0;             // the lane's permutation of its column slots
#pragma unroll
  for (int l = 0; l < log2i(J); ++l) mcol |= (g & (NG >> (l + 1))) ? (J >> (l + 1)) : 0;
  const int h = blockIdx.x, b = blockIdx.y;
  const long long state = (static_cast<long long>(b) * a.H + h) * HD * HD;
  const long long base = b * a.in.b + h * a.in.h;
  In* yb = a.y + b * a.out.b + h * a.out.h;

  float S[NQ][4][J];
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int jj = 0; jj < J; ++jj)
        S[q][e][jj] = a.s0 ? a.s0[state + (4 * (g + NG * q) + e) * HD + J * cg + (jj ^ mcol)]
                           : 0.f;

  // the bonus pass: lane pp of step pc sums rows 4 (pp + P q) + e
  const int pc = tid / P, pp = tid % P;
  float4 u4[K::PQ];
#pragma unroll
  for (int q = 0; q < K::PQ; ++q) {
    const In* uq = a.u + h * HD + 4 * (pp + P * q);
    u4[q] = make_float4(to_f32(uq[0]), to_f32(uq[1]), to_f32(uq[2]), to_f32(uq[3]));
  }
  // a chunk's bonuses, sum_i r_i u_i k_i per step, into slot nb (lanes
  // past n compute on rows that are zero or stale and store nothing; every
  // lane joins the shuffles)
  auto bonus_pass = [&](const Buf* chunk, int nb, int n) {
    float part = 0.f;
#pragma unroll
    for (int q = 0; q < K::PQ; ++q) {
      const float4 r4 = load4(chunk + pc * HD, pp + P * q);
      const float4 k4 = load4(chunk + K::TILE + pc * HD, pp + P * q);
      part = fmaf(r4.x * u4[q].x, k4.x, part);
      part = fmaf(r4.y * u4[q].y, k4.y, part);
      part = fmaf(r4.z * u4[q].z, k4.z, part);
      part = fmaf(r4.w * u4[q].w, k4.w, part);
    }
#pragma unroll
    for (int off = P / 2; off > 0; off >>= 1) part += __shfl_xor_sync(K::MASK, part, off);
    if (pp == 0 && pc < n) bonus[nb * C + pc] = part;
  };
  // the steps of chunk ch
  auto steps_in = [&](int ch) {
    return static_cast<int>(min(static_cast<long long>(C), a.T - static_cast<long long>(ch) * C));
  };

  const int n_chunks = static_cast<int>((a.T + C - 1) / C);
  if constexpr (TMA) {
    if (tid == 0) {
      mbar_init(&bar[0]);
      mbar_init(&bar[1]);
    }
    __syncthreads();
    if (tid == 0) tma_chunk<HD>(smem, a, 0, h, b, &bar[0]);
  }
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int nb = ch & 1;
    const long long t0 = static_cast<long long>(ch) * C;
    const int n = steps_in(ch);
    Buf* cur = smem + nb * K::BUF;
    if constexpr (TMA) {
      mbar_wait(&bar[nb], static_cast<unsigned>((ch >> 1) & 1));
    } else {
      load_chunk<HD>(cur, a, base, t0, n);
      __syncthreads();
    }
    bonus_pass(cur, nb, n);
    // the bonuses are visible, and every thread is done with chunk ch - 1,
    // so the other buffer may be refilled
    __syncthreads();
    if constexpr (TMA) {
      if (tid == 0 && ch + 1 < n_chunks)
        tma_chunk<HD>(smem + (nb ^ 1) * K::BUF, a, static_cast<int>(t0 + C), h, b,
                      &bar[nb ^ 1]);
    }
    In* yt = yb + t0 * a.out.t;
    int c = 0;
#pragma unroll 1
    for (; c + SB <= n; c += SB)
      steps<HD, SB>(S, cur, bonus + nb * C, c, g, cg, mcol, yt, a.out.t);
    for (; c < n; ++c) steps<HD, 1>(S, cur, bonus + nb * C, c, g, cg, mcol, yt, a.out.t);
  }
  if (a.s_out) {
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int jj = 0; jj < J; ++jj)
          a.s_out[state + (4 * (g + NG * q) + e) * HD + J * cg + (jj ^ mcol)] = S[q][e][jj];
  }
}

template <int HD, class In>
bool maps(Args<In>& a, long long B) {
  for (int x = 0; x < 4; ++x) {
    const int ok = std::is_same<In, float>::value
                       ? rows_map(&a.map[x], reinterpret_cast<const float*>(a.src[x]), B, a.H,
                                  a.T, HD, a.in, Cfg<HD>::C)
                       : rows_map_bf16(&a.map[x], a.src[x], B, a.H, a.T, HD, a.in, Cfg<HD>::C);
    if (ok != 1) return false;
  }
  return true;
}

template <int HD, bool TMA, class In>
cudaError_t launch_one(const Args<In>& a, long long B, cudaStream_t stream) {
  // two chunk buffers (raw bfloat16 by TMA, else float32), two chunks of
  // bonuses, two mbarriers
  constexpr size_t smem = sizeof(std::conditional_t<TMA, In, float>) * 2 * Cfg<HD>::BUF +
                          sizeof(float) * 2 * Cfg<HD>::C + 2 * sizeof(uint64_t);
  static const cudaError_t attr = cudaFuncSetAttribute(
      wkv6_keysplit_kernel<HD, TMA, In>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid(static_cast<unsigned>(a.H), static_cast<unsigned>(B));
  wkv6_keysplit_kernel<HD, TMA, In><<<grid, Cfg<HD>::NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int HD, class In>
cudaError_t launch(Args<In>& a, long long B, cudaStream_t stream) {
  // the grid's limits, and TMA's 32-bit coordinates
  if (a.H > INT_MAX || B > 65535 || a.T > (1LL << 30)) return cudaErrorInvalidValue;
  if (maps<HD>(a, B)) return launch_one<HD, true>(a, B, stream);
  return launch_one<HD, false>(a, B, stream);
}

template <class In>
int wkv6(const In* r, const In* k, const In* v, const In* w, const In* u, const float* s0,
         In* y, float* s_out, long long B, long long H, long long T, long long hd,
         long long in_sb, long long in_sh, long long in_st, long long y_sb, long long y_sh,
         long long y_st, cudaStream_t stream) {
  Args<In> a = {};
  a.src[0] = r;
  a.src[1] = k;
  a.src[2] = w;
  a.src[3] = v;
  a.u = u;
  a.s0 = s0;
  a.y = y;
  a.s_out = s_out;
  a.H = H;
  a.T = T;
  a.in = Strides{in_sb, in_sh, in_st};
  a.out = Strides{y_sb, y_sh, y_st};
  switch (hd) {
    case 8:
      return launch<8>(a, B, stream);
    case 16:
      return launch<16>(a, B, stream);
    case 32:
      return launch<32>(a, B, stream);
    case 64:
      return launch<64>(a, B, stream);
    default:
      return cudaErrorInvalidValue;
  }
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
  return wkv6(r, k, v, w, u, s0, y, s_out, B, H, T, hd, in_sb, in_sh, in_st, y_sb, y_sh, y_st,
              stream);
}

// The same with bfloat16 r, k, v, w, u and y (s0 and s_out float32).
extern "C" int wkv6_bf16(const __nv_bfloat16* r, const __nv_bfloat16* k,
                         const __nv_bfloat16* v, const __nv_bfloat16* w,
                         const __nv_bfloat16* u, const float* s0, __nv_bfloat16* y,
                         float* s_out, long long B, long long H, long long T, long long hd,
                         long long in_sb, long long in_sh, long long in_st,
                         long long y_sb, long long y_sh, long long y_st,
                         cudaStream_t stream) {
  return wkv6(r, k, v, w, u, s0, y, s_out, B, H, T, hd, in_sb, in_sh, in_st, y_sb, y_sh, y_st,
              stream);
}

// 1 when a (B, H, T, hd) view with these strides (in elements) is staged by
// TMA in this kernel, 0 when by plain loads (a row off 16 bytes, or the
// driver refuses the map); elem_bytes 4 (float32) or 2 (bfloat16)
extern "C" int wkv6_rows_tma(const void* base, long long B, long long H, long long T,
                             long long hd, long long sb, long long sh, long long st,
                             long long elem_bytes) {
  CUtensorMap map;
  const Strides s{sb, sh, st};
  return (elem_bytes == 4
              ? rows_map(&map, static_cast<const float*>(base), B, H, T, hd, s, Cfg<64>::C)
              : rows_map_bf16(&map, base, B, H, T, hd, s, Cfg<64>::C)) == 1
             ? 1
             : 0;
}
