// Forward GQA attention with an online softmax, float32, on the tensor
// cores of sm_90a (3xTF32 mma.sync).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_fwd :80, _flash_fwd_kernel :30, pallas_call :100): per
// (batch, query head) it computes softmax(softcap(q k^T / sqrt(hd)) + mask) v
// with a causal and an optional sliding-window mask, both position axes
// starting at 0, masked scores at -1e30 (never -inf, so no row gives NaN),
// f32 running max, sum and accumulator, one exp per score, and a final
// divide by max(l, 1e-30).  Query head h reads KV head h / (H / KVH).  When
// asked (lse not null), it also writes each row's log-sum-exp
// m + log(max(l, 1e-30)) as (B, H, S) float32, which the backward
// (flash_bwd.cu) recomputes the softmax from.
//
// What bounds it: at qwen2-0.5b's prefill (B 4, H 14 over 2 KV heads,
// S = T = 512, hd 64) the work is 4 hd float operations per visible
// (query, key) pair against 4 (2 S H + 2 T KVH) hd bytes, far above the
// ridge: the operations.  In float32 accuracy each product runs as three
// TF32 tensor-core products (tc_tf32.cuh), so the bound is 3 x operations
// at the TF32 rate, 2.5x below the CUDA cores' float32 bound.  mma.sync
// runs below that peak (wgmma's), and each float32 operand costs four more
// instructions to split, so the kernel is bound by latency and instruction
// issue well before the tensor cores.  At the
// training shape (S = 64) the call is a few tiles per warp: launch and
// latency.
//
// Design.  One CTA of four warps per (64 packed query rows, KV head,
// batch).  The rows of the G = H / KVH query heads that share a KV head are
// packed position-major (row p is position p / G of head p % G of the
// group), so each K/V tile is loaded once for the whole group, and a CTA's
// 64 rows span 64 / G positions: a tight causal band.  At the training
// shape (B 2, KVH 2, G 7, S 64) that is 28 CTAs.  The last rows go first:
// under a causal mask they see the most keys.  Each warp owns 16 rows; q
// stays in shared memory (copied once by cp.async) and is split as it is
// read, and each warp's scores (16 x 32 keys) and output accumulator (16 x
// hd) stay in registers as mma C fragments.  K/V tiles of 32 rows land in a
// raw buffer in one TMA request (a 4-d tensor map over the strided view,
// rows past T zero-filled, completion on an mbarrier), or by cp.async where
// the rows are not 16-byte aligned; the CTA splits each tile once into big
// and small buffers (tc_tf32.cuh, split_rows), then starts the next tile's
// copy, which lands under this tile's products.  S = q k^T and O += P V
// are mma.sync m16n8k8 TF32 products, each float32 product as three, and P
// goes from the score fragments straight into the P V product's A operand.
// wgmma is left out: TF32 wgmma wants both operands K-major in shared
// memory, so V would need a transposed copy for P V, and q's split halves
// would have to be staged there too; mma.sync takes its A operand from
// registers.  Each row's max and sum are kept per lane and joined over the
// lane quad; exp is one ex2.approx (tc_tf32.cuh, exp_fast).  Tiles wholly
// above the causal diagonal or outside the window are skipped, and a tile
// inside the band for every row of the CTA is not masked.  S and T need
// not be multiples of the tiles: rows past S are zero-filled and write
// nothing, keys past T are zero-filled and get weight exactly 0.  hd is a
// template parameter (16, 64, 80, 128: the slice's configs); the wrapper
// raises on any other.

#include <cuda_runtime.h>
#include <math.h>

#include "tc_tf32.cuh"

namespace {

using namespace flash;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BM = 16 * WARPS;  // packed query rows per CTA
constexpr int BN = 32;          // keys per K/V tile

template <int HD>
struct Tile {
  static constexpr int LD = HD + 8;   // shared pitch of q and k (floats)
  static constexpr int LDV = HD + 4;  // of v (read as load_b_kn)
  // raw k and v (dense), q, k and v split, the copies' barrier
  static constexpr size_t SMEM =
      sizeof(float) * (2 * BN * HD + BM * LD + 2 * BN * LD + 2 * BN * LDV) + 16;
};

struct Args {
  CUtensorMap tk, tv;  // k and v rows for TMA (when tma)
  const float *q, *k, *v;
  float *o, *lse;
  long long H;
  int G, S, T;
  Strides qs, ks, vs, os;
  float scale, softcap;  // softcap <= 0: none
  int causal, window;    // window <= 0: none
  int vec;               // every row of q, k, v and o 16-byte aligned
  int tma;               // k and v tiles by TMA, else by cp.async
};

template <int HD>
__global__ void __launch_bounds__(THREADS) flash_fwd_mma_kernel(const __grid_constant__ Args a) {
  constexpr int LD = Tile<HD>::LD, LDV = Tile<HD>::LDV;
  constexpr int NT = BN / 8, DT = HD / 8;
  extern __shared__ __align__(128) float4 smem4[];
  float* kraw = reinterpret_cast<float*>(smem4);  // [BN][HD], as copied
  float* vraw = kraw + BN * HD;                   // [BN][HD]
  float* sq = vraw + BN * HD;                     // [BM][LD]
  float* kbig = sq + BM * LD;                     // [BN][LD]
  float* ksmall = kbig + BN * LD;                 // [BN][LD]
  float* vbig = ksmall + BN * LD;                 // [BN][LDV]
  float* vsmall = vbig + BN * LDV;                // [BN][LDV]
  uint64_t* bar = reinterpret_cast<uint64_t*>(vsmall + BN * LDV);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const long long kvh = blockIdx.y, b = blockIdx.z;
  const int rows = a.G * a.S;
  // the last rows first: under a causal mask they see the most keys
  const int p0 = (gridDim.x - 1 - blockIdx.x) * BM;

  // the keys any row of the tile can see
  const int i_lo = p0 / a.G, i_hi = (min(rows, p0 + BM) - 1) / a.G;
  int k_lo = 0, k_hi = a.T;
  if (a.causal) k_hi = min(a.T, i_hi + 1);
  if (a.window > 0) k_lo = max(0, i_lo - a.window + 1);
  const int k_first = (k_lo / BN) * BN;
  const int n_tiles = k_hi > k_first ? (k_hi - k_first + BN - 1) / BN : 0;

  const float* kb = a.k + b * a.ks.b + kvh * a.ks.h;
  const float* vb = a.v + b * a.vs.b + kvh * a.vs.h;
  // starts the copy of tile n's k and v rows into the raw buffers
  auto copy_kv = [&](int n) {
    const int k0 = k_first + n * BN;
    if (a.tma) {
      if (threadIdx.x == 0) {
        mbar_expect(bar, 2 * BN * HD * sizeof(float));
        tma_rows(kraw, &a.tk, k0, static_cast<int>(kvh), static_cast<int>(b), bar);
        tma_rows(vraw, &a.tv, k0, static_cast<int>(kvh), static_cast<int>(b), bar);
      }
    } else {
      stage_rows<HD, HD, THREADS>(kraw, BN, a.vec, kb, a.ks.s, k0, a.T);
      stage_rows<HD, HD, THREADS>(vraw, BN, a.vec, vb, a.vs.s, k0, a.T);
    }
    cp_async_commit();
  };

  if (a.tma && threadIdx.x == 0) mbar_init(bar);
  if (n_tiles > 0) copy_kv(0);  // by TMA: in flight while q is staged
  stage_packed<HD, LD, THREADS>(sq, BM, a.vec, a.q + b * a.qs.b + kvh * a.G * a.qs.h, a.qs.h,
                                a.qs.s, a.G, p0, rows);
  cp_async_commit();
  __syncthreads();  // the barrier is set up before anyone waits on it

  // this lane's two rows (C fragment rows g and g + 8 of its warp)
  int pos[2];
  long long head[2];
  bool live[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int p = p0 + warp * 16 + g + 8 * r;
    live[r] = p < rows;
    pos[r] = p / a.G;
    head[r] = kvh * a.G + p % a.G;
  }

  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {MASKED, MASKED}, l[2] = {0.f, 0.f};  // l: this lane's share of the row sum

  for (int n = 0; n < n_tiles; ++n) {
    cp_async_wait<0>();
    if (a.tma) mbar_wait(bar, n & 1);
    __syncthreads();  // tile n is in; every warp is done with tile n - 1
    split_rows<HD, LD, BN, THREADS>(kraw, kbig, ksmall);
    split_rows<HD, LDV, BN, THREADS>(vraw, vbig, vsmall);
    __syncthreads();  // split; the raw buffers are free
    if (n + 1 < n_tiles) copy_kv(n + 1);  // lands under this tile's products
    const Split2 kt{kbig, ksmall}, vt{vbig, vsmall};
    const int k0 = k_first + n * BN;
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DT; ++kk) {
      const Frag<4> qa = load_a<LD>(sq, warp * 16, kk * 8, g, c);
      mma3_row<NT>(s, qa, [&](int j) { return load_b_nk<LD>(kt, j * 8, kk * 8, g, c); });
    }

    // a tile inside the band for every row of the CTA needs no mask
    const bool full = k0 + BN <= a.T &&
                      all_visible(a.causal, a.window, i_lo, i_hi, k0, k0 + BN - 1);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * a.scale;
        if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
        if (!full) {
          const int kp = k0 + j * 8 + 2 * c + (e & 1);
          if (kp >= a.T)
            x = -INFINITY;  // past the keys: weight exactly 0
          else if (!visible(a.causal, a.window, pos[e / 2], kp))
            x = MASKED;
        }
        s[j][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      const float alpha = exp_fast(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        o[j][2 * r] *= alpha;
        o[j][2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp_fast(s[j][e] - m[e / 2]);
        l[e / 2] += p;
        s[j][e] = p;
      }
    }

#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      const Frag<4> pa = c_as_a(s[kk]);
      mma3_row<DT>(o, pa, [&](int j) { return load_b_kn<LDV>(vt, kk * 8, j * 8, g, c); });
    }
  }
  cp_async_wait<0>();  // no copy may outlive the CTA (n_tiles = 0 leaves q in flight)

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sum = fmaxf(quad_sum(l[r]), 1e-30f);
    if (!live[r]) continue;
    const float inv = 1.f / sum;
    float* op = a.o + b * a.os.b + head[r] * a.os.h + pos[r] * a.os.s + 2 * c;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      store2(op + 8 * j, o[j][2 * r] * inv, o[j][2 * r + 1] * inv, a.vec);
    if (a.lse != nullptr && c == 0) a.lse[(b * a.H + head[r]) * a.S + pos[r]] = m[r] + logf(sum);
  }
}

template <int HD>
cudaError_t launch(const Args& a, long long B, long long KVH, cudaStream_t stream) {
  constexpr size_t smem = Tile<HD>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_mma_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((static_cast<long long>(a.G) * a.S + BM - 1) / BM),
                  static_cast<unsigned>(KVH), static_cast<unsigned>(B));
  flash_fwd_mma_kernel<HD><<<grid, THREADS, smem, stream>>>(a);
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
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse = lse;
  a.H = H;
  a.G = static_cast<int>(H / KVH);
  a.S = static_cast<int>(S);
  a.T = static_cast<int>(T);
  a.qs = qs;
  a.ks = ks;
  a.vs = vs;
  a.os = os;
  a.scale = scale;
  a.softcap = softcap;
  a.causal = causal;
  a.window = window32(window);
  a.vec = rows_aligned16(q, qs) && rows_aligned16(k, ks) && rows_aligned16(v, vs) &&
          rows_aligned16(o, os);
  a.tma = rows_map(&a.tk, k, B, KVH, T, hd, ks, BN) && rows_map(&a.tv, v, B, KVH, T, hd, vs, BN);
  switch (hd) {
    case 16:
      return launch<16>(a, B, KVH, stream);
    case 64:
      return launch<64>(a, B, KVH, stream);
    case 80:
      return launch<80>(a, B, KVH, stream);
    case 128:
      return launch<128>(a, B, KVH, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// 1 when the rows of a (B, heads, rows, hd) view with these batch, head and
// sequence strides (in elements) are copied by TMA in these kernels, 0 when
// by cp.async (rows not 16-byte aligned, or the driver refuses the map)
extern "C" int flash_rows_tma(const float* base, long long B, long long heads, long long rows,
                              long long hd, long long sb, long long sh, long long ss) {
  CUtensorMap map;
  return rows_map(&map, base, B, heads, rows, hd, Strides{sb, sh, ss}, BN) ? 1 : 0;
}
