// Forward GQA attention with an online softmax, float32 arithmetic on the
// tensor cores of sm_90a: float32 inputs by 3xTF32 mma.sync, bfloat16
// inputs by bfloat16 mma.sync (their products exact in float32).
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
// template parameter (8, 16, 32, 64, 80, 128: the configs', the LM
// example's and the reference kernel's test widths; hd 8 is one k-step of
// m16n8k8); the wrapper raises on any other.
//
// bfloat16 (flash_fwd_bf16_kernel).  As the TPU kernel does, the
// arithmetic is float32 on bfloat16 q, k and v, lse float32, and the output
// is rounded to bfloat16 (to nearest even) as it is written.  Its bound at
// qwen2's prefill: 2-byte inputs halve the bytes, and a product of two
// bfloat16 values is exact in float32, so q k^T needs one bfloat16 tensor-
// core product (989 TFLOP/s) where float32 needs three TF32 ones: the
// operations, q k^T plus the P V mix below.  Design: the float32 kernel's
// CTA (64 packed rows, four warps of 16, online softmax in registers) with
// raw bfloat16 tiles (tc_bf16.cuh): K and V tiles of 64 keys land by TMA
// (bfloat16 maps over the same strided views, swizzled so that ldmatrix
// reads are free of bank conflicts) in a ring of two stages on mbarriers,
// the next tile in flight under a tile's products; q lands
// once by one TMA box of the KV head's G query heads by whole positions,
// which holds the 64 packed rows in order from row p0 % G.  Where the
// driver refuses a map (or G > 64: the box would pass 128 rows) the rows
// come by 16-byte cp.async into the same layout, and rows off 16 bytes by
// plain loads.  S = q K^T is one mma.sync m16n8k16 bfloat16 product per
// fragment (float32 sums; hd 8 is zero-padded to 16 by the copies), with
// fragments by ldmatrix; P (float32) goes into P V as its bfloat16 high
// and low parts, two products against V (ldmatrix.trans), within 2^-17 of
// P's own products: wgmma is left out for the same reasons as above (P
// from registers, V's transposed operand), and one TF32 P (two products of
// P's halves by V at m16n8k8) takes twice the instructions of the
// bfloat16 split at half the rate.  Masks, the GQA mapping, the softmax
// and the stores are the float32 kernel's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "tc_bf16.cuh"

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
  float* o;
  float* lse;
  long long H;
  int G, S, T;
  Strides qs, ks, vs, os;
  float scale, softcap;  // softcap <= 0: none
  int causal, window;    // window <= 0: none
  int vec;               // every row of q, k, v and o 16-byte aligned
  int tma;               // k and v tiles by TMA, else by cp.async
};

using flash::store2;  // float32; the bfloat16 overload follows

// x0, x1 rounded to bfloat16 at p[0], p[1]: one 4-byte store where o's rows
// are 4-byte aligned (vec; p is then 4-byte aligned)
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x0, float x1, bool vec) {
  if (vec) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
  } else {
    p[0] = __float2bfloat16_rn(x0);
    p[1] = __float2bfloat16_rn(x1);
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_mma_kernel(const __grid_constant__ Args a) {
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
  const float* qb = a.q + b * a.qs.b + kvh * a.G * a.qs.h;
  stage_packed<HD, LD, THREADS>(sq, BM, a.vec, qb, a.qs.h, a.qs.s, a.G, p0, rows);
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

// --- bfloat16: raw bfloat16 tiles, bfloat16 tensor-core products ------------

constexpr int BN_BF = 64;  // keys per K/V tile
constexpr int QROWS = 2 * BM;  // rows of the q tile: a TMA box of whole positions

template <int HD>
struct BfCfg {
  using L = BfTile<HD>;
  static constexpr int NST = 2;  // K/V ring depth (three: slower, tests/bf16_variants.py)
  static constexpr unsigned QBYTES = L::bytes(QROWS);
  static constexpr unsigned KVBYTES = L::bytes(BN_BF);  // one of K or V
  // 1,024 of alignment slack, q, the ring, NST + 1 mbarriers
  static constexpr size_t SMEM = 1024 + QBYTES + 2 * NST * KVBYTES + 8 * (NST + 1);
};

struct ArgsBf {
  CUtensorMap tq[2], tk[2], tv[2];  // per panel (when by TMA)
  const __nv_bfloat16 *q, *k, *v;
  __nv_bfloat16* o;
  float* lse;
  long long H;
  int G, S, T;
  Strides qs, ks, vs, os;
  float scale, softcap;  // softcap <= 0: none
  int causal, window;    // window <= 0: none
  int vec;               // o's rows 4-byte aligned (paired stores)
  int q_mode, kv_mode;   // STAGE_*: how q and the K/V tiles reach shared memory
  int q_pos;             // positions per q box (TMA): (BM - 1) / G + 2
};

// How rows reach shared memory: a TMA box; 16-byte cp.async where every row
// is on 16 bytes but the driver refuses the map (or q's box of whole
// positions is over QROWS rows: G > 64); plain 2-byte loads where a row is
// not on 16 bytes (neither copy takes an address off 16 bytes; a bfloat16
// row may start on any even byte)
enum { STAGE_PLAIN = 0, STAGE_CP_ASYNC = 1, STAGE_TMA = 2 };

// rows r < n_rows of a tile of ROWS rows from src_of(r) (null: zero-filled),
// by 16-byte cp.async or plain loads; hd 8's padding chunk is zero-filled;
// `any` is a valid address for the empty copies
template <int HD, int ROWS, class SrcOf>
__device__ __forceinline__ void stage_bf16(unsigned char* dst, int n_rows, int mode,
                                           const __nv_bfloat16* any, SrcOf src_of) {
  using L = BfTile<HD>;
  for (int i = threadIdx.x; i < n_rows * L::CHUNKS; i += THREADS) {
    const int r = i / L::CHUNKS, ch = i % L::CHUNKS;
    const __nv_bfloat16* src = src_of(r);
    const bool live = src != nullptr && ch * 8 < HD;
    unsigned char* d = dst + L::template off<ROWS>(r, ch);
    if (mode == STAGE_CP_ASYNC) {
      cp_async16(d, live ? src + ch * 8 : any, live);
    } else {
      alignas(16) __nv_bfloat16 x[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = live ? src[ch * 8 + e] : __float2bfloat16_rn(0.f);
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(x);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_bf16_kernel(const __grid_constant__ ArgsBf a) {
  using L = BfTile<HD>;
  using K = BfCfg<HD>;
  constexpr int NST = K::NST, NT = BN_BF / 8, DT = HD / 8, KS = L::HDP / 16;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  unsigned char* sq = base;                    // [QROWS] rows of q
  unsigned char* skv = base + K::QBYTES;       // stage st: K at st * 2 KVBYTES, V after it
  uint64_t* full = reinterpret_cast<uint64_t*>(skv + 2 * NST * K::KVBYTES);  // [NST]
  uint64_t* qbar = full + NST;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const long long kvh = blockIdx.y, b = blockIdx.z;
  const int rows = a.G * a.S;
  // the last rows first: under a causal mask they see the most keys
  const int p0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int i_lo = p0 / a.G, i_hi = (min(rows, p0 + BM) - 1) / a.G;
  int k_lo = 0, k_hi = a.T;
  if (a.causal) k_hi = min(a.T, i_hi + 1);
  if (a.window > 0) k_lo = max(0, i_lo - a.window + 1);
  const int k_first = (k_lo / BN_BF) * BN_BF;
  const int n_tiles = k_hi > k_first ? (k_hi - k_first + BN_BF - 1) / BN_BF : 0;
  // q row p0 + r sits at tile row qoff + r: a TMA box starts at position i_lo
  const int qoff = a.q_mode == STAGE_TMA ? p0 - i_lo * a.G : 0;

  const __nv_bfloat16* kb = a.k + b * a.ks.b + kvh * a.ks.h;
  const __nv_bfloat16* vb = a.v + b * a.vs.b + kvh * a.vs.h;
  // starts tile n's K and V rows into ring stage st (cp.async: one group)
  auto issue_kv = [&](int n, int st) {
    const int k0 = k_first + n * BN_BF;
    unsigned char* kd = skv + 2 * st * K::KVBYTES;
    unsigned char* vd = kd + K::KVBYTES;
    if (a.kv_mode == STAGE_TMA) {
      if (threadIdx.x == 0) {
        mbar_expect(&full[st], 2u * 2 * L::HDP * BN_BF);  // K and V, both panels
        const int h = static_cast<int>(kvh), bb = static_cast<int>(b);
        tma_box(kd, &a.tk[0], 0, k0, h, bb, &full[st]);
        tma_box(vd, &a.tv[0], 0, k0, h, bb, &full[st]);
        if constexpr (L::W1 > 0) {
          constexpr unsigned P1 = align1024(2u * L::W0 * BN_BF);
          tma_box(kd + P1, &a.tk[1], L::W0, k0, h, bb, &full[st]);
          tma_box(vd + P1, &a.tv[1], L::W0, k0, h, bb, &full[st]);
        }
      }
    } else {
      stage_bf16<HD, BN_BF>(kd, BN_BF, a.kv_mode, a.k, [&](int r) -> const __nv_bfloat16* {
        return k0 + r < a.T ? kb + (k0 + r) * a.ks.s : nullptr;
      });
      stage_bf16<HD, BN_BF>(vd, BN_BF, a.kv_mode, a.v, [&](int r) -> const __nv_bfloat16* {
        return k0 + r < a.T ? vb + (k0 + r) * a.vs.s : nullptr;
      });
    }
  };

  if (threadIdx.x == 0) {
    for (int st = 0; st <= NST; ++st) mbar_init(&full[st]);  // full[NST] is qbar
  }
  __syncthreads();  // the barriers are set up before any copy counts on them

  // q once: the G heads' rows of positions i_lo .. in one box (packed rows)
  const __nv_bfloat16* qb = a.q + b * a.qs.b + kvh * a.G * a.qs.h;
  if (a.q_mode == STAGE_TMA) {
    if (threadIdx.x == 0) {
      mbar_expect(qbar, static_cast<unsigned>(2 * L::HDP * a.G * a.q_pos));
      const int h0 = static_cast<int>(kvh) * a.G, bb = static_cast<int>(b);
      tma_box(sq, &a.tq[0], 0, h0, i_lo, bb, qbar);
      if constexpr (L::W1 > 0)
        tma_box(sq + align1024(2u * L::W0 * QROWS), &a.tq[1], L::W0, h0, i_lo, bb, qbar);
    }
  } else {
    stage_bf16<HD, QROWS>(sq, BM, a.q_mode, a.q, [&](int r) -> const __nv_bfloat16* {
      const int p = p0 + r, i = p / a.G;
      return p < rows ? qb + (p - i * a.G) * a.qs.h + i * a.qs.s : nullptr;
    });
    cp_async_commit();
  }
  // the ring's first NST - 1 tiles (cp.async: one group each, empty or not)
  for (int n = 0; n < NST - 1; ++n) {
    if (n < n_tiles) issue_kv(n, n);
    if (a.kv_mode == STAGE_CP_ASYNC) cp_async_commit();
  }
  if (a.q_mode == STAGE_TMA)
    mbar_wait(qbar, 0);
  else if (a.kv_mode != STAGE_CP_ASYNC)
    cp_async_wait<0>();  // q's group alone (the CTA barrier in the loop publishes it)

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
  // ldmatrix row addresses: lane l gives row l % 8 of matrix l / 8
  const int lr = lane & 7, lm = lane >> 3;
  const unsigned qs_addr = smem_addr(sq), kv_addr = smem_addr(skv);
  const int q_row = qoff + warp * 16 + (lm & 1) * 8 + lr;  // A: rows 0-7, 8-15, 0-7, 8-15

  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {MASKED, MASKED}, l[2] = {0.f, 0.f};  // l: this lane's share of the row sum

  for (int n = 0; n < n_tiles; ++n) {
    const int st = n % NST;
    if (a.kv_mode == STAGE_TMA)
      mbar_wait(&full[st], static_cast<unsigned>((n / NST) & 1));
    else if (a.kv_mode == STAGE_CP_ASYNC)
      cp_async_wait<NST - 2>();  // q's group and tile n's are in
    __syncthreads();  // tile n is in for every thread; every warp is done with tile n - 1
    if (n + NST - 1 < n_tiles) issue_kv(n + NST - 1, (n + NST - 1) % NST);  // tile n - 1's stage
    if (a.kv_mode == STAGE_CP_ASYNC) cp_async_commit();

    const unsigned kt = kv_addr + 2 * st * K::KVBYTES, vt = kt + K::KVBYTES;
    const int k0 = k_first + n * BN_BF;
    // S = q K^T: bfloat16 products, exact in float32, summed in float32
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4];
      ldsm_x4(qa, qs_addr + L::template off<QROWS>(q_row, 2 * kk + (lm >> 1)));
#pragma unroll
      for (int jn = 0; jn < NT / 2; ++jn) {
        // keys jn 16 + 0-7, 0-7, 8-15, 8-15; hd chunks 2 kk, 2 kk + 1, 2 kk, 2 kk + 1
        uint32_t kf[4];
        ldsm_x4(kf, kt + L::template off<BN_BF>(jn * 16 + (lm >> 1) * 8 + lr, 2 * kk + (lm & 1)));
        mma_bf16(s[2 * jn], qa, kf[0], kf[1]);
        mma_bf16(s[2 * jn + 1], qa, kf[2], kf[3]);
      }
    }

    // a tile inside the band for every row of the CTA needs no mask
    const bool full_tile = k0 + BN_BF <= a.T &&
                           all_visible(a.causal, a.window, i_lo, i_hi, k0, k0 + BN_BF - 1);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * a.scale;
        if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
        if (!full_tile) {
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

    // O += P V: P (float32) as its bfloat16 high and low parts, two products
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
      // keys kk 16 + 0-7, 8-15, 0-7, 8-15; hd chunks 2 jd, 2 jd, 2 jd + 1, 2 jd + 1
      const int v_row = kk * 16 + (lm & 1) * 8 + lr;
      if constexpr (DT == 1) {
        uint32_t vf[2];
        ldsm_x2_trans(vf, vt + L::template off<BN_BF>(v_row, 0));
        mma_bf16(o[0], pl, vf[0], vf[1]);
        mma_bf16(o[0], ph, vf[0], vf[1]);
      } else {
#pragma unroll
        for (int jd = 0; jd < DT / 2; ++jd) {
          uint32_t vf[4];
          ldsm_x4_trans(vf, vt + L::template off<BN_BF>(v_row, 2 * jd + (lm >> 1)));
          mma_bf16(o[2 * jd], pl, vf[0], vf[1]);
          mma_bf16(o[2 * jd + 1], pl, vf[2], vf[3]);
          mma_bf16(o[2 * jd], ph, vf[0], vf[1]);
          mma_bf16(o[2 * jd + 1], ph, vf[2], vf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy may outlive the CTA

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sum = fmaxf(quad_sum(l[r]), 1e-30f);
    if (!live[r]) continue;
    const float inv = 1.f / sum;
    __nv_bfloat16* op = a.o + b * a.os.b + head[r] * a.os.h + pos[r] * a.os.s + 2 * c;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      store2(op + 8 * j, o[j][2 * r] * inv, o[j][2 * r + 1] * inv, a.vec);
    if (a.lse != nullptr && c == 0) a.lse[(b * a.H + head[r]) * a.S + pos[r]] = m[r] + logf(sum);
  }
}

// --- launch ------------------------------------------------------------------

// one CTA per (BM packed query rows, KV head, batch); the caller has set the
// kernel's shared-memory attribute once (smem_attribute)
template <class A>
cudaError_t launch_grid(void (*kernel)(const A), size_t smem, const A& a, long long B,
                        long long KVH, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((static_cast<long long>(a.G) * a.S + BM - 1) / BM),
                  static_cast<unsigned>(KVH), static_cast<unsigned>(B));
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// a kernel's dynamic shared-memory size, set on its first launch only (a
// static per instance): no attribute call on later launches, which a CUDA
// graph captures
template <class A>
cudaError_t smem_attribute(void (*kernel)(const A), size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int HD>
cudaError_t launch(const Args& a, long long B, long long KVH, cudaStream_t stream) {
  static const cudaError_t attr = smem_attribute(flash_fwd_mma_kernel<HD>, Tile<HD>::SMEM);
  if (attr != cudaSuccess) return attr;
  return launch_grid(flash_fwd_mma_kernel<HD>, Tile<HD>::SMEM, a, B, KVH, stream);
}

// the panels' maps of a bfloat16 (B, heads, rows, hd) view given by its
// strides, boxes of box_rows rows (K, V) or of G heads by q_pos positions
// (q: dims {hd, heads, rows, B}); false where any is refused
template <int HD>
bool bf16_maps(CUtensorMap* maps, const __nv_bfloat16* p, long long B, long long heads,
               long long rows, const Strides& s, bool packed, int G, int q_pos) {
  using L = BfTile<HD>;
  auto one = [&](auto panel, CUtensorMap* map) {
    constexpr int W = decltype(panel)::value;
    return packed ? bf16_map<W>(map, p, HD, heads, rows, B, s.h, s.s, s.b, G, q_pos)
                  : bf16_map<W>(map, p, HD, rows, heads, B, s.s, s.h, s.b, BN_BF, 1);
  };
  if (!one(std::integral_constant<int, L::W0>{}, &maps[0])) return false;
  if constexpr (L::W1 > 0) return one(std::integral_constant<int, L::W1>{}, &maps[1]);
  return true;
}

// every row of a bfloat16 view starts on 4 bytes
inline bool rows_aligned4(const void* p, const Strides& s) {
  return (reinterpret_cast<uintptr_t>(p) & 3) == 0 && s.b % 2 == 0 && s.h % 2 == 0 &&
         s.s % 2 == 0;
}

template <int HD>
cudaError_t launch_bf16(ArgsBf& a, long long B, long long KVH, cudaStream_t stream) {
  // K and V by TMA, else cp.async, else plain loads
  const bool kv_maps = bf16_maps<HD>(a.tk, a.k, B, KVH, a.T, a.ks, false, 0, 0) &&
                       bf16_maps<HD>(a.tv, a.v, B, KVH, a.T, a.vs, false, 0, 0);
  a.kv_mode = kv_maps ? STAGE_TMA
              : rows_aligned16_bf16(a.k, a.ks) && rows_aligned16_bf16(a.v, a.vs)
                  ? STAGE_CP_ASYNC
                  : STAGE_PLAIN;
  // q: a box of G heads by q_pos positions holds any 64 packed rows when it
  // fits the q tile
  a.q_pos = (BM - 1) / a.G + 2;
  const bool q_map = a.G * a.q_pos <= QROWS &&
                     bf16_maps<HD>(a.tq, a.q, B, a.H, a.S, a.qs, true, a.G, a.q_pos);
  a.q_mode = q_map ? STAGE_TMA : rows_aligned16_bf16(a.q, a.qs) ? STAGE_CP_ASYNC : STAGE_PLAIN;
  static const cudaError_t attr = smem_attribute(flash_fwd_bf16_kernel<HD>, BfCfg<HD>::SMEM);
  if (attr != cudaSuccess) return attr;
  return launch_grid(flash_fwd_bf16_kernel<HD>, BfCfg<HD>::SMEM, a, B, KVH, stream);
}

template <class A>
void fill_common(A& a, float* lse, long long H, long long KVH, long long S, long long T,
                 const Strides& qs, const Strides& ks, const Strides& vs, const Strides& os,
                 float scale, int causal, long long window, float softcap) {
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
}

template <template <int> class Launch, class A>
cudaError_t by_head_dim(long long hd, A& a, long long B, long long KVH, cudaStream_t stream) {
  switch (hd) {
    case 8:
      return Launch<8>::run(a, B, KVH, stream);
    case 16:
      return Launch<16>::run(a, B, KVH, stream);
    case 32:
      return Launch<32>::run(a, B, KVH, stream);
    case 64:
      return Launch<64>::run(a, B, KVH, stream);
    case 80:
      return Launch<80>::run(a, B, KVH, stream);
    case 128:
      return Launch<128>::run(a, B, KVH, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int HD>
struct LaunchF32 {
  static cudaError_t run(Args& a, long long B, long long KVH, cudaStream_t stream) {
    return launch<HD>(a, B, KVH, stream);
  }
};

template <int HD>
struct LaunchBf16 {
  static cudaError_t run(ArgsBf& a, long long B, long long KVH, cudaStream_t stream) {
    return launch_bf16<HD>(a, B, KVH, stream);
  }
};

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
  fill_common(a, lse, H, KVH, S, T, qs, ks, vs, os, scale, causal, window, softcap);
  a.vec = rows_aligned16(q, qs) && rows_aligned16(k, ks) && rows_aligned16(v, vs) &&
          rows_aligned16(o, os);
  a.tma = rows_map(&a.tk, k, B, KVH, T, hd, ks, BN) && rows_map(&a.tv, v, B, KVH, T, hd, vs, BN);
  return by_head_dim<LaunchF32>(hd, a, B, KVH, stream);
}

// The same with bfloat16 q, k, v and o (lse float32).
extern "C" int flash_fwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                              const __nv_bfloat16* v, __nv_bfloat16* o, float* lse,
                              long long B, long long H, long long KVH, long long S,
                              long long T, long long hd,
                              long long q_sb, long long q_sh, long long q_ss,
                              long long k_sb, long long k_sh, long long k_ss,
                              long long v_sb, long long v_sh, long long v_ss,
                              long long o_sb, long long o_sh, long long o_ss,
                              float scale, int causal, long long window, float softcap,
                              cudaStream_t stream) {
  const Strides os{o_sb, o_sh, o_ss};
  ArgsBf a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  fill_common(a, lse, H, KVH, S, T, Strides{q_sb, q_sh, q_ss}, Strides{k_sb, k_sh, k_ss},
              Strides{v_sb, v_sh, v_ss}, os, scale, causal, window, softcap);
  a.vec = rows_aligned4(o, os);
  return by_head_dim<LaunchBf16>(hd, a, B, KVH, stream);
}

// 1 when the rows of a (B, heads, rows, hd) view with these batch, head and
// sequence strides (in elements) are copied by TMA in these kernels, 0 when
// by cp.async or, for bfloat16 rows off 16 bytes, plain loads (the rows'
// alignment, or the driver refuses the map); elem_bytes 4 (float32, the
// forward's and backward's K/V tiles) or 2 (bfloat16, the forward's K/V
// tiles)
extern "C" int flash_rows_tma(const void* base, long long B, long long heads, long long rows,
                              long long hd, long long sb, long long sh, long long ss,
                              long long elem_bytes) {
  const Strides s{sb, sh, ss};
  CUtensorMap maps[2];
  if (elem_bytes == 4)
    return rows_map(maps, static_cast<const float*>(base), B, heads, rows, hd, s, BN) ? 1 : 0;
  const auto* p = static_cast<const __nv_bfloat16*>(base);
  bool ok = false;
  switch (hd) {
    case 8: ok = bf16_maps<8>(maps, p, B, heads, rows, s, false, 0, 0); break;
    case 16: ok = bf16_maps<16>(maps, p, B, heads, rows, s, false, 0, 0); break;
    case 32: ok = bf16_maps<32>(maps, p, B, heads, rows, s, false, 0, 0); break;
    case 64: ok = bf16_maps<64>(maps, p, B, heads, rows, s, false, 0, 0); break;
    case 80: ok = bf16_maps<80>(maps, p, B, heads, rows, s, false, 0, 0); break;
    case 128: ok = bf16_maps<128>(maps, p, B, heads, rows, s, false, 0, 0); break;
    default: break;
  }
  return ok ? 1 : 0;
}
