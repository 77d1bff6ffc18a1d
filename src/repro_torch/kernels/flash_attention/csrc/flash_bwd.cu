// Backward of the forward GQA attention (flash_fwd.cu), float32, for sm_90a:
// the FlashAttention-2 backward on the tensor cores (3xTF32 mma.sync).
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
// What bounds it: five products of 2 hd operations per visible pair (the
// scores recomputed, dO v^T, P^T dO, dS^T q, dS k) against (4 S H + 4 T
// KVH) hd floats moved: the operations at S = 512, each float32 product
// taken as three TF32 tensor-core products (tc_tf32.cuh), so 3 x operations
// at the TF32 rate; as in the forward, latency and instruction issue bind
// well before the tensor cores.  At qwen2-0.5b's training shape (B 2, H 14
// over 2, S = T = 64, hd 64) the bound is the bytes, 0.6 us, and the call
// is set by launch latency and by how many CTAs the grid gives the card.
//
// Design, one or two kernels on the stream, no float atomics, so the
// gradients are bitwise the same from run to run:
//   1. bwd_mma, one launch of two independent sets of CTAs side by side,
//      four warps each; each computes the D_i = dO_i . O_i it needs from
//      the dO and o rows it copies (no pre-pass):
//      dK/dV, one CTA per (64-key tile, query head, batch): 28 CTAs at
//      the training shape, where a CTA per KV head would give 4.  Each
//      warp owns 16 keys; their k and v stay in shared memory (split as
//      they are read) and their dK and dV (16 x hd) in registers as mma C
//      fragments.  It walks the head's 32-row query tiles that can see its
//      keys: each tile's q, dO and o rows land by TMA (cp.async where the
//      rows are not 16-byte aligned), q and dO are split once by the CTA
//      and D taken from dO and o, its lse comes by cp.async into one of two
//      buffers, and the next tile's copies run under this tile's products
//      (tc_tf32.cuh).  S^T = k q^T and dP^T = v dO^T go to registers,
//      become P^T and dS^T in place, and feed dV += P^T dO and dK += dS^T q
//      as A operands without a shuffle.  With G > 1 each CTA writes its
//      head's partial dK and dV to a scratch (2, B, H, T, hd) buffer; with
//      G = 1 straight to dk and dv.
//      dQ, one CTA per (64 packed query rows, KV head, batch), rows packed
//      position-major over the G heads of a KV head as in the forward, so
//      each 32-key K/V tile (by TMA and split once by the CTA, as in the
//      forward) is loaded once per group; its q, dO and o rows come once
//      by cp.async.  S = q k^T and dP = dO v^T, then dQ += dS k.
//      Under a causal mask the first key tiles and the last row tiles take
//      longest, so each set starts with them.
//   2. bwd_reduce (G > 1 only): dK and dV of each KV head as the sum of its
//      G heads' partials, in head order.
// Tiles wholly outside the causal/window band are skipped and tiles inside
// it for every pair are not masked, as in the forward.  hd is a template
// parameter (16, 64, 80, 128).

#include <cuda_runtime.h>
#include <math.h>

#include "tc_tf32.cuh"

namespace {

using namespace flash;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BK = 16 * WARPS;    // keys per dK/dV CTA
constexpr int BQ = 16 * WARPS;    // packed query rows per dQ CTA
constexpr int BM = 32;            // query rows per tile of a dK/dV CTA
constexpr int BN = 32;            // keys per K/V tile of a dQ CTA
constexpr int REDUCE_THREADS = 256;

template <int HD>
struct Tile {
  static constexpr int LD = HD + 8;   // shared pitch of tiles read as load_a / load_b_nk
  static constexpr int LD2 = HD + 4;  // of tiles also read as load_b_kn
  // dK/dV: raw q, dO and o (dense), k, v, q and dO split, 2 x lse, D
  static constexpr size_t DKDV_SMEM =
      sizeof(float) * (3 * BM * HD + 2 * BK * LD + 4 * BM * LD2 + 3 * BM);
  // dQ: raw k and v (dense), q, dO, o, k and v split
  static constexpr size_t DQ_SMEM =
      sizeof(float) * (2 * BN * HD + 3 * BQ * LD + 2 * BN * LD2 + 2 * BN * LD);
  // and the copies' barrier
  static constexpr size_t SMEM = (DKDV_SMEM > DQ_SMEM ? DKDV_SMEM : DQ_SMEM) + 16;
};

struct Args {
  CUtensorMap tq, tdo, to, tk, tv;  // q, dO and o rows (dK/dV), k and v rows (dQ), for TMA
  const float *q, *k, *v, *o, *lse, *dout;
  float *dq, *dk, *dv;  // dk, dv: dk and dv themselves (G = 1) or the scratch (G > 1)
  long long H;
  int G, S, T;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;  // dks, dvs: indexed by query head
  float scale, softcap;                    // softcap <= 0: none
  int causal, window;                      // window <= 0: none
  int vec;  // every row of q, k, v, o, dO, dq, dk and dv 16-byte aligned
  int tma;  // q/dO/o and k/v tiles by TMA, else by cp.async
};

// P and dS of one pair from the raw products q.k and dO.v: the forward's
// score (the same operations as flash_fwd.cu), its softmax weight p, and
// d(loss)/d(q.k) through the softcap and the scale.
__device__ __forceinline__ void pair_grad(const Args& a, float qk, float dov, float lse,
                                          float delta, float* p, float* ds) {
  float s = qk * a.scale;
  float dcap = 1.f;
  if (a.softcap > 0.f) {
    const float t = tanhf(s / a.softcap);
    s = a.softcap * t;
    dcap = 1.f - t * t;
  }
  *p = exp_fast(s - lse);
  *ds = *p * (dov - delta) * dcap * a.scale;
}

// dK and dV of keys [x BK, x BK + BK) of query head h, batch b
template <int HD>
__device__ __forceinline__ void dkdv_tile(const Args& a, int x, long long h, long long b,
                                          float* smem) {
  constexpr int LD = Tile<HD>::LD, LD2 = Tile<HD>::LD2;
  constexpr int MT = BM / 8, DT = HD / 8;
  float* qraw = smem;                   // [BM][HD], as copied
  float* doraw = qraw + BM * HD;        // [BM][HD]
  float* oraw = doraw + BM * HD;        // [BM][HD]
  float* sk = oraw + BM * HD;           // [BK][LD]
  float* sv = sk + BK * LD;             // [BK][LD]
  float* qbig = sv + BK * LD;           // [BM][LD2]
  float* qsmall = qbig + BM * LD2;      // [BM][LD2]
  float* dobig = qsmall + BM * LD2;     // [BM][LD2]
  float* dosmall = dobig + BM * LD2;    // [BM][LD2]
  float* slse = dosmall + BM * LD2;     // [2][BM]
  float* sdl = slse + 2 * BM;           // [BM]: D of the tile's rows
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + (Tile<HD>::SMEM - 16) / sizeof(float));

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const long long kvh = h / a.G;
  const int k0 = x * BK;

  // query rows that can see a key of this tile
  int q_lo = 0, q_hi = a.S;
  if (a.causal) q_lo = k0;
  if (a.window > 0) q_hi = min(a.S, min(a.T, k0 + BK) - 1 + a.window);
  const int q_first = (q_lo / BM) * BM;
  const int n_tiles = q_hi > q_first ? (q_hi - q_first + BM - 1) / BM : 0;

  const float* qh = a.q + b * a.qs.b + h * a.qs.h;
  const float* doh = a.dout + b * a.dos.b + h * a.dos.h;
  const float* oh = a.o + b * a.os.b + h * a.os.h;
  const long long row0 = (b * a.H + h) * a.S;
  // starts the copy of query tile n: q, dO and o rows into the raw
  // buffers, lse into its buffer n % 2
  auto copy_q = [&](int n) {
    const int q0 = q_first + n * BM;
    if (a.tma) {
      if (threadIdx.x == 0) {
        mbar_expect(bar, 3 * BM * HD * sizeof(float));
        tma_rows(qraw, &a.tq, q0, static_cast<int>(h), static_cast<int>(b), bar);
        tma_rows(doraw, &a.tdo, q0, static_cast<int>(h), static_cast<int>(b), bar);
        tma_rows(oraw, &a.to, q0, static_cast<int>(h), static_cast<int>(b), bar);
      }
    } else {
      stage_rows<HD, HD, THREADS>(qraw, BM, a.vec, qh, a.qs.s, q0, a.S);
      stage_rows<HD, HD, THREADS>(doraw, BM, a.vec, doh, a.dos.s, q0, a.S);
      stage_rows<HD, HD, THREADS>(oraw, BM, a.vec, oh, a.os.s, q0, a.S);
    }
    for (int i = threadIdx.x; i < BM; i += THREADS) {
      const bool in = q0 + i < a.S;
      cp_async<4>(slse + (n & 1) * BM + i, in ? a.lse + row0 + q0 + i : a.lse, in);
    }
    cp_async_commit();
  };

  if (a.tma && threadIdx.x == 0) mbar_init(bar);
  if (n_tiles > 0) copy_q(0);  // q, dO and o by TMA: in flight while k and v are staged
  const float* kb = a.k + b * a.ks.b + kvh * a.ks.h;
  const float* vb = a.v + b * a.vs.b + kvh * a.vs.h;
  stage_rows<HD, LD, THREADS>(sk, BK, a.vec, kb, a.ks.s, k0, a.T);
  stage_rows<HD, LD, THREADS>(sv, BK, a.vec, vb, a.vs.s, k0, a.T);
  cp_async_commit();
  __syncthreads();  // the barrier is set up before anyone waits on it

  int key[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) key[r] = k0 + warp * 16 + g + 8 * r;

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int n = 0; n < n_tiles; ++n) {
    cp_async_wait<0>();
    if (a.tma) mbar_wait(bar, n & 1);
    __syncthreads();  // tile n is in; every warp is done with tile n - 1
    split_rows<HD, LD2, BM, THREADS>(qraw, qbig, qsmall);
    split_rows<HD, LD2, BM, THREADS>(doraw, dobig, dosmall);
    for (int r = threadIdx.x / 4; r < BM; r += THREADS / 4) {  // D = dO . o, 4 lanes a row
      const float d = row_dot<HD>(doraw + r * HD, oraw + r * HD, threadIdx.x % 4);
      if (threadIdx.x % 4 == 0) sdl[r] = d;
    }
    __syncthreads();  // split; the raw buffers are free
    if (n + 1 < n_tiles) copy_q(n + 1);  // lands under this tile's products
    const Split2 qt{qbig, qsmall}, dot{dobig, dosmall};
    const float* lt = slse + (n & 1) * BM;
    const float* dlt = sdl;
    const int q0 = q_first + n * BM;

    // S^T = k q^T and dP^T = v dO^T: this warp's 16 keys x BM queries
    float st[MT][4], dpt[MT][4];
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DT; ++kk) {
      const Frag<4> ka = load_a<LD>(sk, warp * 16, kk * 8, g, c);
      mma3_row<MT>(st, ka, [&](int j) { return load_b_nk<LD2>(qt, j * 8, kk * 8, g, c); });
      const Frag<4> va = load_a<LD>(sv, warp * 16, kk * 8, g, c);
      mma3_row<MT>(dpt, va, [&](int j) { return load_b_nk<LD2>(dot, j * 8, kk * 8, g, c); });
    }
    // P^T and dS^T in place; a tile inside the band needs no mask
    const bool full = q0 + BM <= a.S && k0 + BK <= a.T &&
                      all_visible(a.causal, a.window, q0, q0 + BM - 1, k0, k0 + BK - 1);
#pragma unroll
    for (int j = 0; j < MT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * c + (e & 1);
        float p = 0.f, ds = 0.f;
        if (full || (q0 + col < a.S && key[e / 2] < a.T &&
                     visible(a.causal, a.window, q0 + col, key[e / 2])))
          pair_grad(a, st[j][e], dpt[j][e], lt[col], dlt[col], &p, &ds);
        st[j][e] = p;
        dpt[j][e] = ds;
      }
    }
    // dV += P^T dO, dK += dS^T q
#pragma unroll
    for (int kk = 0; kk < MT; ++kk) {
      const Frag<4> pa = c_as_a(st[kk]);
      mma3_row<DT>(dv, pa, [&](int j) { return load_b_kn<LD2>(dot, kk * 8, j * 8, g, c); });
      const Frag<4> dsa = c_as_a(dpt[kk]);
      mma3_row<DT>(dk, dsa, [&](int j) { return load_b_kn<LD2>(qt, kk * 8, j * 8, g, c); });
    }
  }
  cp_async_wait<0>();  // no copy may outlive the CTA (n_tiles = 0 leaves k and v in flight)

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= a.T) continue;
    float* dkp = a.dk + b * a.dks.b + h * a.dks.h + key[r] * a.dks.s + 2 * c;
    float* dvp = a.dv + b * a.dvs.b + h * a.dvs.h + key[r] * a.dvs.s + 2 * c;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      store2(dkp + 8 * j, dk[j][2 * r], dk[j][2 * r + 1], a.vec);
      store2(dvp + 8 * j, dv[j][2 * r], dv[j][2 * r + 1], a.vec);
    }
  }
}

// dQ of packed rows [x BQ, x BQ + BQ) of KV head kvh, batch b
template <int HD>
__device__ __forceinline__ void dq_tile(const Args& a, int x, long long kvh, long long b,
                                        float* smem) {
  constexpr int LD = Tile<HD>::LD, LD2 = Tile<HD>::LD2;
  constexpr int NT = BN / 8, DT = HD / 8;
  float* kraw = smem;                  // [BN][HD], as copied
  float* vraw = kraw + BN * HD;        // [BN][HD]
  float* sq = vraw + BN * HD;          // [BQ][LD]
  float* sdo = sq + BQ * LD;           // [BQ][LD]
  float* so = sdo + BQ * LD;           // [BQ][LD]
  float* kbig = so + BQ * LD;          // [BN][LD2]
  float* ksmall = kbig + BN * LD2;     // [BN][LD2]
  float* vbig = ksmall + BN * LD2;     // [BN][LD]
  float* vsmall = vbig + BN * LD;      // [BN][LD]
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + (Tile<HD>::SMEM - 16) / sizeof(float));

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int rows = a.G * a.S;
  const int p0 = x * BQ;

  // keys any row of this tile can see (the forward's band)
  const int i_lo = p0 / a.G, i_hi = (min(rows, p0 + BQ) - 1) / a.G;
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
  if (n_tiles > 0) copy_kv(0);  // by TMA: in flight while q, dO and o are staged
  stage_packed<HD, LD, THREADS>(sq, BQ, a.vec, a.q + b * a.qs.b + kvh * a.G * a.qs.h, a.qs.h,
                                a.qs.s, a.G, p0, rows);
  stage_packed<HD, LD, THREADS>(sdo, BQ, a.vec, a.dout + b * a.dos.b + kvh * a.G * a.dos.h,
                                a.dos.h, a.dos.s, a.G, p0, rows);
  stage_packed<HD, LD, THREADS>(so, BQ, a.vec, a.o + b * a.os.b + kvh * a.G * a.os.h, a.os.h,
                                a.os.s, a.G, p0, rows);
  cp_async_commit();
  __syncthreads();  // the barrier is set up before anyone waits on it

  int pos[2];
  long long head[2];
  bool live[2];
  float lse[2], delta[2] = {0.f, 0.f};  // delta: D = dO . o of the rows, with the first tile
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int p = p0 + warp * 16 + g + 8 * r;
    live[r] = p < rows;
    pos[r] = p / a.G;
    head[r] = kvh * a.G + p % a.G;
    lse[r] = live[r] ? a.lse[(b * a.H + head[r]) * a.S + pos[r]] : 0.f;
  }

  float dq[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  for (int n = 0; n < n_tiles; ++n) {
    cp_async_wait<0>();
    if (a.tma) mbar_wait(bar, n & 1);
    __syncthreads();  // tile n is in; every warp is done with tile n - 1
    split_rows<HD, LD2, BN, THREADS>(kraw, kbig, ksmall);
    split_rows<HD, LD, BN, THREADS>(vraw, vbig, vsmall);
    if (n == 0) {  // q, dO and o are in: D of this lane's rows, over its quad
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = warp * 16 + g + 8 * r;
        delta[r] = row_dot<HD>(sdo + row * LD, so + row * LD, c);
      }
    }
    __syncthreads();  // split; the raw buffers are free
    if (n + 1 < n_tiles) copy_kv(n + 1);  // lands under this tile's products
    const Split2 kt{kbig, ksmall}, vt{vbig, vsmall};
    const int k0 = k_first + n * BN;

    // S = q k^T and dP = dO v^T: this warp's 16 rows x BN keys
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DT; ++kk) {
      const Frag<4> qa = load_a<LD>(sq, warp * 16, kk * 8, g, c);
      mma3_row<NT>(s, qa, [&](int j) { return load_b_nk<LD2>(kt, j * 8, kk * 8, g, c); });
      const Frag<4> da = load_a<LD>(sdo, warp * 16, kk * 8, g, c);
      mma3_row<NT>(dp, da, [&](int j) { return load_b_nk<LD>(vt, j * 8, kk * 8, g, c); });
    }
    // dS in place of S; a tile inside the band for every row needs no mask
    const bool full = k0 + BN <= a.T &&
                      all_visible(a.causal, a.window, i_lo, i_hi, k0, k0 + BN - 1);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2, kp = k0 + j * 8 + 2 * c + (e & 1);
        float p = 0.f, ds = 0.f;
        if (full || (live[r] && kp < a.T && visible(a.causal, a.window, pos[r], kp)))
          pair_grad(a, s[j][e], dp[j][e], lse[r], delta[r], &p, &ds);
        s[j][e] = ds;
      }
    }
    // dQ += dS k
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      const Frag<4> dsa = c_as_a(s[kk]);
      mma3_row<DT>(dq, dsa, [&](int j) { return load_b_kn<LD2>(kt, kk * 8, j * 8, g, c); });
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!live[r]) continue;
    float* dqp = a.dq + b * a.dqs.b + head[r] * a.dqs.h + pos[r] * a.dqs.s + 2 * c;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      store2(dqp + 8 * j, dq[j][2 * r], dq[j][2 * r + 1], a.vec);
  }
}

// One launch for both, batch b = blockIdx.y: CTAs x < kv_tiles H each take
// a key tile of dK/dV, the rest a row tile of dQ; the two sets are
// independent and run side by side.  Under a causal mask the first key
// tiles and the last row tiles take longest, so each set starts with them.
template <int HD>
__global__ void __launch_bounds__(THREADS) bwd_mma_kernel(const __grid_constant__ Args a,
                                                          int kv_tiles, int q_tiles) {
  extern __shared__ __align__(128) float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int heads = static_cast<int>(a.H), kv_heads = heads / a.G;
  const long long b = blockIdx.y;
  const int i = blockIdx.x;
  if (i < kv_tiles * heads)
    dkdv_tile<HD>(a, i / heads, i % heads, b, smem);
  else
    dq_tile<HD>(a, q_tiles - 1 - (i - kv_tiles * heads) / kv_heads,
                (i - kv_tiles * heads) % kv_heads, b, smem);
}

// out[y] (B, KVH, T, hd), strided, = the sum over g of part[y] (B, KVH G,
// T, hd) contiguous, in g order; y = 0: dK, 1: dV
__global__ void bwd_reduce_kernel(const float* __restrict__ part, float* __restrict__ dk,
                                  float* __restrict__ dv, long long B, long long KVH,
                                  long long G, long long T, long long hd, Strides dks,
                                  Strides dvs) {
  const long long n = B * KVH * T * hd;
  const long long idx = static_cast<long long>(blockIdx.x) * REDUCE_THREADS + threadIdx.x;
  if (idx >= n) return;
  const long long d = idx % hd, t = (idx / hd) % T, kvh = (idx / (hd * T)) % KVH,
                  b = idx / (hd * T * KVH);
  const long long head_stride = T * hd;
  const float* src = part + blockIdx.y * B * KVH * G * head_stride +
                     ((b * KVH + kvh) * G * T + t) * hd + d;
  float acc = src[0];
  for (long long i = 1; i < G; ++i) acc += src[i * head_stride];
  if (blockIdx.y == 0)
    dk[b * dks.b + kvh * dks.h + t * dks.s + d] = acc;
  else
    dv[b * dvs.b + kvh * dvs.h + t * dvs.s + d] = acc;
}

template <int HD>
cudaError_t launch(Args a, float* dk, float* dv, Strides dks, Strides dvs, float* part,
                   long long B, long long KVH, cudaStream_t stream) {
  if (a.G > 1) {  // per-head partials into the scratch (2, B, H, T, hd)
    const long long head = a.T * HD;
    a.dk = part;
    a.dv = part + B * a.H * head;
    a.dks = a.dvs = Strides{a.H * head, head, HD};
  } else {
    a.dk = dk;
    a.dv = dv;
    a.dks = dks;
    a.dvs = dvs;
  }
  constexpr size_t smem = Tile<HD>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int kv_tiles = (a.T + BK - 1) / BK;
  const int q_tiles = static_cast<int>((static_cast<long long>(a.G) * a.S + BQ - 1) / BQ);
  const dim3 grid(static_cast<unsigned>(kv_tiles * a.H + q_tiles * KVH),
                  static_cast<unsigned>(B));
  bwd_mma_kernel<HD><<<grid, THREADS, smem, stream>>>(a, kv_tiles, q_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.G == 1) return err;

  const long long n = B * KVH * a.T * HD;
  const dim3 r_grid(static_cast<unsigned>((n + REDUCE_THREADS - 1) / REDUCE_THREADS), 2);
  bwd_reduce_kernel<<<r_grid, REDUCE_THREADS, 0, stream>>>(part, dk, dv, B, KVH, a.G, a.T, HD,
                                                           dks, dvs);
  return cudaGetLastError();
}

}  // namespace

// q, o, dout, dq (B, H, S, hd); k, v, dk, dv (B, KVH, T, hd), each given by
// its batch, head and sequence strides in elements (head dims contiguous);
// lse (B, H, S) contiguous; part (scratch) 2 B H T hd
// floats when H > KVH, else unused.  window <= 0: no window; softcap <= 0:
// no cap.  Returns a cudaError_t.
extern "C" int flash_bwd_f32(const float* q, const float* k, const float* v, const float* o,
                             const float* lse, const float* dout, float* part,
                             float* dq, float* dk, float* dv, long long B, long long H,
                             long long KVH, long long S, long long T, long long hd,
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
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_ss}, dos{do_sb, do_sh, do_ss}, dqs{dq_sb, dq_sh, dq_ss},
      dks{dk_sb, dk_sh, dk_ss}, dvs{dv_sb, dv_sh, dv_ss};
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse = lse;
  a.dout = dout;
  a.dq = dq;
  a.H = H;
  a.G = static_cast<int>(H / KVH);
  a.S = static_cast<int>(S);
  a.T = static_cast<int>(T);
  a.qs = qs;
  a.ks = ks;
  a.vs = vs;
  a.os = os;
  a.dos = dos;
  a.dqs = dqs;
  a.scale = scale;
  a.softcap = softcap;
  a.causal = causal;
  a.window = window32(window);
  a.vec = rows_aligned16(q, qs) && rows_aligned16(k, ks) && rows_aligned16(v, vs) &&
          rows_aligned16(o, os) && rows_aligned16(dout, dos) && rows_aligned16(dq, dqs) &&
          rows_aligned16(dk, dks) && rows_aligned16(dv, dvs);
  a.tma = rows_map(&a.tq, q, B, H, S, hd, qs, BM) && rows_map(&a.tdo, dout, B, H, S, hd, dos, BM) &&
          rows_map(&a.to, o, B, H, S, hd, os, BM) && rows_map(&a.tk, k, B, KVH, T, hd, ks, BN) &&
          rows_map(&a.tv, v, B, KVH, T, hd, vs, BN);
#define FLASH_BWD_CASE(HD) \
  case HD:                 \
    return launch<HD>(a, dk, dv, dks, dvs, part, B, KVH, stream);
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
