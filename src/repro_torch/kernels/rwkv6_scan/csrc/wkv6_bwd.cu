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
// sum across them: dr, dk and dw over the columns j of a row, dv over the
// rows i.  The u terms need one scalar per step each, v_t . dy_t and the
// bonus sum_i r_i u_i k_i, and are added to the finished sums.  S_t is
// never rebuilt by dividing by w_t (the model's w = exp(-exp(.)) reaches 0).
//
// What bounds it: per (i, j, t) 14 float operations (the recurrence
// recomputed once, S dy, G's update, G v, G^T k, G (.) S), and per (i, t)
// 16 more for the u terms, against 9 hd floats per (b, h, t) in and out (r,
// k, v, w, dy read; dr, dk, dv, dw written): about 0.39 hd operations per
// byte, at hd 64 25, above the float32 ridge of 20 (67 TFLOP/s over 3.35
// TB/s): the operations, 7.14 us at the training shape (B 2, H 64, T 64,
// hd 64) against 5.6 us for the bytes.  This kernel issues about 11
// instructions per (i, j, t) in its steps (the recurrence twice, once to
// checkpoint and once to recompute, 2 each; dr 1; the reverse step 5; the
// loads and the row sums' shuffles) with two warps per scheduler (the
// chunk's states take ~128 registers a thread), so the schedulers' issue,
// latency at that occupancy and the per-chunk barriers bound it, with the
// first sweep waiting on the first reads of k, w and v from device memory
// (tests/wkv6_bwd_variants.py's probe letter T splits a CTA's time).
//
// Design.  (A first design, one CTA of 8 warps per (b, h) with scalar
// shared-memory accesses for every (i, j, t), synchronous staging and two
// full sweeps, spent a third of its time on the staging;
// tests/wkv6_bwd_variants.py --root measures such a tree.)
// * A cluster of NC CTAs per (b, h), split by columns: CTA cb owns the
//   columns [cb CW, (cb + 1) CW) of S and G (CW = hd / NC), so dv's sums
//   over rows stay inside the CTA; the row sums (dr, dk, dw) are pushed, as
//   they are made, into the shared memory of the CTA that joins the row
//   (rank i / RC, RC = hd / NC), in the slot of the pushing CTA, and joined
//   there once per chunk after a cluster barrier.  At hd 64 NC = 2: 256
//   CTAs of 128 threads at the training shape, two per SM in one wave
//   (NC = 4 measured 2x slower: its 512 CTAs took two waves).
// * Register tiles.  A thread owns 4 rows (a row group rg) x J columns (a
//   column group cg) of S and of G.  Its row slots are permuted by its
//   column-group bits (slot e holds row 4 rg + (e ^ m)), so that a row's
//   sum over the NCG lanes of a row group is a reduce-scatter of
//   __shfl_xor_sync with no selects: after it each lane holds one finished
//   row (two lanes the same row where NCG > 4; one stores it).  r, k and w
//   are read per slot (scalar, each lane its own word: no bank conflict),
//   v and dy as J-vectors.  dv's partial column sums (over a thread's 4
//   rows) go to shared memory as one J-vector per step and are summed over
//   the row groups in order once per chunk.
// * The chunk's states in registers.  Time runs in chunks of C steps.  A
//   first sweep runs S's update alone (2 operations per element) through
//   every chunk but the last and saves S at each chunk's start (the
//   checkpoints, B * H * (ceil(T / C) - 1) * hd^2 floats of scratch the
//   wrapper allocates: 14 MB at the training shape with C = 8), in a
//   thread-private layout (coalesced vector stores).  Then the chunks from
//   the last: the chunk's C states are recomputed from its checkpoint into
//   registers (C x 4 x J floats a thread; the next checkpoint is loaded
//   meanwhile), forming dr_t where S_t is in hand, and the steps are walked
//   backwards with G in registers: no shared-memory traffic per (i, j, t)
//   but the staged inputs.  A full chunk's steps run with no branch between
//   them (the compiler overlaps one step's shuffles with the next's
//   arithmetic); a short last chunk takes a guarded copy.
// * Staging.  The first sweep's k, w and v land by TMA in copies of SCH = 4
//   chunks (one box of 4 C rows per tensor: its steps are too short to
//   cover many small copies), two copies ahead; then the chunks of r, k, w,
//   v and dy from the last, in three shared buffers, two chunks ahead, the
//   last chunk's landing while the sweep runs (a 4-d tensor map per view,
//   rows past T zero-filled, completion on mbarriers; tma_rows.cuh, shared
//   with the forward).  Up to T = 2 SCH C + C the sweep has no CTA barrier.
//   The reverse chunks need one CTA barrier and one cluster barrier each
//   (arrived at before dv's join, waited on after it).  A view whose rows
//   are not on 16 bytes takes the template that loads each chunk with plain
//   loads; a map the CUDA driver refuses is an error.
// * Joins, in fixed orders (no float atomics: two calls give the same
//   bits).  Row sums: in-thread over the J columns (an FMA chain from 0),
//   then the lanes' reduce-scatter (halves added pairwise, the highest lane
//   bit first), then over the cluster's CTAs in rank order; then + u_i k_i
//   (v . dy) for dr, + u_i r_i (v . dy) for dk.  Column sums: in-thread over
//   the slots e = 0..3 (rows 4 rg + (e ^ m)), then over the row groups in
//   order, then + bonus dy_j.  The bonus and v . dy per step: FMA chains
//   over P lanes' float4 groups, then the lanes' tree.  du: per join thread
//   over its steps (chunks from the last, steps rising), then over the join
//   threads of a row in order, then (a second, small kernel) over the
//   batches in order.  tests/test_torch_wkv6_bwd.py models this order on
//   the CPU.
// hd is a template parameter (16: NC 1, J 2, C 16, 32 threads; 64: NC 2, J
// 4, C 8, 128 threads; kernel.py's BWD_SHAPE); the wrapper raises on any
// other.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "tma_rows.cuh"

namespace cg = cooperative_groups;

namespace {

template <int HD>
struct Shape;
template <>
struct Shape<16> {
  static constexpr int NC = 1, J = 2, C = 16;
};
template <>
struct Shape<64> {
  static constexpr int NC = 2, J = 4, C = 8;
};

__host__ __device__ constexpr int log2i(int x) { return x <= 1 ? 0 : 1 + log2i(x / 2); }

template <int HD>
struct Cfg {
  static constexpr int NC = Shape<HD>::NC;  // CTAs per (b, h): the column split
  static constexpr int J = Shape<HD>::J;    // columns per thread
  static constexpr int C = Shape<HD>::C;    // steps per chunk (the checkpoint stride)
  static constexpr int CW = HD / NC;        // columns per CTA
  static constexpr int NCG = CW / J;        // column groups: the lanes of a row group
  static constexpr int NRG = HD / 4;        // row groups of 4 rows
  static constexpr int NT = NCG * NRG;      // threads per CTA
  static constexpr int RC = HD / NC;        // rows each CTA joins across the cluster
  static constexpr int NPART = NT / RC;     // join threads per row
  static constexpr int P = NT / C;          // lanes per step of the scalars pass
  static constexpr int PQ = HD / P / 4;     // float4 per lane of the scalars pass
  static constexpr int LG = log2i(NCG);     // levels of a row's reduce-scatter ...
  static constexpr int LV = LG < 2 ? LG : 2;  // ... halving the 4 row slots
  static constexpr int LB = LG - LV;        // ... then a butterfly
  static constexpr int KEPT = 4 >> LV;      // finished rows per lane
  static constexpr int TILE = C * HD;       // floats of one tensor's chunk
  static constexpr int BUF = 5 * TILE;      // floats of one buffer: r, k, w, v, dy
  static constexpr int RED = 3 * TILE;      // a chunk's row sums of a CTA's rows, from every
                                            // CTA of the cluster: [NC][3][C][RC]
  static constexpr int COLP = C * NRG * CW;  // dv's partials of a chunk
  static constexpr int SCH = 4;            // chunks per copy of the first sweep
  static constexpr int SWEEP = 3 * SCH * TILE;  // one copy of the first sweep: k, w, v
  // the staging area: three buffers, and from the second on the first
  // sweep's two copies
  static constexpr int STAGE = (5 * TILE + 2 * SWEEP > 3 * BUF ? 5 * TILE + 2 * SWEEP : 3 * BUF);
  // the staging area, two chunks of row sums, of dv's partials and of bonus
  // and v.dy per step, du per join thread; then the buffers' and the slots'
  // mbarriers
  static constexpr int FLOATS = STAGE + 2 * RED + 2 * COLP + 4 * C + NT;
  static constexpr int BARS = 5;  // the buffers', the sweep copies' slots'
  static_assert(SCH * C <= 256, "a TMA box takes at most 256 rows");
  static constexpr size_t SMEM =
      sizeof(float) * (FLOATS + (FLOATS & 1)) + BARS * sizeof(uint64_t);
  static_assert(HD % NC == 0 && CW % J == 0 && (J == 1 || J == 2 || J == 4), "tile");
  static_assert((NCG & (NCG - 1)) == 0 && NCG <= 32, "a row group's lanes within a warp");
  static_assert(NT % 32 == 0 && NT <= 1024, "whole warps");
  static_assert(NT % RC == 0 && C % (NT / RC) == 0 && (C * CW) % NT == 0, "join threads");
  static_assert(NT % C == 0 && (P & (P - 1)) == 0 && P <= 32 && HD % (4 * P) == 0,
                "scalars lanes");
};

struct Args {
  CUtensorMap map[8];   // TMA (the TMA template): r, k, w, v, dy by chunks; k, w, v by
                        // the first sweep's copies
  const float* src[5];  // r, k, w, v (strides `in`), dy (strides `dys`)
  const float* u;
  const float* s0;  // (B, H, hd, hd) or null
  const float* ds;  // (B, H, hd, hd) or null
  float* grad[4];   // dr, dk, dw, dv, strides `out`
  float* du_part;   // (B, H, hd)
  float* ds0;       // (B, H, hd, hd) or null
  float* ckpt;      // (B, H, chunks - 1, hd, hd) scratch: the state at each chunk's start but
                    // the first, in a thread-private layout
  long long H, T;
  Strides in, dys, out;
};

// J consecutive floats (aligned to J) as a vector
template <int J>
__device__ __forceinline__ void load_j(const float* p, float (&o)[J]) {
  if constexpr (J == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  } else if constexpr (J == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    o[0] = v.x;
    o[1] = v.y;
  } else {
    o[0] = *p;
  }
}

template <int J>
__device__ __forceinline__ void store_j(float* p, const float (&o)[J]) {
  if constexpr (J == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  } else if constexpr (J == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(o[0], o[1]);
  } else {
    *p = o[0];
  }
}

// thread 0: `count` tiles by TMA, each of `tile` floats from row t0 on of
// (head, batch) of maps[0..count) (their boxes: tile / hd rows), at dst +
// x tile, counted on bar.  A CTA barrier in front of it orders every read
// of dst before these writes; the fence carries that order to the copy
// engine.
__device__ __forceinline__ void tma_tiles(float* dst, const CUtensorMap* maps, int count,
                                          int tile, long long t0, int head, int batch,
                                          uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_expect(bar, static_cast<unsigned>(sizeof(float) * tile * count));
  for (int x = 0; x < count; ++x)
    tma_rows(dst + x * tile, &maps[x], static_cast<int>(t0), head, batch, bar);
}

// every thread: n rows from row t0 on of tensors [x0, x1) of r, k, w, v, dy
// into tiles of `tile` floats at dst with plain loads (the layouts TMA does
// not take); a CTA barrier follows
template <int HD>
__device__ __forceinline__ void load_tiles(float* dst, const Args& a, long long base,
                                           long long dybase, long long t0, int n, int x0,
                                           int x1, int tile) {
  using K = Cfg<HD>;
  for (int idx = threadIdx.x; idx < (x1 - x0) * n * HD; idx += K::NT) {
    const int x = x0 + idx / (n * HD), rem = idx % (n * HD);
    const long long t = t0 + rem / HD;
    const int d = rem % HD;
    dst[(x - x0) * tile + rem] =
        x < 4 ? a.src[x][base + t * a.in.t + d] : a.src[4][dybase + t * a.dys.t + d];
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A row's sums over the NCG lanes of its row group: the first LV levels
// halve the row slots (slot e holds row 4 rg + (e ^ m), m set from the
// lane's column-group bits, so every lane keeps [0, half) and sends [half,
// 2 half)), a butterfly does the rest.  Slots [0, KEPT) end finished.
template <int HD>
__device__ __forceinline__ void row_reduce(float (&p)[4]) {
  using K = Cfg<HD>;
#pragma unroll
  for (int l = 0; l < K::LV; ++l) {
    const int bit = K::NCG >> (l + 1), half = 4 >> (l + 1);
#pragma unroll
    for (int e = 0; e < half; ++e) p[e] += __shfl_xor_sync(0xffffffffu, p[e + half], bit);
  }
#pragma unroll
  for (int l = 0; l < K::LB; ++l) {
    const int bit = K::NCG >> (K::LV + l + 1);
#pragma unroll
    for (int e = 0; e < K::KEPT; ++e) p[e] += __shfl_xor_sync(0xffffffffu, p[e], bit);
  }
}

// the lane's finished rows of p into dst[rows], rows local to the rows' CTA
// (one lane of each butterfly)
template <int HD>
__device__ __forceinline__ void row_store(float* dst, const float (&p)[4], const int (&row)[4],
                                          int cgi) {
  using K = Cfg<HD>;
  if ((cgi & ((1 << K::LB) - 1)) == 0) {
#pragma unroll
    for (int e = 0; e < K::KEPT; ++e) dst[row[e]] = p[e];
  }
}

// One chunk's steps of a thread: the recompute of the states from St[0]
// (dr's partial sums where S_t is in hand, then S_{t+1}), then the reverse
// walk (dk and dw's row sums, dv's column partials, then G).  FULL: all C
// steps, with no branch between them, so the compiler overlaps one step's
// shuffles and stores with the next step's arithmetic; else the first n.
template <int HD, bool FULL>
__device__ __forceinline__ void chunk_steps(float (&St)[Cfg<HD>::C][4][Cfg<HD>::J],
                                            float (&G)[4][Cfg<HD>::J], const float* cur,
                                            float* rd, float* colp, const int (&row)[4],
                                            const int (&rowl)[4], int col0, int rg, int cgi,
                                            int n) {
  using K = Cfg<HD>;
  constexpr int J = K::J, C = K::C, TILE = K::TILE, NRG = K::NRG, CW = K::CW;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (FULL || c < n) {
      float v[J], dy[J], p[4];
      load_j<J>(cur + 3 * TILE + c * HD + col0, v);
      load_j<J>(cur + 4 * TILE + c * HD + col0, dy);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = 0.f;
#pragma unroll
        for (int jj = 0; jj < J; ++jj) p[e] = fmaf(St[c][e][jj], dy[jj], p[e]);
      }
      if (c + 1 < C) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float ki = cur[TILE + c * HD + row[e]], wi = cur[2 * TILE + c * HD + row[e]];
#pragma unroll
          for (int jj = 0; jj < J; ++jj)
            St[(c + 1) % C][e][jj] = fmaf(wi, St[c][e][jj], ki * v[jj]);
        }
      }
      row_reduce<HD>(p);
      row_store<HD>(rd + c * K::RC, p, rowl, cgi);
    }
  }
#pragma unroll
  for (int c = C - 1; c >= 0; --c) {
    if (FULL || c < n) {
      float v[J], dy[J], dk[4], dw[4], dv[J];
      load_j<J>(cur + 3 * TILE + c * HD + col0, v);
      load_j<J>(cur + 4 * TILE + c * HD + col0, dy);
#pragma unroll
      for (int jj = 0; jj < J; ++jj) dv[jj] = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ri = cur[c * HD + row[e]], ki = cur[TILE + c * HD + row[e]];
        const float wi = cur[2 * TILE + c * HD + row[e]];
        dk[e] = 0.f;
        dw[e] = 0.f;
#pragma unroll
        for (int jj = 0; jj < J; ++jj) {
          const float g = G[e][jj];
          dk[e] = fmaf(g, v[jj], dk[e]);
          dw[e] = fmaf(g, St[c][e][jj], dw[e]);
          dv[jj] = fmaf(g, ki, dv[jj]);
          G[e][jj] = fmaf(wi, g, ri * dy[jj]);
        }
      }
      row_reduce<HD>(dk);
      row_reduce<HD>(dw);
      row_store<HD>(rd + (C + c) * K::RC, dk, rowl, cgi);
      row_store<HD>(rd + (2 * C + c) * K::RC, dw, rowl, cgi);
      store_j<J>(colp + (c * NRG + rg) * CW + J * cgi, dv);
    }
  }
}

template <int HD, bool TMA>
__global__ void __launch_bounds__(Cfg<HD>::NT) wkv6_bwd_kernel(const __grid_constant__ Args a) {
  using K = Cfg<HD>;
  constexpr int J = K::J, C = K::C, NT = K::NT, NC = K::NC, CW = K::CW, NCG = K::NCG;
  constexpr int NRG = K::NRG, RC = K::RC, NPART = K::NPART, P = K::P, TILE = K::TILE;
  extern __shared__ __align__(128) float smem[];
  float* red = smem + K::STAGE;      // [2][NC][3][C][RC]: row sums, by chunk parity
  float* colp = red + 2 * K::RED;    // [2][C][NRG][CW]: dv's partials, by chunk parity
  float* scal = colp + 2 * K::COLP;  // [2][2][C]: bonus, v . dy, by chunk parity
  float* dus = scal + 4 * C;         // [NPART][RC]
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + K::FLOATS + (K::FLOATS & 1));

  const int tid = threadIdx.x;
  const int cgi = tid % NCG, rg = tid / NCG;
  int m = 0;  // the lane's permutation of its row slots
#pragma unroll
  for (int l = 0; l < K::LV; ++l) m |= (cgi & (NCG >> (l + 1))) ? (4 >> (l + 1)) : 0;
  int row[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) row[e] = 4 * rg + (e ^ m);
  int cb = 0;
  if constexpr (NC > 1) cb = static_cast<int>(cg::this_cluster().block_rank());
  const int h = blockIdx.x / NC, b = blockIdx.y;
  const int col0 = cb * CW + J * cgi;  // the thread's first column
  // The row sums are pushed to the CTA that joins the thread's rows (the
  // owner of rows [x RC, (x + 1) RC) is rank x), its rows local to it.
  const int owner = 4 * rg / RC;
  int rowl[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) rowl[e] = row[e] - owner * RC;
  float* push = red;
  if constexpr (NC > 1)
    push = cg::this_cluster().map_shared_rank(red, static_cast<unsigned>(owner));
  const long long bh = static_cast<long long>(b) * a.H + h;
  const long long base = b * a.in.b + h * a.in.h;
  const long long dybase = b * a.dys.b + h * a.dys.h;
  const long long obase = b * a.out.b + h * a.out.h;
  const long long state = bh * HD * HD;
  const int n_chunks = static_cast<int>((a.T + C - 1) / C);
  const int n_ck = n_chunks - 1;
  // the state at the start of chunk ch >= 1 in slot ch - 1 of this thread's
  // checkpoints: its slot e's J columns at e NT J (coalesced)
  float* ck = a.ckpt + (bh * n_ck * NC + cb) * (HD * CW) + tid * J;
  constexpr long long CK_CHUNK = static_cast<long long>(HD) * HD;
  auto load_state = [&](int ch, float (&x)[4][J]) {  // the state at the start of chunk ch
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (ch >= 1) {
        load_j<J>(ck + (ch - 1) * CK_CHUNK + e * NT * J, x[e]);
      } else {
#pragma unroll
        for (int jj = 0; jj < J; ++jj)
          x[e][jj] = a.s0 ? a.s0[state + static_cast<long long>(row[e]) * HD + col0 + jj] : 0.f;
      }
    }
  };

  // the join's row and part; the scalars pass's step and lane
  const int ii = tid % RC, part = tid / RC, jrow = cb * RC + ii;
  const float uj = a.u[h * HD + jrow];
  const int pc = tid / P, pp = tid % P;
  float4 u4[K::PQ];
#pragma unroll
  for (int q = 0; q < K::PQ; ++q) {
    const float* uq = a.u + h * HD + 4 * (pp + P * q);
    u4[q] = make_float4(uq[0], uq[1], uq[2], uq[3]);
  }

  float S[4][J], G[4][J];
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int jj = 0; jj < J; ++jj) {
      const long long at = state + static_cast<long long>(row[e]) * HD + col0 + jj;
      S[e][jj] = a.s0 ? a.s0[at] : 0.f;
      G[e][jj] = a.ds ? a.ds[at] : 0.f;
    }
  float du = 0.f;

  // Staging by TMA: the first sweep's k, w and v in copies of SCH chunks
  // (one box of SCH C rows per tensor: its steps are too short to cover
  // many small copies) in two slots, on bar[3 + slot]; then the chunks from
  // the last (r, k, w, v, dy) in three buffers, two ahead, on bar[buffer]:
  // the last chunk, in the first buffer, lands while the sweep runs.
  constexpr int SCH = K::SCH, SLOT0 = 5 * TILE;
  const int n_sc = (n_ck + SCH - 1) / SCH;  // the first sweep's copies
  if (TMA) {
    if (tid == 0) {
#pragma unroll
      for (int x = 0; x < K::BARS; ++x) mbar_init(&bar[x]);
    }
    __syncthreads();
    if (tid == 0) {
      for (int q = 0; q < 2 && q < n_sc; ++q)
        tma_tiles(smem + SLOT0 + q * K::SWEEP, &a.map[5], 3, SCH * TILE,
                  static_cast<long long>(q) * SCH * C, h, b, &bar[3 + q]);
      tma_tiles(smem, &a.map[0], 5, TILE, static_cast<long long>(n_ck) * C, h, b, &bar[0]);
    }
  }

  // every CTA of the cluster has started before the first push into its
  // shared memory (the barrier completes after the sweep)
  if constexpr (NC > 1) cluster_arrive_relaxed();

  // -- the first sweep: S alone, saved at each chunk's start
#pragma unroll 1
  for (int s = 0; s < n_ck; ++s) {
    const int q = s / SCH, slot = q & 1;
    const float* cur = smem + SLOT0 + slot * K::SWEEP + (s % SCH) * C * HD;  // k, w, v
    if (s % SCH == 0) {  // a copy's first chunk
      if (TMA) {
        mbar_wait(&bar[3 + slot], static_cast<unsigned>((q >> 1) & 1));
      } else {
        load_tiles<HD>(smem + SLOT0 + slot * K::SWEEP, a, base, dybase,
                       static_cast<long long>(q) * SCH * C,
                       static_cast<int>(min(static_cast<long long>(SCH) * C,
                                            static_cast<long long>(n_ck - q * SCH) * C)),
                       1, 4, SCH * TILE);
      }
      // With TMA and at most two copies (T up to 2 SCH C + C) the sweep has
      // no CTA barrier: each thread waits on the copy.
      const bool refill = q >= 1 && q + 1 < n_sc;
      if (!TMA || refill) __syncthreads();  // every thread is done with copy q - 1
      if (TMA && tid == 0 && refill)
        tma_tiles(smem + SLOT0 + (slot ^ 1) * K::SWEEP, &a.map[5], 3, SCH * TILE,
                  static_cast<long long>(q + 1) * SCH * C, h, b, &bar[3 + (slot ^ 1)]);
    }
#pragma unroll 2
    for (int c = 0; c < C; ++c) {
      float v[J];
      load_j<J>(cur + 2 * SCH * TILE + c * HD + col0, v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ki = cur[c * HD + row[e]], wi = cur[SCH * TILE + c * HD + row[e]];
#pragma unroll
        for (int jj = 0; jj < J; ++jj) S[e][jj] = fmaf(wi, S[e][jj], ki * v[jj]);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) store_j<J>(ck + s * CK_CHUNK + e * NT * J, S[e]);  // chunk s + 1
  }
  if (n_ck > 0) {
    __syncthreads();  // every thread is done with the slots
    if (TMA && tid == 0)
      tma_tiles(smem + K::BUF, &a.map[0], 5, TILE, static_cast<long long>(n_ck - 1) * C, h, b,
                &bar[1]);
  }

  if constexpr (NC > 1) cluster_wait();

  // -- the chunks from the last: recompute the states, walk back with G
  float nxt[4][J];  // the next (earlier) chunk's start: the first sweep left the last's in S
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int jj = 0; jj < J; ++jj) nxt[e][jj] = S[e][jj];
#pragma unroll 1
  for (int ch = n_ck; ch >= 0; --ch) {
    const int r = n_ck - ch, nb = r % 3;  // the chunk's place in the reverse order, its buffer
    const float* cur = smem + nb * K::BUF;
    const long long t0 = static_cast<long long>(ch) * C;
    const int n = static_cast<int>(min(static_cast<long long>(C), a.T - t0));
    // where this thread's row sums go: its rows' CTA, in the slot of this CTA
    float* rd = push + ((ch & 1) * NC + cb) * 3 * C * RC;
    float* cp = colp + (ch & 1) * K::COLP;
    float* sc = scal + (ch & 1) * 2 * C;
    if (TMA) {
      mbar_wait(&bar[nb], static_cast<unsigned>((r / 3) & 1));
    } else {
      load_tiles<HD>(smem + nb * K::BUF, a, base, dybase, t0, n, 0, 5, TILE);
      __syncthreads();
    }
    float St[C][4][J];  // S_t of the chunk's steps
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int jj = 0; jj < J; ++jj) St[0][e][jj] = nxt[e][jj];
    if (ch >= 1) load_state(ch - 1, nxt);
    if (n == C) {  // every chunk but a short last one: no branch between the steps
      chunk_steps<HD, true>(St, G, cur, rd, cp, row, rowl, col0, rg, cgi, n);
    } else {
      chunk_steps<HD, false>(St, G, cur, rd, cp, row, rowl, col0, rg, cgi, n);
    }
    // the chunk's bonus sum_i r_i u_i k_i and v . dy per step (lanes past n
    // compute on rows that are zero or stale and store nothing; every lane
    // joins the shuffles)
    {
      const float4* rr = reinterpret_cast<const float4*>(cur + pc * HD);
      const float4* kk = reinterpret_cast<const float4*>(cur + TILE + pc * HD);
      const float4* vv = reinterpret_cast<const float4*>(cur + 3 * TILE + pc * HD);
      const float4* dd = reinterpret_cast<const float4*>(cur + 4 * TILE + pc * HD);
      float bo = 0.f, vd = 0.f;
#pragma unroll
      for (int q = 0; q < K::PQ; ++q) {
        const float4 r4 = rr[pp + P * q], k4 = kk[pp + P * q];
        const float4 v4 = vv[pp + P * q], d4 = dd[pp + P * q];
        bo = fmaf(r4.x * u4[q].x, k4.x, bo);
        bo = fmaf(r4.y * u4[q].y, k4.y, bo);
        bo = fmaf(r4.z * u4[q].z, k4.z, bo);
        bo = fmaf(r4.w * u4[q].w, k4.w, bo);
        vd = fmaf(v4.x, d4.x, vd);
        vd = fmaf(v4.y, d4.y, vd);
        vd = fmaf(v4.z, d4.z, vd);
        vd = fmaf(v4.w, d4.w, vd);
      }
#pragma unroll
      for (int off = P / 2; off > 0; off >>= 1) {
        bo += __shfl_xor_sync(0xffffffffu, bo, off);
        vd += __shfl_xor_sync(0xffffffffu, vd, off);
      }
      if (pp == 0 && pc < n) {
        sc[pc] = bo;
        sc[C + pc] = vd;
      }
    }
    // this CTA's partials and scalars are written, and once the cluster's
    // barrier completes every CTA's row sums: dv's join overlaps the barrier
    if constexpr (NC > 1) cluster_arrive();
    __syncthreads();  // also: every thread is done with the chunk before, so its
                      // buffer takes the chunk two ahead
    if (TMA && tid == 0 && ch >= 2)
      tma_tiles(smem + ((r + 2) % 3) * K::BUF, &a.map[0], 5, TILE, t0 - 2 * C, h, b,
                &bar[(r + 2) % 3]);
    // columns [cb CW, (cb + 1) CW): dv's partials over the row groups in order
#pragma unroll
    for (int k = 0; k < C * CW / NT; ++k) {
      const int idx = tid + NT * k, c = idx / CW, j = idx % CW;
      float sum = cp[(c * NRG) * CW + j];
#pragma unroll
      for (int g = 1; g < NRG; ++g) sum += cp[(c * NRG + g) * CW + j];
      if (c < n) {
        a.grad[3][obase + (t0 + c) * a.out.t + cb * CW + j] =
            fmaf(sc[c], cur[4 * TILE + c * HD + cb * CW + j], sum);
      }
    }
    if constexpr (NC > 1) cluster_wait();
    // rows [cb RC, (cb + 1) RC): the cluster's row sums in rank order, the u
    // terms.  Every step's sums are read at once (rows past n hold stale
    // values and are not stored).
    {
      constexpr int KS = C / NPART;  // steps per join thread
      const float* mine = red + (ch & 1) * NC * 3 * C * RC;
      float sum[KS][3];
#pragma unroll
      for (int k = 0; k < KS; ++k)
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const int at = (q * C + part + NPART * k) * RC + ii;
          sum[k][q] = mine[at];
#pragma unroll
          for (int x = 1; x < NC; ++x) sum[k][q] += mine[x * 3 * C * RC + at];
        }
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        const int c = part + NPART * k;
        if (c < n) {
          const float ri = cur[c * HD + jrow], ki = cur[TILE + c * HD + jrow];
          const float vd = sc[C + c];
          const long long o = obase + (t0 + c) * a.out.t + jrow;
          a.grad[0][o] = fmaf(uj * ki, vd, sum[k][0]);
          a.grad[1][o] = fmaf(uj * ri, vd, sum[k][1]);
          a.grad[2][o] = sum[k][2];
          du = fmaf(ri * ki, vd, du);
        }
      }
    }
  }
  // (every push into this CTA landed before the last cluster barrier: no
  // CTA reads another's shared memory, so none waits for another to leave)
  dus[part * RC + ii] = du;
  __syncthreads();
  if (part == 0) {
    float sum = dus[ii];
#pragma unroll
    for (int x = 1; x < NPART; ++x) sum += dus[x * RC + ii];
    a.du_part[bh * HD + jrow] = sum;
  }
  if (a.ds0) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int jj = 0; jj < J; ++jj)
        a.ds0[state + static_cast<long long>(row[e]) * HD + col0 + jj] = G[e][jj];
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

template <int HD, bool TMA>
cudaError_t launch_one(const Args& a, long long B, cudaStream_t stream) {
  using K = Cfg<HD>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(wkv6_bwd_kernel<HD, TMA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(K::SMEM));
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.H * K::NC), static_cast<unsigned>(B));
  cfg.blockDim = dim3(K::NT);
  cfg.dynamicSmemBytes = K::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = K::NC;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  void* args[] = {const_cast<Args*>(&a)};
  const cudaError_t err =
      cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(wkv6_bwd_kernel<HD, TMA>), args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(Args& a, long long B, float* du, cudaStream_t stream) {
  using K = Cfg<HD>;
  // the grid's limits, and TMA's 32-bit coordinates
  if (a.H * K::NC > INT_MAX || B > 65535 || a.T > (1LL << 30)) return cudaErrorInvalidValue;
  int mapped = 1;
  for (int x = 0; x < 8 && mapped == 1; ++x) {  // r, k, w, v, dy by chunks; k, w, v by copies
    const int src = x < 5 ? x : x - 4;
    mapped = rows_map(&a.map[x], a.src[src], B, a.H, a.T, HD, src < 4 ? a.in : a.dys,
                      x < 5 ? K::C : K::SCH * K::C);
  }
  if (mapped < 0) return cudaErrorInvalidValue;  // the CUDA driver refused a map of aligned rows
  cudaError_t err = mapped == 1 ? launch_one<HD, true>(a, B, stream)
                                : launch_one<HD, false>(a, B, stream);
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

// The shape at head dim hd as compiled, {CTAs per cluster, columns per
// thread, steps per chunk}, zeros where the kernel is not built for hd.
extern "C" void wkv6_bwd_shape(long long hd, long long* out) {
  out[0] = hd == 16 ? Cfg<16>::NC : hd == 64 ? Cfg<64>::NC : 0;
  out[1] = hd == 16 ? Cfg<16>::J : hd == 64 ? Cfg<64>::J : 0;
  out[2] = hd == 16 ? Cfg<16>::C : hd == 64 ? Cfg<64>::C : 0;
}

// r, k, v, w (B, H, T, hd) sharing one set of batch, head and time strides
// (elements; head dims contiguous); u (H, hd) contiguous; s0, ds (B, H, hd,
// hd) contiguous or null (zero); dy (B, H, T, hd) by its own strides; dr,
// dk, dv, dw (B, H, T, hd) sharing one set of strides; du (H, hd); ds0 (B,
// H, hd, hd) contiguous or null (not written); ckpt B * H * (ceil(T / C) -
// 1) * hd^2 floats and du_part B * H * hd floats of scratch.  Returns a
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
  a.src[4] = dy;
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
