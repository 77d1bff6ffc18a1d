// Shared pieces of the B.6 kernels (flash_fwd.cu and flash_bwd.cu): float32
// matrix products on Hopper's tensor cores as three TF32 products, row
// tiles copied into shared memory by TMA or cp.async, and the softmax's exp.
//
// 3xTF32.  TF32 keeps 10 of float32's 23 mantissa bits, so one TF32 product
// misses the port's 2e-5 tolerance by 50-90x at the model shapes.  Each
// operand x is split as big = tf32(x), small = tf32(x - big) (both rounded
// to nearest, ties away, as cvt.rna.tf32.f32 rounds), and a b is taken as
// big_a big_b + big_a small_b + small_a big_b, accumulated in float32:
// the dropped small_a small_b term is ~2^-22 |a b|.
//
// mma.sync.m16n8k8 (tf32 inputs, f32 accumulators) fragments, with
// g = lane / 4 and c = lane % 4:
//   A (16 x 8, row):  a0 (g, c), a1 (g + 8, c), a2 (g, c + 4), a3 (g + 8, c + 4)
//   B (8 x 8, col):   b0 (k = c, n = g), b1 (k = c + 4, n = g)
//   C (16 x 8):       c0 (g, 2c), c1 (g, 2c + 1), c2 (g + 8, 2c), c3 (g + 8, 2c + 1)
// Every product here renumbers its summed index within each group of 8:
// logical k = c is physical 2c and k = c + 4 is 2c + 1, for the A and the B
// operand alike, so a sum is unchanged.  Then a lane's two values of a row
// are adjacent (one 8-byte shared load), and a C fragment (P, dS) is the A
// operand of the next product as it stands, without a shuffle.
//
// Operands.  An A operand (16 rows per warp) is split in registers as it is
// loaded (load_a).  A tile that every warp of the CTA reads as a B operand
// (K and V in the forward, q and dO for dK/dV, K and V for dQ) lands dense
// in a raw buffer (tma_rows, or copy_rows where TMA cannot take the view)
// and is split once by the whole CTA (split_rows) into a big and a small
// buffer, read by load_b_nk (B stored [n][k], 8-byte loads) and load_b_kn
// (B stored [k][n]); the raw buffer is then free for the next tile's copy,
// which lands under this tile's products.  Pitches: a tile read by load_a /
// load_b_nk only has hd + 8 floats (8 mod 16), one also read by load_b_kn
// hd + 4 (4 mod 16); both keep the 4-byte reads free of bank conflicts, and
// the 8-byte reads of an hd + 4 tile conflict 2-way, the shared traffic of
// two 4-byte reads.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float MASKED = -1e30f;  // the reference's masked score

struct Strides {
  long long b, h, s;  // batch, head and sequence strides; head dims are contiguous
};

// --- 3xTF32 products ---------------------------------------------------------

template <int N>
struct Frag {
  uint32_t big[N], small[N];
};

// x = big + small for finite x.  big = tf32(x) rounded as cvt.rna.tf32.f32
// rounds: add half a unit of the 13 dropped bits, then clear them.  small
// = x - big (exact) gets the same half unit, but its 13 low bits stay set:
// the tensor cores are taken to read only the top 19 bits of a .tf32
// operand, so small enters as cvt.rna would round it.  PTX does not say
// so; CUTLASS's 3xTF32 split (NumericConverterFastF32) takes its small
// part by round_half_ulp_truncate ("add 0.5ulp to integer representation
// then round toward zero") on the same assumption.  Were the low bits
// read, small would be off by half its TF32 unit, under 2^-22 |x|, so
// big * small would move by no more than the small * small term that the
// three products leave out.  Four operations per value, where two cvt.rna
// compile to about nine with their inf/NaN guards.  (The CPU emulation in
// the tests clears the bits; only the card tests see what the tensor cores
// do.)
template <int N>
__device__ __forceinline__ Frag<N> split(const float (&x)[N]) {
  Frag<N> f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    f.big[i] = (__float_as_uint(x[i]) + 0x1000u) & 0xffffe000u;
    f.small[i] = __float_as_uint(x[i] - __uint_as_float(f.big[i])) + 0x1000u;
  }
  return f;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[i] += a b[i] for i < N in float32 accuracy: the two small terms first,
// then big x big, the N accumulators interleaved so that no mma waits on
// the one just issued
template <int N>
__device__ __forceinline__ void mma3(float (*d)[4], const Frag<4>& a, const Frag<2> (&b)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(d[i], a.big, b[i].small);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(d[i], a.small, b[i].big);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(d[i], a.big, b[i].big);
}

// A fragment of rows row0 .. row0 + 15, columns col0 .. col0 + 7 of a
// row-major shared tile of pitch LD
template <int LD>
__device__ __forceinline__ Frag<4> load_a(const float* t, int row0, int col0, int g, int c) {
  const float* p = t + (row0 + g) * LD + col0 + 2 * c;
  const float2 lo = *reinterpret_cast<const float2*>(p);
  const float2 hi = *reinterpret_cast<const float2*>(p + 8 * LD);
  const float x[4] = {lo.x, hi.x, lo.y, hi.y};
  return split(x);
}

// a C fragment (16 x 8) as the A operand of the next product
__device__ __forceinline__ Frag<4> c_as_a(const float (&acc)[4]) {
  const float x[4] = {acc[0], acc[2], acc[1], acc[3]};
  return split(x);
}

// d[j] += a b(j) for j < NJ, where b(j) loads B fragment j, in groups of
// mma3 of 4 accumulators (2 where NJ is not a multiple of 4)
template <int NJ, class LoadB>
__device__ __forceinline__ void mma3_row(float (*d)[4], const Frag<4>& a, LoadB b) {
  constexpr int GRP = NJ % 4 == 0 ? 4 : 2;
#pragma unroll
  for (int j0 = 0; j0 < NJ; j0 += GRP) {
    Frag<2> f[GRP];
#pragma unroll
    for (int j = 0; j < GRP; ++j) f[j] = b(j0 + j);
    mma3(d + j0, a, f);
  }
}

// --- operands split once in shared memory -----------------------------------

// a tile split by split_rows
struct Split2 {
  const float* big;
  const float* small;
};

// splits N_ROWS x HD floats of raw (dense, pitch HD) into big and small
// (pitch LD)
template <int HD, int LD, int N_ROWS, int THREADS>
__device__ __forceinline__ void split_rows(const float* raw, float* big, float* small) {
  constexpr int CHUNKS = HD / 4;
#pragma unroll
  for (int i = threadIdx.x; i < N_ROWS * CHUNKS; i += THREADS) {
    const int off = (i / CHUNKS) * LD + 4 * (i % CHUNKS);
    const float4 x = *reinterpret_cast<const float4*>(raw + 4 * i);
    const float v[4] = {x.x, x.y, x.z, x.w};
    const Frag<4> f = split(v);
    *reinterpret_cast<uint4*>(big + off) = make_uint4(f.big[0], f.big[1], f.big[2], f.big[3]);
    *reinterpret_cast<uint4*>(small + off) =
        make_uint4(f.small[0], f.small[1], f.small[2], f.small[3]);
  }
}

// B fragment (k = col0 .. col0 + 7, n = row0 .. row0 + 7) of a tile stored
// [n][k] (K for q K^T): b[k][n] = t[row0 + n][col0 + k]
template <int LD>
__device__ __forceinline__ Frag<2> load_b_nk(const Split2& t, int row0, int col0, int g, int c) {
  const int off = (row0 + g) * LD + col0 + 2 * c;
  const uint2 big = *reinterpret_cast<const uint2*>(t.big + off);
  const uint2 small = *reinterpret_cast<const uint2*>(t.small + off);
  return Frag<2>{{big.x, big.y}, {small.x, small.y}};
}

// B fragment (k = row0 .. row0 + 7, n = col0 .. col0 + 7) of a tile stored
// [k][n] (V for P V)
template <int LD>
__device__ __forceinline__ Frag<2> load_b_kn(const Split2& t, int row0, int col0, int g, int c) {
  const int off = (row0 + 2 * c) * LD + col0 + g;
  return Frag<2>{{__float_as_uint(t.big[off]), __float_as_uint(t.big[off + LD])},
                 {__float_as_uint(t.small[off]), __float_as_uint(t.small[off + LD])}};
}

// --- cp.async staging ---------------------------------------------------------

// copies BYTES (16 or 4) from src to dst, or zeros when !fill (src unread)
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool fill) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(fill ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(fill ? 4 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Starts the copy of n_rows rows of HD floats to dst (pitch LD), each row
// as HD / W copies of W floats: 16-byte copies (W = 4) when every row is
// 16-byte aligned, else 4-byte ones.  Thread t always copies column t %
// (HD / W) and steps over the rows: `first` is its first row, next() the
// one after, null where the rows run out (zeros are copied, from `any`).
template <int HD, int LD, int THREADS, int W, class Next>
__device__ __forceinline__ void copy_rows(float* dst, int n_rows, const float* first,
                                          const float* any, Next next) {
  constexpr int CHUNKS = HD / W, STEP = THREADS / CHUNKS;
  if (threadIdx.x >= STEP * CHUNKS) return;
  const int d = W * (threadIdx.x % CHUNKS);
  const float* src = first;
  for (int r = threadIdx.x / CHUNKS; r < n_rows; r += STEP, src = next()) {
    cp_async<4 * W>(dst + r * LD + d, src ? src + d : any, src != nullptr);
  }
}

// rows row0 + r (r < n_rows) of a view with row stride `stride`, the rows
// at or past `limit` zero-filled
template <int HD, int LD, int THREADS>
__device__ __forceinline__ void stage_rows(float* dst, int n_rows, bool vec, const float* base,
                                           long long stride, int row0, int limit) {
  const int chunks = HD / (vec ? 4 : 1), step = THREADS / chunks;
  int row = row0 + static_cast<int>(threadIdx.x) / chunks;
  auto at = [&]() -> const float* { return row < limit ? base + row * stride : nullptr; };
  auto next = [&]() -> const float* {
    row += step;
    return at();
  };
  if (vec)
    copy_rows<HD, LD, THREADS, 4>(dst, n_rows, at(), base, next);
  else
    copy_rows<HD, LD, THREADS, 1>(dst, n_rows, at(), base, next);
}

// packed rows p0 + r (r < n_rows) of a KV head's G query heads: row p is
// position p / G of head p % G, at base + (p % G) hs + (p / G) ps; rows at
// or past `rows` zero-filled.  The (position, head) pair steps without a
// division per row.
template <int HD, int LD, int THREADS>
__device__ __forceinline__ void stage_packed(float* dst, int n_rows, bool vec, const float* base,
                                             long long hs, long long ps, int G, int p0,
                                             int rows) {
  const int chunks = HD / (vec ? 4 : 1), step = THREADS / chunks;
  int p = p0 + static_cast<int>(threadIdx.x) / chunks;
  int i = p / G, g = p - i * G;
  auto at = [&]() -> const float* { return p < rows ? base + g * hs + i * ps : nullptr; };
  auto next = [&]() -> const float* {
    p += step;
    g += step;
    while (g >= G) {
      g -= G;
      ++i;
    }
    return at();
  };
  if (vec)
    copy_rows<HD, LD, THREADS, 4>(dst, n_rows, at(), base, next);
  else
    copy_rows<HD, LD, THREADS, 1>(dst, n_rows, at(), base, next);
}

// --- TMA: a tile of rows in one request ----------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// thread 0: a box of rows from row0 on of (head, batch) of a map made by
// rows_map into dst (dense, pitch hd; rows past the view zero-filled), the
// bytes counted on bar.  A CTA barrier in front of it orders every read of
// dst before this write; the fence carries that order to the copy engine.
__device__ __forceinline__ void tma_rows(float* dst, const CUtensorMap* map, int row0, int head,
                                         int batch, uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(row0), "r"(head), "r"(batch),
      "r"(smem_addr(bar))
      : "memory");
}

// thread 0: expect `bytes` more on bar (one arrival of its count of 1)
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// every thread: wait for bar's phase `parity` to complete; a copy that never
// lands traps instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  for (long long spin = 0;; ++spin) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1LL << 24)) __trap();
  }
}

// --- softmax, masks and quad reductions -------------------------------------

// e^x as one ex2.approx of x log2(e): within ~2^-22 relative plus |x| 2^-24
// of e^x (the rounding of x log2(e)), where expf takes about eight
// instructions; every x here is a score minus the row's max (x <= 0)
__device__ __forceinline__ float exp_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}


__device__ __forceinline__ bool visible(int causal, int window, int qi, int kp) {
  bool ok = !causal || qi >= kp;
  if (window > 0) ok = ok && (qi - kp) < window;
  return ok;
}

// whether every (query, key) pair of queries [q_lo, q_hi] and keys [k_lo,
// k_hi] is visible: then a tile needs no mask
__device__ __forceinline__ bool all_visible(int causal, int window, int q_lo, int q_hi,
                                            int k_lo, int k_hi) {
  return (!causal || q_lo >= k_hi) && (window <= 0 || q_hi - k_lo < window);
}

// over the four lanes of a quad (the lanes that share a C fragment row)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// the dot product of two rows of HD floats (16-byte aligned), over the four
// lanes of a quad: lane c of it takes the float4s c, c + 4, ...
template <int HD>
__device__ __forceinline__ float row_dot(const float* x, const float* y, int c) {
  float acc = 0.f;
#pragma unroll
  for (int d = 4 * c; d < HD; d += 16) {
    const float4 u = *reinterpret_cast<const float4*>(x + d);
    const float4 w = *reinterpret_cast<const float4*>(y + d);
    acc += u.x * w.x + u.y * w.y + u.z * w.z + u.w * w.w;
  }
  return quad_sum(acc);
}

// x0, x1 to p[0], p[1]: one 8-byte store where the rows are 16-byte aligned
// (vec; p is then 8-byte aligned)
__device__ __forceinline__ void store2(float* p, float x0, float x1, bool vec) {
  if (vec) {
    *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
  } else {
    p[0] = x0;
    p[1] = x1;
  }
}

// every row of a (pointer, strides) view starts on 16 bytes
inline bool rows_aligned16(const void* p, const Strides& s) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && s.b % 4 == 0 && s.h % 4 == 0 &&
         s.s % 4 == 0;
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda),
// or null where the driver has none
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A TMA map of a (B, heads, rows, hd) float32 view given by its strides,
// copied box_rows rows at a time (tma_rows); false, and the caller copies
// with cp.async, where the view's rows are not 16-byte aligned or the
// driver refuses the map.
inline bool rows_map(CUtensorMap* map, const float* base, long long B, long long heads,
                     long long rows, long long hd, const Strides& s, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr || !rows_aligned16(base, s)) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s.s) * 4,
                                 static_cast<cuuint64_t>(s.h) * 4,
                                 static_cast<cuuint64_t>(s.b) * 4};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(hd), static_cast<cuuint32_t>(box_rows), 1,
                             1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(base), dims, strides,
            box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// the window as a 32-bit count (<= 0: none); one past any position
inline int window32(long long window) {
  return window <= 0 ? 0 : static_cast<int>(window < (1LL << 30) ? window : (1LL << 30));
}

}  // namespace flash
