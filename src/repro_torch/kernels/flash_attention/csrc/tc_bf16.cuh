// bfloat16 pieces of B.6's forward (flash_fwd.cu, its bfloat16 instances):
// tiles of raw bfloat16 rows in shared memory as TMA swizzles them,
// ldmatrix fragments of them, and bfloat16 mma.sync products with float32
// sums.
//
// Layout.  A tile of rows of hd bfloat16 values is kept in one or two
// panels (hd 8 and 16: one of 16 columns, hd 8 zero-padded to it; 32: one
// of 32; 64: one of 64; 80: 64 + 16; 128: 64 + 64), each a region of rows of
// 32, 64 or 128 bytes, aligned to 1,024 bytes, in which 16-byte chunk ch of
// row r sits at chunk ch ^ (the row's 128-byte line index mod 2, 4 or 8):
// TMA's SWIZZLE_32B, _64B and _128B patterns, which the copies by
// cp.async and plain loads reproduce.  The eight row addresses of an
// ldmatrix then fall on eight distinct 16-byte bank groups.
//
// mma.sync.m16n8k16 (bf16 inputs, f32 accumulators) fragments, with g =
// lane / 4 and c = lane % 4:
//   A (16 x 16, row): a0 (g, 2c..2c+1), a1 (g + 8, 2c..), a2 (g, 2c + 8..),
//                     a3 (g + 8, 2c + 8..)
//   B (16 x 8, col):  b0 (k = 2c..2c+1, n = g), b1 (k = 2c + 8.., n = g)
//   C (16 x 8):       c0 (g, 2c), c1 (g, 2c + 1), c2 (g + 8, 2c), c3 (g + 8, 2c + 1)
// ldmatrix gives lane t of each 8 x 8 matrix (row t / 4, columns 2 (t % 4)
// and + 1), and with .trans (rows 2 (t % 4) and + 1, column t / 4): an A
// operand and a B operand stored [n][k] come by plain ldmatrix, a B operand
// stored [k][n] (V in P V) by .trans.  Two C fragments side by side (16 x
// 16) are an A operand as they stand once packed to bfloat16.

#pragma once

#include <cuda_bf16.h>

#include "tc_tf32.cuh"

namespace flash {

// a panel of W bfloat16 columns (W = 16, 32, 64: rows of 32, 64, 128 bytes)
template <int W>
struct Panel {
  static_assert(W == 16 || W == 32 || W == 64, "panel width");
  static constexpr int ROW = 2 * W;     // bytes per row
  static constexpr int MASK = W / 8 - 1;  // chunk bits the swizzle flips
  static constexpr CUtensorMapSwizzle SWIZZLE =
      W == 16 ? CU_TENSOR_MAP_SWIZZLE_32B
              : W == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
  // byte offset of 16-byte chunk ch of row r in a region aligned to 1,024
  __device__ static __forceinline__ unsigned off(int r, int ch) {
    const unsigned o = static_cast<unsigned>(r * ROW + ch * 16);
    return o ^ (((o >> 7) & MASK) << 4);
  }
};

__host__ __device__ constexpr unsigned align1024(unsigned bytes) {
  return (bytes + 1023u) & ~1023u;
}

template <int HD>
struct BfTile {
  static constexpr int HDP = HD < 16 ? 16 : HD;  // columns kept (hd 8: zero-padded)
  static constexpr int W0 = HDP < 64 ? HDP : 64;  // the first panel's width
  static constexpr int W1 = HDP - W0;              // the second's: 0, 16 (hd 80) or 64
  static constexpr int CHUNKS = HDP / 8;           // 16-byte chunks per row
  static_assert(W1 == 0 || W1 == 16 || W1 == 64, "panels");
  // bytes of a tile of `rows` rows
  __host__ __device__ static constexpr unsigned bytes(int rows) {
    return align1024(2u * W0 * rows) + (W1 ? align1024(2u * W1 * rows) : 0u);
  }
  // byte offset of 16-byte chunk ch (< CHUNKS) of row r in a tile of ROWS rows
  template <int ROWS>
  __device__ static __forceinline__ unsigned off(int r, int ch) {
    if constexpr (W1 > 0) {
      if (ch >= W0 / 8) return align1024(2u * W0 * ROWS) + Panel<W1>::off(r, ch - W0 / 8);
    }
    return Panel<W0>::off(r, ch);
  }
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// d += a b: one bfloat16 product of a 16 x 16 A and a 16 x 8 B, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// x0, x1 as hi + lo, each a packed pair of bfloat16: hi = bf16(x), lo =
// bf16(x - hi), so hi + lo is within 2^-17 |x| of x
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// copies 16 bytes from src to dst, or zeros when !fill (src unread)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}

// thread 0: a box of a 4-d map at coordinates {c0, c1, c2, c3} into dst,
// counted on bar.  A CTA barrier in front of it orders every read of dst
// before this write; the fence carries that order to the copy engine.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                        int c3, uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_addr(bar))
      : "memory");
}

// every row of a bfloat16 (pointer, strides) view starts on 16 bytes
inline bool rows_aligned16_bf16(const void* p, const Strides& s) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && s.b % 8 == 0 && s.h % 8 == 0 &&
         s.s % 8 == 0;
}

// A TMA map of a bfloat16 tensor of dims {hd, d1, d2, d3} (hd contiguous;
// the others' strides in elements) copied in boxes {W, box1, box2, 1}
// swizzled for Panel<W>; columns past hd (hd 8 in a 16-wide panel) and rows
// past the dims are zero-filled.  False where a stride or the base is off
// 16 bytes, a box is over 256, or the driver refuses the map.
template <int W>
inline bool bf16_map(CUtensorMap* map, const void* base, long long hd, long long d1,
                     long long d2, long long d3, long long s1, long long s2, long long s3,
                     int box1, int box2) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr || (reinterpret_cast<uintptr_t>(base) & 15) != 0 || s1 % 8 != 0 ||
      s2 % 8 != 0 || s3 % 8 != 0 || box1 < 1 || box1 > 256 || box2 < 1 || box2 > 256)
    return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2), static_cast<cuuint64_t>(d3)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s1) * 2,
                                 static_cast<cuuint64_t>(s2) * 2,
                                 static_cast<cuuint64_t>(s3) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(W), static_cast<cuuint32_t>(box1),
                             static_cast<cuuint32_t>(box2), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
            box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, Panel<W>::SWIZZLE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

}  // namespace flash
