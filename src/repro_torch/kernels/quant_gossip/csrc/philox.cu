// The compressed wire's stochastic-rounding uniforms of one round, drawn on
// the card (Hopper, sm_90a): one launch fills every leaf of a round (up to
// kMaxLeaves leaves) with U[0, 1) noise from Philox-4x32-10 (Salmon et al.,
// "Parallel random numbers: as easy as 1, 2, 3", SC'11; the Random123
// generator).
//
// Replaces no TPU kernel: the reference draws this noise with jax.random
// (threefry through fold_in) inside its jitted step
// (src/repro/comm/composed.py:492, 542; src/repro/comm/compressors.py:58-75).
// The port draws it here so that a step captured in a CUDA graph draws the
// noise of the round it replays: the round is read on the card, through a
// pointer, at every launch.
//
// For element e of leaf l (its (K, D) block flattened) in round r, with
// matching m (0 off the masked wire), key k (CommState.key) and the leaf's
// round divisor d (1 for the wire's noise):
//
//     key     = (k mod 2^32, (k >> 32) mod 2^32)
//     counter = (e >> 2, l, m, floor(r / d) mod 2^32)
//     u[e]    = (word (e mod 4) of Philox(counter, key) >> 8) * 2^-24
//
// The dynamics' fault and topology coins draw from the same kernel
// (repro_torch/dynamics/coins.py), one leaf per stream at leaf indices the
// wire never uses; the divisor keys the outage stream by its window
// floor(r / outage_len), so that one launch draws every coin of a round.
//
// which is exact in float32 and lies in [0, 1).  Every (key, round, leaf,
// matching, element) has its own counter, so a leaf drawn alone equals the
// same leaf drawn in a group, and the order of draws changes nothing.  The
// largest leaf on the port's paths (qwen2-0.5b's tied embedding at K = 8,
// 1.09e9 elements) keeps e >> 2 inside 32 bits; the wrapper refuses a leaf
// of 2^34 elements or more.
//
// Bits: 32-bit integer products (__umulhi and the low word), xors and adds,
// then one exact conversion: the plain version (ref.py, in int64 torch ops)
// gives the same bits.
//
// Bound: memory.  4 bytes written per element, nothing read but the leaf
// table and the round; ten Philox rounds are 20 32-bit products per four
// elements, far below the card's integer rate.  Design: a flat grid over
// (leaf, CTA), the leaves in a __grid_constant__ table found by a scan of at
// most kMaxLeaves entries (as the quant_gossip grouped kernels find theirs);
// each thread makes one Philox call and one 16-byte store (scalar stores
// for the last, partial four of a leaf, or where the leaf does not start on
// 16 bytes).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLeaves = 16;
constexpr int kDesc = 5;  // longs per leaf in a descriptor

struct PhiloxLeaf {
  float* out;
  long long n;           // elements
  long long cta_begin;   // CTAs of the launch's earlier leaves
  long long divisor;     // the round's divisor (>= 1): the counter's last word is r / divisor
  unsigned index;        // the leaf's index in the round (the counter's second word)
  int vec;               // 16-byte stores
};

struct PhiloxTable {
  PhiloxLeaf leaf[kMaxLeaves];
  const long long* round;  // the round, a 0-d int64 on the card
  unsigned k0, k1;         // the key
  unsigned matching;
  int n;
};

__device__ __forceinline__ void philox4x32_10(unsigned (&c)[4], unsigned k0, unsigned k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const unsigned hi0 = __umulhi(0xD2511F53u, c[0]);
    const unsigned lo0 = 0xD2511F53u * c[0];
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c[2]);
    const unsigned lo1 = 0xCD9E8D57u * c[2];
    const unsigned x0 = hi1 ^ c[1] ^ k0;
    const unsigned x2 = hi0 ^ c[3] ^ k1;
    c[0] = x0;
    c[1] = lo1;
    c[2] = x2;
    c[3] = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
}

__device__ __forceinline__ float unit(unsigned w) {
  return __uint2float_rn(w >> 8) * 0x1p-24f;
}

__global__ void __launch_bounds__(kThreads) philox_uniforms_kernel(const __grid_constant__ PhiloxTable t) {
  const long long b = blockIdx.x;
  int l = 0;
  while (l + 1 < t.n && b >= t.leaf[l + 1].cta_begin) ++l;
  float* out = t.leaf[l].out;
  const long long n = t.leaf[l].n;
  const long long g = (b - t.leaf[l].cta_begin) * kThreads + threadIdx.x;  // e >> 2
  const long long e = 4 * g;
  if (e >= n) return;
  const long long r = *t.round;
  const long long d = t.leaf[l].divisor;
  const long long q = d == 1 ? r : r / d - (r % d < 0 ? 1 : 0);  // floor(r / d)
  unsigned c[4] = {static_cast<unsigned>(g), t.leaf[l].index, t.matching,
                   static_cast<unsigned>(static_cast<unsigned long long>(q))};
  philox4x32_10(c, t.k0, t.k1);
  const float v[4] = {unit(c[0]), unit(c[1]), unit(c[2]), unit(c[3])};
  if (e + 4 <= n && t.leaf[l].vec) {
    *reinterpret_cast<float4*>(out + e) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int i = 0; i < 4 && e + i < n; ++i) out[e + i] = v[i];
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// The kernel's fixed sizes, for the caller's leaf table: {threads per CTA,
// leaves per launch}.
extern "C" void philox_config(long long* out) {
  out[0] = kThreads;
  out[1] = kMaxLeaves;
}

// The uniforms of n <= kMaxLeaves leaves of one round.  desc holds, per
// leaf, kDesc longs: out (float32, its elements), the element count, the
// leaf's index in the round, the prefix count of CTAs before it (per
// leaf: ceil(ceil(count / 4) / kThreads)) and its round divisor (>= 1).
// key: the wire's key, both words; round: one int64 on the card; matching:
// the matching (0 off the masked wire).  Launches on `stream`; returns the
// cudaError_t (0 on success).
extern "C" int philox_uniforms_grouped_f32(const long long* desc, int n, unsigned long long key,
                                           const long long* round, int matching, void* stream) {
  if (n <= 0 || n > kMaxLeaves || round == nullptr || matching < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PhiloxTable t = {};
  t.round = round;
  t.k0 = static_cast<unsigned>(key & 0xFFFFFFFFull);
  t.k1 = static_cast<unsigned>(key >> 32);
  t.matching = static_cast<unsigned>(matching);
  t.n = n;
  long long ctas = 0;
  for (int l = 0; l < n; ++l) {
    const long long* e = desc + kDesc * l;
    PhiloxLeaf& L = t.leaf[l];
    L.out = reinterpret_cast<float*>(e[0]);
    L.n = e[1];
    L.index = static_cast<unsigned>(e[2]);
    L.cta_begin = e[3];
    L.divisor = e[4];
    if (L.n <= 0 || L.n >= (1LL << 34) || e[2] < 0 || e[2] > UINT_MAX || L.cta_begin != ctas ||
        L.divisor < 1) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    L.vec = aligned(L.out, 16);
    ctas += ((L.n + 3) / 4 + kThreads - 1) / kThreads;
  }
  if (ctas > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  philox_uniforms_kernel<<<static_cast<unsigned>(ctas), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}
