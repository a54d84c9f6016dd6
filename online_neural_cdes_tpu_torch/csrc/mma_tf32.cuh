// f32 products on Hopper's tensor cores in 3xTF32: the warp-level tile of
// mma.sync.aligned.m16n8k8 (TF32 in, f32 accumulate), for kernels that
// must keep f32 accuracy.
//
// One TF32 pass keeps 10 mantissa bits of each operand, about three
// decimal digits.  3xTF32 splits each f32 operand x into a TF32 "big" part
// (x rounded to nearest, ties away from zero) and a TF32 "small" part
// (x - big, rounded the same way) and accumulates
//
//     a_small b_big + a_big b_small + a_big b_big
//
// in f32: the small x small term is below f32's round-off, so the product
// carries about 21 of f32's 24 bits, at three tensor-core passes.
//
// The rounding is cvt.rna.tf32.f32's for every finite x, written as two
// integer operations (add half a TF32 ulp, clear the 13 low bits): ptxas
// expands cvt.rna into a longer compare-and-select sequence on sm_90, and
// splitting is most of a fragment's cost.  An operand that several warps
// read is best split once, where it is written to shared memory, and read
// back as its two parts (frag_a_rows).
//
// Fragment coordinates of m16n8k8 (TF32), lane = 4 g + t:
//   A (16 x 8, row major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, k x n):      b0 (t, g), b1 (t + 4, g)
//   C (16 x 8):            c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// The fragments come from registers, so any operand layout works.
//
// mma_3xtf32 keeps two accumulators: hi takes the big products and lo the
// two cross terms, so a warp has twice the independent MMA chains in
// flight; the product is hi + lo.
//
// bf16 operands.  The field kernels also take bf16 storage and the
// precision "bfloat16" (both operands of every product rounded to bf16
// first), with f32 accumulation, as the JAX package's _mm.  A bf16 value
// has 8 significant bits and TF32 holds 11, so it is exact in TF32: its
// small part is 0, and a pass that multiplies by it adds exactly 0 to an
// accumulator.  mma_3xtf32<EA, EB> drops those passes when the A (EA) or B
// (EB) operand is known at compile time to be bf16-exact: f32 x bf16 takes
// two passes, bf16 x bf16 one, with the bits of the three passes on the
// same values.  Mode names a kernel's operand mode (the storage type and
// the precision) and which of its operands are then bf16-exact.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

// A field kernel's operand mode: every input and output is stored as T
// (float or __nv_bfloat16); with R (precision "bfloat16") each product's
// operands are rounded to bf16 where they are staged.  Sums, activations
// and scratch stay f32; outputs are rounded to T once, when written.
template <class T, bool R>
struct Mode {
  using Storage = T;
  static constexpr bool kBf16 = !std::is_same<T, float>::value;
  static constexpr bool kRound = R;
  static constexpr bool kExactW = kBf16 || R;  // weights in a product are bf16-exact
  static constexpr bool kExactAct = R;         // and so are the activations
};
using F32 = Mode<float, false>;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
// Round to nearest even bf16, as an f32.
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
// Writes v in the output's storage type (bf16: rounded to nearest even).
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Whether a pointer of element type T can be read V = 4 elements a load.
template <class T>
bool aligned_vec4(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & (4 * sizeof(T) - 1)) == 0;
}

// x rounded to TF32 (nearest, ties away from zero), as an f32.
__device__ __forceinline__ float tf32_round(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

__device__ __forceinline__ void tf32_split(float x, float& big, float& small) {
  big = tf32_round(x);
  small = tf32_round(x - big);
}

struct FragA {
  uint32_t big[4], small[4];
};
struct FragB {
  uint32_t big[2], small[2];
};

__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2, float a3) {
  const float a[4] = {a0, a1, a2, a3};
  FragA f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float big, small;
    tf32_split(a[i], big, small);
    f.big[i] = __float_as_uint(big);
    f.small[i] = __float_as_uint(small);
  }
  return f;
}

__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  const float b[2] = {b0, b1};
  FragB f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float big, small;
    tf32_split(b[i], big, small);
    f.big[i] = __float_as_uint(big);
    f.small[i] = __float_as_uint(small);
  }
  return f;
}

// The A fragment of the 16 x 8 block at `p` of a row-major tile with
// leading dimension ld that holds split values: big parts at p, small
// parts sep floats after them.
__device__ __forceinline__ FragA frag_a_rows(const float* p, int ld, int sep) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const float* r0 = p + g * ld + t;
  const float* r1 = r0 + 8 * ld;
  FragA f;
  f.big[0] = __float_as_uint(r0[0]);
  f.big[1] = __float_as_uint(r1[0]);
  f.big[2] = __float_as_uint(r0[4]);
  f.big[3] = __float_as_uint(r1[4]);
  f.small[0] = __float_as_uint(r0[sep]);
  f.small[1] = __float_as_uint(r1[sep]);
  f.small[2] = __float_as_uint(r0[sep + 4]);
  f.small[3] = __float_as_uint(r1[sep + 4]);
  return f;
}

// c += a b, one TF32 pass.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// (hi + lo) += a b in 3xTF32, less the passes whose small part is 0 (EA: a
// is bf16-exact, EB: b is).
template <bool EA = false, bool EB = false>
__device__ __forceinline__ void mma_3xtf32(float (&hi)[4], float (&lo)[4], const FragA& a,
                                           const FragB& b) {
  if (!EA) mma_tf32(lo, a.small, b.big);
  mma_tf32(hi, a.big, b.big);
  if (!EB) mma_tf32(lo, a.big, b.small);
}

}  // namespace
