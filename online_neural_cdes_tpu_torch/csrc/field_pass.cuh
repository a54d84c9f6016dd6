// The fused CDE vector field's block-level building blocks, shared by the
// per-stage forward kernel (fused_field.cu) and the whole-interval RK4
// kernel (fused_rk4_interval.cu), so both evaluate the field with the same
// arithmetic in the same order.
//
// A block of 512 threads (16 warps) owns an 8-row batch tile.  Lane l owns
// column l of every 32-wide column group; warp w owns rows 2(w % 4) and
// 2(w % 4) + 1 and the quarter w / 4 of every weight chunk's rows -- a
// split of each contraction four ways, summed through shared memory at the
// end of each pass, so each SM scheduler has four warps to switch between.
// Every product is a "pass": 2 rows x NCOL column groups of accumulators
// per thread, against a weight slice streamed through shared memory in
// 32-row chunks with cp.async (16-byte copies when H and HH are multiples
// of 4, else 4-byte), double-buffered so the next chunk is in flight while
// the current one is used.  Activations stay transposed in shared memory
// ([k][row]) so a warp reads both of its rows' u[k] with one broadcast
// load.
//
// The passes take an operand mode M (mma_tf32.cuh's Mode; float32 storage
// and precision by default, the interval kernel's only mode): with bf16
// weights, or a product that rounds its operands to bf16, the weight
// chunks are loaded through registers, widened or rounded, instead of by
// cp.async, and the trunk rounds each layer's output, which only the next
// product reads.  Products and sums stay f32.

#pragma once

#include <cuda_runtime.h>

#include "mma_tf32.cuh"

namespace {

constexpr int kRows = 8;           // batch rows per block
constexpr int kPairs = kRows / 2;  // warp w % kPairs owns one row pair
constexpr int kSplit = 4;          // warp w / kPairs owns a quarter of each chunk
constexpr int kLanes = 32;         // columns per group, one per lane
constexpr int kThreads = kLanes * kPairs * kSplit;
constexpr int kChunk = 32;         // weight rows per shared-memory stage
constexpr int kPart = kChunk / kSplit;
constexpr int kMaxTrunk = 4;
constexpr int kTrunkGroups = 4;    // trunk output columns per pass: 4 x 32
constexpr int kHeadGroups = 8;     // head channels per pass
constexpr int kMaxGroups = kHeadGroups > kTrunkGroups ? kHeadGroups : kTrunkGroups;
constexpr int kRed = (kSplit - 1) * kPairs * 2 * kMaxGroups * kLanes;

template <class T>
struct TrunkOf {
  const T* w[kMaxTrunk];  // layer l: (d_in, hh) row-major, d_in = H for l = 0
  const T* b[kMaxTrunk];  // (hh,)
  int n;
};
using Trunk = TrunkOf<float>;

// Floats of the weight staging buffer for G head channels per pass.
constexpr int wbuf_floats(int G) {
  return 2 * kChunk * kLanes * (G > kTrunkGroups ? G : kTrunkGroups);
}

// cp.async of V floats (V = 4: 16 bytes, V = 1: 4 bytes); zeros when !valid.
template <int V>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (V == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// acc[r][g] += sum_k x[k][row r] * W[k][col(g * 32 + lane)] over the K
// rows of a row-major weight matrix (leading dimension ld), for this
// thread's two rows, then summed over the four warps that share them.
// `col(c, off)` maps a slice column c to its source column `off` and says
// whether it exists (whole V-groups); missing columns and rows read as 0.
// The slice streams through `wbuf` (2 x kChunk x NCOL*32 floats).  Only
// warps of the first quarter (quarter == 0) hold the total afterwards.
template <int NCOL, int V, class M = F32, class Col>
__device__ __forceinline__ void pass(float (&acc)[2][NCOL], const float* x,
                                     const typename M::Storage* w, size_t ld, int K, Col col,
                                     float* wbuf, float* red) {
  constexpr int cols = NCOL * kLanes;
  constexpr int per_row = cols / V;
  constexpr int chunk_floats = kChunk * cols;
  const int tid = threadIdx.x;
  const int lane = tid % kLanes;
  const int warp = tid / kLanes;
  const int pair = warp % kPairs;
  const int quarter = warp / kPairs;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int g = 0; g < NCOL; ++g) acc[r][g] = 0.f;

  // Each thread copies the same (row, column) slots of every chunk.
  auto load = [&](float* dst, int k0) {
    for (int e = tid; e < kChunk * per_row; e += kThreads) {
      const int kk = e / per_row, q = e % per_row;
      const int k = k0 + kk;
      int off;
      const bool ok = col(q * V, off) && k < K;
      if constexpr (std::is_same<M, F32>::value) {
        cp_async<V>(dst + kk * cols + q * V, ok ? w + (size_t)k * ld + off : w, ok);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float v = ok ? widen(w[(size_t)k * ld + off + i]) : 0.f;
          dst[kk * cols + q * V + i] = M::kRound ? bf16_round(v) : v;
        }
      }
    }
  };

  const int n_chunks = (K + kChunk - 1) / kChunk;
  load(wbuf, 0);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) {
      load(wbuf + ((c + 1) & 1) * chunk_floats, (c + 1) * kChunk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* wc = wbuf + (c & 1) * chunk_floats;
    const int k0 = c * kChunk;
    const int hi = min(K - k0, (quarter + 1) * kPart);
#pragma unroll
    for (int kk = quarter * kPart; kk < hi; ++kk) {
      const float2 a = *reinterpret_cast<const float2*>(&x[(k0 + kk) * kRows + 2 * pair]);
#pragma unroll
      for (int g = 0; g < NCOL; ++g) {
        const float wv = wc[kk * cols + g * kLanes + lane];
        acc[0][g] = fmaf(a.x, wv, acc[0][g]);
        acc[1][g] = fmaf(a.y, wv, acc[1][g]);
      }
    }
    __syncthreads();
  }

  // Sum the quarters into quarter 0.
  if (quarter > 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int g = 0; g < NCOL; ++g)
        red[((((quarter - 1) * kPairs + pair) * 2 + r) * NCOL + g) * kLanes + lane] =
            acc[r][g];
  }
  __syncthreads();
  if (quarter == 0) {
#pragma unroll
    for (int s = 0; s < kSplit - 1; ++s)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int g = 0; g < NCOL; ++g)
          acc[r][g] += red[(((s * kPairs + pair) * 2 + r) * NCOL + g) * kLanes + lane];
  }
}

// The relu trunk for the block's rows: `in` [hidden][kRows] -> returns the
// buffer holding u_n [hh][kRows].  Layer 0 writes buf0, and the layers
// alternate between buf0 and buf1 (buf1 may be `in`).  Ends synchronised.
template <int V, class M = F32>
__device__ __forceinline__ const float* trunk_forward(const float* in, float* buf0,
                                                      float* buf1,
                                                      const TrunkOf<typename M::Storage>& trunk,
                                                      int hidden, int hh, float* wbuf,
                                                      float* red) {
  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int pair = warp % kPairs;
  const bool lead = warp / kPairs == 0;  // holds the pass totals
  const float* src = in;
  float* dst = buf0;
  int d_in = hidden;
#pragma unroll
  for (int l = 0; l < kMaxTrunk; ++l) {
    if (l < trunk.n) {
      const auto* __restrict__ b = trunk.b[l];
      for (int j0 = 0; j0 < hh; j0 += kTrunkGroups * kLanes) {
        float acc[2][kTrunkGroups];
        pass<kTrunkGroups, V, M>(
            acc, src, trunk.w[l], hh, d_in,
            [&](int c, int& off) { off = j0 + c; return j0 + c < hh; }, wbuf, red);
        if (lead) {
#pragma unroll
          for (int g = 0; g < kTrunkGroups; ++g) {
            const int j = j0 + g * kLanes + lane;
            if (j < hh) {
              const float bj = widen(b[j]);
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const float u = fmaxf(acc[r][g] + bj, 0.f);
                dst[j * kRows + 2 * pair + r] = M::kRound ? bf16_round(u) : u;
              }
            }
          }
        }
      }
      __syncthreads();
      src = dst;
      dst = (dst == buf0) ? buf1 : buf0;
      d_in = hh;
    }
  }
  return src;
}

// Head, tanh and the dX contraction for the 32-wide hidden strip at h0, G
// channels per pass: out[r] = sum_i tanh(u @ W_o[:, i*H + h] + b_o[i*H + h])
// * dX[row, i] for h = h0 + lane and row = 2 * pair + r.  `dxs` is the
// block's dX tile [kRows][n_in].  Only warps of the first quarter hold the
// result.
template <int G, int V, class M = F32>
__device__ __forceinline__ void head_strip(float (&out)[2], const float* u,
                                           const typename M::Storage* __restrict__ head_w,
                                           const typename M::Storage* __restrict__ head_b,
                                           const float* dxs, int hidden, int hh,
                                           int n_in, int h0, float* wbuf, float* red) {
  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int pair = warp % kPairs;
  const bool lead = warp / kPairs == 0;
  const int h = h0 + lane;
  const size_t head_cols = (size_t)n_in * hidden;
  out[0] = out[1] = 0.f;
  for (int ig = 0; ig < n_in; ig += G) {
    float acc[2][G];
    pass<G, V, M>(
        acc, u, head_w, head_cols, hh,
        [&](int c, int& off) {
          const int i = ig + c / kLanes, hc = h0 + c % kLanes;
          off = i * hidden + hc;
          return i < n_in && hc < hidden;
        },
        wbuf, red);
    if (lead) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int i = ig + g;
        if (i < n_in && h < hidden) {
          const float bias = widen(head_b[(size_t)i * hidden + h]);
#pragma unroll
          for (int r = 0; r < 2; ++r)
            out[r] = fmaf(tanhf(acc[r][g] + bias), dxs[(2 * pair + r) * n_in + i], out[r]);
        }
      }
    }
  }
}

// Sets a kernel's dynamic shared-memory limit the first time a launch
// needs more than the current one; returns the CUDA error (0 if none).
template <class Kernel>
int reserve_smem(Kernel kernel, size_t smem, size_t& smem_set) {
  if (smem <= smem_set) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  smem_set = smem;
  return 0;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

}  // namespace
