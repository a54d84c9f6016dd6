// Fused CDE vector field, forward, for Hopper (sm_90a), f32.
//
// Replaces the TPU kernel online_neural_cdes_tpu/ops/kernels.py::
// _forward_pallas / _make_kernel (pl.pallas_call at kernels.py:184).  For
// each batch row b it computes
//
//     u        = relu(... relu(z[b] @ W_1 + b_1) ... @ W_n + b_n)   (HH,)
//     A[i, h]  = tanh(u @ W_o[:, i*H + h] + b_o[i*H + h])          (I, H)
//     out[b,h] = sum_i A[i, h] * dX[b, i]
//
// with the head in the contraction-major (HH, I*H) layout of
// pack_fused_params (column i*H + h is channel i, hidden unit h).  The
// (B, I*H) field matrix A never reaches device memory: only the (B, H)
// result is written.
//
// Bound on the H100.  At the flagship serving shape (B=64, H=HH=128, two
// trunk layers, I=21) the function does 2*64*(2*128*128 + 128*2688 + 2688)
// = 48.6 MFLOP of f32 multiply-adds and must read about 1.6 MB (weights,
// z, dX) and write 32 KB: 0.73 us at the 67 TFLOP/s f32 CUDA-core peak of
// the SXM part against 0.47 us at 3.35 TB/s, so it is bound by operations.
// (A reckoning from the data sheet, not a measurement.)
//
// Design.  One block of 512 threads (16 warps) per (8-row batch tile,
// 32-wide hidden strip).  Lane l owns column l of every 32-wide column
// group; warp w owns rows 2(w % 4) and 2(w % 4) + 1 and the quarter w / 4
// of every weight chunk's rows -- a split of each contraction four ways,
// summed through shared memory at the end of each pass, so each SM
// scheduler has four warps to switch between.  Every product is a "pass":
// 2 rows x NCOL column groups of accumulators per thread, against a weight
// slice streamed through shared memory in 32-row chunks with cp.async
// (16-byte copies when H and HH are multiples of 4, else 4-byte),
// double-buffered so the next chunk is in flight while the current one is
// used.  The block recomputes the trunk for its 8 rows (passes of 4 x 32
// output columns), keeping activations transposed in shared memory
// ([k][row]) so a warp reads both of its rows' u[k] with one broadcast
// load.  The head then runs G channels per pass (G = 8, or 1 for the
// rectilinear time-advance slice): each thread's 2 x G pre-activations get
// tanhf and are added, times dX[:, i], into its output registers, so the
// contraction over I needs no reduction across threads.  The flagship
// shape launches 8 x 4 = 32 blocks at B=64 and 64 x 4 = 256 at B=512 on
// the card's 132 SMs.  Tensor cores (wgmma, in 3xTF32 to keep f32
// accuracy), TMA staging and cutting the per-block trunk recompute are
// left for later work.

#include <cuda_runtime.h>

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

struct Trunk {
  const float* w[kMaxTrunk];  // layer l: (d_in, hh) row-major, d_in = H for l = 0
  const float* b[kMaxTrunk];  // (hh,)
  int n;
};

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
template <int NCOL, int V, class Col>
__device__ __forceinline__ void pass(float (&acc)[2][NCOL], const float* x,
                                     const float* w, size_t ld, int K, Col col,
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
      cp_async<V>(dst + kk * cols + q * V, ok ? w + (size_t)k * ld + off : w, ok);
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

template <int G, int V>
__global__ void __launch_bounds__(kThreads)
fused_field_forward_kernel(const float* __restrict__ z,
                           const float* __restrict__ dx, Trunk trunk,
                           const float* __restrict__ head_w,
                           const float* __restrict__ head_b,
                           float* __restrict__ out, int batch, int hidden,
                           int hh, int n_in) {
  extern __shared__ __align__(16) float smem[];
  const int dmax = max(hidden, hh);
  float* xa = smem;                                  // [dmax][kRows]
  float* xb = xa + dmax * kRows;                     // [hh][kRows]
  float* dxs = xb + hh * kRows;                      // [kRows][n_in]
  float* red = dxs + ((kRows * n_in + 3) & ~3);      // [kRed]
  float* wbuf = red + kRed;                          // 2 x kChunk x 32*max(G, 4)

  const int tid = threadIdx.x;
  const int lane = tid % kLanes;
  const int warp = tid / kLanes;
  const int pair = warp % kPairs;
  const bool lead = warp / kPairs == 0;              // holds the pass totals
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, batch - row0);
  const int h0 = blockIdx.y * kLanes;
  const int h = h0 + lane;

  // z tile, transposed; rows past the batch are zeros (computed, never
  // written back).
  for (int e = tid; e < kRows * hidden; e += kThreads) {
    const int r = e / hidden, k = e - r * hidden;
    xa[k * kRows + r] = r < rows ? z[(size_t)row0 * hidden + e] : 0.f;
  }
  for (int e = tid; e < kRows * n_in; e += kThreads) {
    const int r = e / n_in;
    dxs[e] = r < rows ? dx[(size_t)row0 * n_in + e] : 0.f;
  }
  __syncthreads();

  // Trunk: relu after every layer; input [d_in][kRows] -> output [hh][kRows].
  float* in = xa;
  float* dst = xb;
  int d_in = hidden;
#pragma unroll
  for (int l = 0; l < kMaxTrunk; ++l) {
    if (l < trunk.n) {
      const float* __restrict__ b = trunk.b[l];
      for (int j0 = 0; j0 < hh; j0 += kTrunkGroups * kLanes) {
        float acc[2][kTrunkGroups];
        pass<kTrunkGroups, V>(
            acc, in, trunk.w[l], hh, d_in,
            [&](int c, int& off) { off = j0 + c; return j0 + c < hh; }, wbuf, red);
        if (lead) {
#pragma unroll
          for (int g = 0; g < kTrunkGroups; ++g) {
            const int j = j0 + g * kLanes + lane;
            if (j < hh) {
              const float bj = b[j];
#pragma unroll
              for (int r = 0; r < 2; ++r)
                dst[j * kRows + 2 * pair + r] = fmaxf(acc[r][g] + bj, 0.f);
            }
          }
        }
      }
      __syncthreads();
      in = dst;
      dst = (dst == xb) ? xa : xb;
      d_in = hh;
    }
  }

  // Head, tanh and the dX contraction, G channels per pass.
  const size_t head_cols = (size_t)n_in * hidden;
  float out_acc[2] = {0.f, 0.f};
  for (int ig = 0; ig < n_in; ig += G) {
    float acc[2][G];
    pass<G, V>(
        acc, in, head_w, head_cols, hh,
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
          const float bias = head_b[(size_t)i * hidden + h];
#pragma unroll
          for (int r = 0; r < 2; ++r)
            out_acc[r] = fmaf(tanhf(acc[r][g] + bias),
                              dxs[(2 * pair + r) * n_in + i], out_acc[r]);
        }
      }
    }
  }
  if (lead) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 2 * pair + r;
      if (h < hidden && row < rows)
        out[(size_t)(row0 + row) * hidden + h] = out_acc[r];
    }
  }
}

template <int G, int V>
int launch(const float* z, const float* dx, const Trunk& trunk,
           const float* head_w, const float* head_b, float* out, int batch,
           int hidden, int hh, int n_in, cudaStream_t stream) {
  constexpr int wcols = kLanes * (G > kTrunkGroups ? G : kTrunkGroups);
  const int dmax = hidden > hh ? hidden : hh;
  const size_t smem = sizeof(float) *
      ((size_t)dmax * kRows + (size_t)hh * kRows + ((kRows * n_in + 3) & ~3) +
       kRed + 2 * (size_t)kChunk * wcols);
  static size_t smem_set = 48 * 1024;  // the default dynamic limit
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_field_forward_kernel<G, V>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  const dim3 grid((batch + kRows - 1) / kRows, (hidden + kLanes - 1) / kLanes);
  fused_field_forward_kernel<G, V><<<grid, kThreads, smem, stream>>>(
      z, dx, trunk, head_w, head_b, out, batch, hidden, hh, n_in);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch (0 on
// success).  trunk_w / trunk_b are host arrays of n_trunk device pointers.
int oncde_fused_field_forward(const float* z, const float* dx,
                              const float* const* trunk_w,
                              const float* const* trunk_b, int n_trunk,
                              const float* head_w, const float* head_b,
                              float* out, int batch, int hidden, int hh,
                              int n_in, void* stream) {
  if (n_trunk < 1 || n_trunk > kMaxTrunk || batch < 1 || hidden < 1 || hh < 1 ||
      n_in < 1)
    return (int)cudaErrorInvalidValue;
  Trunk trunk;
  bool vec = hidden % 4 == 0 && hh % 4 == 0 && aligned16(head_w);
  for (int l = 0; l < kMaxTrunk; ++l) {
    trunk.w[l] = l < n_trunk ? trunk_w[l] : nullptr;
    trunk.b[l] = l < n_trunk ? trunk_b[l] : nullptr;
    if (l < n_trunk) vec = vec && aligned16(trunk_w[l]);
  }
  trunk.n = n_trunk;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_in == 1)
    return vec ? launch<1, 4>(z, dx, trunk, head_w, head_b, out, batch, hidden, hh, n_in, s)
               : launch<1, 1>(z, dx, trunk, head_w, head_b, out, batch, hidden, hh, n_in, s);
  return vec ? launch<kHeadGroups, 4>(z, dx, trunk, head_w, head_b, out, batch, hidden,
                                      hh, n_in, s)
             : launch<kHeadGroups, 1>(z, dx, trunk, head_w, head_b, out, batch, hidden,
                                      hh, n_in, s);
}

const char* oncde_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
