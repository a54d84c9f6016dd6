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
// 32-wide hidden strip), built from field_pass.cuh's passes.  The block
// recomputes the trunk for its 8 rows (passes of 4 x 32 output columns).
// The head then runs G channels per pass (G = 8, or 1 for the rectilinear
// time-advance slice): each thread's 2 x G pre-activations get tanhf and
// are added, times dX[:, i], into its output registers, so the
// contraction over I needs no reduction across threads.  The flagship
// shape launches 8 x 4 = 32 blocks at B=64 and 64 x 4 = 256 at B=512 on
// the card's 132 SMs.  Tensor cores (wgmma, in 3xTF32 to keep f32
// accuracy), TMA staging and cutting the per-block trunk recompute are
// left for later work.

#include "field_pass.cuh"

namespace {

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

  // Trunk (xa -> xb -> xa ...), then the head's strip at h0.
  const float* u = trunk_forward<V>(xa, xb, xa, trunk, hidden, hh, wbuf, red);
  float out_acc[2];
  head_strip<G, V>(out_acc, u, head_w, head_b, dxs, hidden, hh, n_in, h0, wbuf, red);
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
  const int dmax = hidden > hh ? hidden : hh;
  const size_t smem = sizeof(float) *
      ((size_t)dmax * kRows + (size_t)hh * kRows + ((kRows * n_in + 3) & ~3) +
       kRed + wbuf_floats(G));
  static size_t smem_set = 48 * 1024;  // the default dynamic limit
  const int err = reserve_smem(fused_field_forward_kernel<G, V>, smem, smem_set);
  if (err) return err;
  const dim3 grid((batch + kRows - 1) / kRows, (hidden + kLanes - 1) / kLanes);
  fused_field_forward_kernel<G, V><<<grid, kThreads, smem, stream>>>(
      z, dx, trunk, head_w, head_b, out, batch, hidden, hh, n_in);
  return (int)cudaGetLastError();
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
