// One whole RK4 (3/8 rule) interval of the fused CDE field, for Hopper
// (sm_90a), f32, for one model or K independent replicas.
//
// Replaces the TPU kernels online_neural_cdes_tpu/ops/kernels.py::
// fused_rk4_interval / _make_rk4_kernel (pl.pallas_call at kernels.py:511)
// and fused_rk4_interval_multi / _make_rk4_multi_kernel (pl.pallas_call at
// kernels.py:637).  With f(z) the fused field of fused_field.cu contracted
// with the interval's constant increment dX (a unit step: a caller with
// knot spacing dt passes dX/dt * dt), each batch row gets
//
//     k1 = f(z),  k2 = f(z + k1/3),  k3 = f(z + k2 - k1/3),
//     k4 = f(z + k1 - k2 + k3),  out = z + (k1 + 3 (k2 + k3) + k4) / 8.
//
// The K-replica form indexes every operand by replica (blockIdx.y) with
// the strides of the stacked layouts: z (K, B, H), dX (K, B, I), trunk
// weight l (K, d_in, HH) and bias (K, HH), head (K, HH, I*H) and its bias
// (K, I*H), out (K, B, H).  A replica's blocks run the same code in the
// same order as a single launch on its own operands, so its result is the
// same to the bit.
//
// Bound on the H100.  Four field evaluations: at (B=512, H=HH=128, two
// trunk layers, I=21) 4 x 2 * 512 * (2*128*128 + 128*2688 + 2688) =
// 1.55 GFLOP of f32 multiply-adds, 23.2 us at the 67 TFLOP/s f32 CUDA-core
// peak of the SXM part; the bytes it must move (z, dX, the weights, out)
// are about 2 MB, 0.6 us at 3.35 TB/s.  At I=1 (the rectilinear time
// slice) 3.0 us; K replicas K times as much.  Bound by operations.  (A
// reckoning from the data sheet, not a measurement.)
//
// Design.  Stage s+1's trunk needs every hidden column of stage s's result
// for its rows, so a block owns whole rows: one block of 512 threads per
// 8-row batch tile over all of H (grid: batch tiles x K), built from
// field_pass.cuh's passes, the same passes and order as fused_field.cu.
// The interval's z, k1, k2, k3 and the stage input stay in shared memory
// across the four stages ([H][8] each, 4 KB at H=128); the thread that
// computes an element of k_s also forms the next stage's input there, so
// the three (B, H) round trips to device memory between stages of the
// per-stage path go away, and only out is written.  The (HH, I*H) head
// (1.38 MB at I=21) does not fit on chip: each stage streams it from L2
// once per row tile, 32 hidden columns at a time, as the per-stage kernel
// does.  At B=512 that is 64 blocks on 132 SMs; K=2 fills 128.  A cluster
// of blocks exchanging hidden strips through distributed shared memory,
// tensor cores (3xTF32 wgmma) and TMA staging are left for later work.

#include "field_pass.cuh"

namespace {

constexpr int kMaxDim = 512;  // H and HH: the shared-memory budget's limit

template <int G, int V>
__global__ void __launch_bounds__(kThreads)
fused_rk4_interval_kernel(const float* __restrict__ z, const float* __restrict__ dx,
                          Trunk trunk, const float* __restrict__ head_w,
                          const float* __restrict__ head_b, float* __restrict__ out,
                          int batch, int hidden, int hh, int n_in) {
  extern __shared__ __align__(16) float smem[];
  const int hk = hidden * kRows;
  float* z0 = smem;                                  // [hidden][kRows]
  float* k1 = z0 + hk;
  float* k2 = k1 + hk;
  float* k3 = k2 + hk;
  float* zin = k3 + hk;                              // the stage's input
  float* xa = zin + hk;                              // [hh][kRows]
  float* xb = xa + hh * kRows;
  float* dxs = xb + hh * kRows;                      // [kRows][n_in]
  float* red = dxs + ((kRows * n_in + 3) & ~3);      // [kRed]
  float* wbuf = red + kRed;

  // This block's replica.
  const size_t rep = blockIdx.y;
  const size_t ih = (size_t)n_in * hidden;
  z += rep * batch * hidden;
  dx += rep * batch * n_in;
  out += rep * batch * hidden;
  head_w += rep * hh * ih;
  head_b += rep * ih;
#pragma unroll
  for (int l = 0; l < kMaxTrunk; ++l) {
    if (l < trunk.n) {
      trunk.w[l] += rep * (l == 0 ? hidden : hh) * hh;
      trunk.b[l] += rep * hh;
    }
  }

  const int tid = threadIdx.x;
  const int lane = tid % kLanes;
  const int warp = tid / kLanes;
  const int pair = warp % kPairs;
  const bool lead = warp / kPairs == 0;              // holds the pass totals
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, batch - row0);

  // z tile, transposed; rows past the batch are zeros (computed, never
  // written back).
  for (int e = tid; e < kRows * hidden; e += kThreads) {
    const int r = e / hidden, k = e - r * hidden;
    const float v = r < rows ? z[(size_t)row0 * hidden + e] : 0.f;
    z0[k * kRows + r] = v;
    zin[k * kRows + r] = v;
  }
  for (int e = tid; e < kRows * n_in; e += kThreads) {
    const int r = e / n_in;
    dxs[e] = r < rows ? dx[(size_t)row0 * n_in + e] : 0.f;
  }
  __syncthreads();

  const float third = 1.f / 3.f;
#pragma unroll 1
  for (int s = 0; s < 4; ++s) {
    // The trunk reads zin and ends synchronised, so zin is free to take
    // the next stage's input while the head runs.
    const float* u = trunk_forward<V>(zin, xa, xb, trunk, hidden, hh, wbuf, red);
    for (int h0 = 0; h0 < hidden; h0 += kLanes) {
      float kv[2];
      head_strip<G, V>(kv, u, head_w, head_b, dxs, hidden, hh, n_in, h0, wbuf, red);
      const int h = h0 + lane;
      if (lead && h < hidden) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 2 * pair + r;
          const int e = h * kRows + row;
          const float k = kv[r], zz = z0[e];
          if (s == 0) {
            k1[e] = k;
            zin[e] = zz + third * k;
          } else if (s == 1) {
            k2[e] = k;
            zin[e] = zz + k - third * k1[e];
          } else if (s == 2) {
            k3[e] = k;
            zin[e] = zz + k1[e] - k2[e] + k;
          } else if (row < rows) {
            out[(size_t)(row0 + row) * hidden + h] =
                zz + (k1[e] + 3.f * (k2[e] + k3[e]) + k) * 0.125f;
          }
        }
      }
    }
    __syncthreads();  // zin complete before the next stage's trunk
  }
}

size_t smem_bytes(int G, int hidden, int hh, int n_in) {
  return sizeof(float) * (5 * (size_t)hidden * kRows + 2 * (size_t)hh * kRows +
                          ((kRows * n_in + 3) & ~3) + kRed + wbuf_floats(G));
}

template <int G, int V>
int launch(const float* z, const float* dx, const Trunk& trunk, const float* head_w,
           const float* head_b, float* out, int replicas, int batch, int hidden, int hh,
           int n_in, cudaStream_t stream) {
  const size_t smem = smem_bytes(G, hidden, hh, n_in);
  static size_t smem_set = 48 * 1024;  // the default dynamic limit
  const int err = reserve_smem(fused_rk4_interval_kernel<G, V>, smem, smem_set);
  if (err) return err;
  const dim3 grid((batch + kRows - 1) / kRows, replicas);
  fused_rk4_interval_kernel<G, V><<<grid, kThreads, smem, stream>>>(
      z, dx, trunk, head_w, head_b, out, batch, hidden, hh, n_in);
  return (int)cudaGetLastError();
}

int launch_any(const float* z, const float* dx, const float* const* trunk_w,
               const float* const* trunk_b, int n_trunk, const float* head_w,
               const float* head_b, float* out, int replicas, int batch, int hidden,
               int hh, int n_in, void* stream) {
  if (n_trunk < 1 || n_trunk > kMaxTrunk || replicas < 1 || replicas > 65535 ||
      batch < 1 || hidden < 1 || hh < 1 || n_in < 1 || hidden > kMaxDim ||
      hh > kMaxDim)
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
    return vec ? launch<1, 4>(z, dx, trunk, head_w, head_b, out, replicas, batch, hidden,
                              hh, n_in, s)
               : launch<1, 1>(z, dx, trunk, head_w, head_b, out, replicas, batch, hidden,
                              hh, n_in, s);
  return vec ? launch<kHeadGroups, 4>(z, dx, trunk, head_w, head_b, out, replicas, batch,
                                      hidden, hh, n_in, s)
             : launch<kHeadGroups, 1>(z, dx, trunk, head_w, head_b, out, replicas, batch,
                                      hidden, hh, n_in, s);
}

}  // namespace

extern "C" {

// Both launch on `stream` and return cudaGetLastError() after the launch
// (0 on success); a shape they do not take (H or HH above
// oncde_fused_rk4_max_dim(), 0 or more than four trunk layers) returns
// cudaErrorInvalidValue with no launch.  trunk_w / trunk_b are host arrays
// of n_trunk device pointers.

// One interval for one model (TPU kernel fused_rk4_interval).
int oncde_fused_rk4_interval(const float* z, const float* dx,
                             const float* const* trunk_w, const float* const* trunk_b,
                             int n_trunk, const float* head_w, const float* head_b,
                             float* out, int batch, int hidden, int hh, int n_in,
                             void* stream) {
  return launch_any(z, dx, trunk_w, trunk_b, n_trunk, head_w, head_b, out, 1, batch,
                    hidden, hh, n_in, stream);
}

// One interval for each of K replicas, stacked layouts (TPU kernel
// fused_rk4_interval_multi).
int oncde_fused_rk4_interval_multi(const float* z, const float* dx,
                                   const float* const* trunk_w,
                                   const float* const* trunk_b, int n_trunk,
                                   const float* head_w, const float* head_b, float* out,
                                   int replicas, int batch, int hidden, int hh, int n_in,
                                   void* stream) {
  return launch_any(z, dx, trunk_w, trunk_b, n_trunk, head_w, head_b, out, replicas,
                    batch, hidden, hh, n_in, stream);
}

int oncde_fused_rk4_max_dim() { return kMaxDim; }

const char* oncde_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
