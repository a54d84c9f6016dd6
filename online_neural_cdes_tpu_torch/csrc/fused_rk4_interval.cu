// One whole RK4 (3/8 rule) interval of the fused CDE field, for Hopper
// (sm_90a), for one model or K independent replicas, in float32 or
// bfloat16 storage.
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
// As in the JAX kernel, every stage runs in f32 (bf16 operands are widened
// where they are staged: z, dX, the weights, the biases) and only out is
// rounded to the storage type, once.  The K-replica form indexes every
// operand by replica (blockIdx.y) with the strides of the stacked layouts:
// z (K, B, H), dX (K, B, I), trunk weight l (K, d_in, HH) and bias (K, HH),
// head (K, HH, I*H) and its bias (K, I*H), out (K, B, H).  A replica's
// blocks run the same code in the same order as a single launch on its own
// operands, so its result is the same to the bit.
//
// Bound on the H100.  Four field evaluations: at (B=512, H=HH=128, two
// trunk layers, I=21) 4 x 2 * 512 * (2*128*128 + 128*2688 + 2688) =
// 1.55 GFLOP of f32 multiply-adds: 23.2 us at the 67 TFLOP/s f32
// CUDA-core peak of the SXM part, 9.42 us on the tensor cores at the dense
// TF32 rate of 495 TFLOP/s divided by the three passes of 3xTF32
// (bound_tc_us); the bytes it must move (z, dX, the weights, out) are
// about 2 MB, 0.6 us at 3.35 TB/s.  At I=1 (the rectilinear time slice)
// 3.01 / 1.22 us.  K replicas K times as much.  Bound by operations.  (A
// reckoning from the data sheet, not a measurement.)
//
// Two routes, chosen by the shape:
//
// - H and HH up to 256: the tensor cores (rk4_mma.cuh).  A cluster of
//   four blocks (eight where four blocks' tiles do not fit shared memory)
//   owns a 16- or 32-row tile; each block owns a strip of H's state
//   columns and a share of every trunk layer's columns, and the blocks
//   exchange trunk outputs and stage inputs through distributed shared
//   memory, so the four stages of a row tile spread over the cluster's SMs
//   instead of one block's serial chain.  Every product is mma.sync
//   m16n8k8 in 3xTF32 (mma_tf32.cuh).  The weights stream from L2 through
//   a ring of three cp.async tiles (each trunk layer's owned columns, then
//   the head strip in channel-group x k-chunk tiles), the same sequence
//   every stage.  The head strip a block needs, HH x I x h floats (344 KB
//   at the flagship, h = 32), does not fit beside the activation tiles, so
//   it is read once per stage per row tile: 176 MB of L2 reads an interval
//   at B=512 with 16-row tiles, 88 MB with 32-row tiles.  32-row tiles are
//   taken where their clusters give at least a quarter of the SMs a block
//   and the card holds them all at once (cudaOccupancyMaxActiveClusters),
//   else 16-row tiles, which fit two blocks an SM.  K replicas multiply
//   the clusters, so K = 2 takes about twice one.  The cluster size and the
//   strips depend on the widths only, and the arithmetic of an element does
//   not depend on the row tile: the bits do not depend on B, K or the grid.
//
// - H or HH above 256, up to 512: the CUDA cores, one block of 512 threads
//   per 8-row batch tile over all of H, built from field_pass.cuh's
//   passes, the same passes and order as fused_field.cu's wide path.  z,
//   k1, k2, k3 and the stage input stay in shared memory across the four
//   stages; each stage streams the (HH, I*H) head from L2 once per row
//   tile, 32 hidden columns at a time.  One block's serial chain of four
//   stages bounds it, whatever B.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W power limit; chip_smoke.py's
// kernel_rk4 phase, CUDA events, f32 / bf16 storage, us):
//
//   (B, H, HH, I, n)        route          this kernel       plain
//   (512, 128, 128, 21, 2)  tensor cores   161.8 / 178.7     249.4
//   (512, 128, 128, 1, 2)   tensor cores    50.3 / 50.3      177.2
//   (64, 128, 128, 21, 2)   tensor cores   129.9 / 171.7     196.3
//   (512, 320, 264, 21, 2)  CUDA cores    1736 / 2585        549.2
//
// At the first three shapes the CUDA-core kernel, the only route before
// the tensor-core one, ran 344.6 / 66.4 / 343.0 us in f32.  The tensor-core
// route is still 17x, 41x and 110x bound_tc_us (9.42, 1.22, 1.18 us); how
// its time splits between the head's MMAs, its L2 stream and the cluster
// barriers is an open question of PERF.md.  Above 256 wide the CUDA-core
// route is 3x slower than the plain version: one block's serial chain of
// four stages over all of H, 64 blocks at B=512.

#include "field_pass.cuh"
#include "rk4_mma.cuh"

namespace {

constexpr int kMaxDim = 512;  // H and HH: the CUDA-core route's shared-memory limit

// ------------------------------------------------------------ CUDA cores

template <int G, int V, class M>
__global__ void __launch_bounds__(kThreads)
fused_rk4_interval_kernel(const typename M::Storage* __restrict__ z,
                          const typename M::Storage* __restrict__ dx,
                          TrunkOf<typename M::Storage> trunk,
                          const typename M::Storage* __restrict__ head_w,
                          const typename M::Storage* __restrict__ head_b,
                          typename M::Storage* __restrict__ out, int batch, int hidden,
                          int hh, int n_in) {
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
    const float v = r < rows ? widen(z[(size_t)row0 * hidden + e]) : 0.f;
    z0[k * kRows + r] = v;
    zin[k * kRows + r] = v;
  }
  for (int e = tid; e < kRows * n_in; e += kThreads) {
    const int r = e / n_in;
    dxs[e] = r < rows ? widen(dx[(size_t)row0 * n_in + e]) : 0.f;
  }
  __syncthreads();

  const float third = 1.f / 3.f;
#pragma unroll 1
  for (int s = 0; s < 4; ++s) {
    // The trunk reads zin and ends synchronised, so zin is free to take
    // the next stage's input while the head runs.
    const float* u = trunk_forward<V, M>(zin, xa, xb, trunk, hidden, hh, wbuf, red);
    for (int h0 = 0; h0 < hidden; h0 += kLanes) {
      float kv[2];
      head_strip<G, V, M>(kv, u, head_w, head_b, dxs, hidden, hh, n_in, h0, wbuf, red);
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
            put(out + (size_t)(row0 + row) * hidden + h,
                zz + (k1[e] + 3.f * (k2[e] + k3[e]) + k) * 0.125f);
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

template <int G, int V, class M, class T = typename M::Storage>
int launch_cuda_cores(const T* z, const T* dx, const TrunkOf<T>& trunk, const T* head_w,
                      const T* head_b, T* out, int replicas, int batch, int hidden, int hh,
                      int n_in, cudaStream_t stream) {
  const size_t smem = smem_bytes(G, hidden, hh, n_in);
  static size_t smem_set = 48 * 1024;  // the default dynamic limit
  const int err = reserve_smem(fused_rk4_interval_kernel<G, V, M>, smem, smem_set);
  if (err) return err;
  const dim3 grid((batch + kRows - 1) / kRows, replicas);
  fused_rk4_interval_kernel<G, V, M><<<grid, kThreads, smem, stream>>>(
      z, dx, trunk, head_w, head_b, out, batch, hidden, hh, n_in);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------- tensor cores

namespace rk4 = tc::rk4;

constexpr size_t kPairBudget = 113 * 1024;  // two blocks an SM
constexpr size_t kSoloBudget = tc::kMaxSmem;

// The geometry of (cs, mt) at a shape: two blocks an SM where it fits
// 113 KB, else one.
rk4::Geo config_geometry(int cs, int mt, int hidden, int hh, int n_in) {
  const rk4::Geo g = rk4::geometry(cs, mt, hidden, hh, n_in, kPairBudget);
  return g.ok ? g : rk4::geometry(cs, mt, hidden, hh, n_in, kSoloBudget);
}

// The shape's cluster size, from its widths only (so a row's bits never
// depend on B or the replica count): four blocks, or eight where four
// blocks' strips do not fit; 0 if neither does.
int cluster_size(int hidden, int hh, int n_in) {
  if (hidden > tc::kMaxDim || hh > tc::kMaxDim) return 0;
  for (int cs = 4; cs <= 8; cs *= 2)
    if (config_geometry(cs, 1, hidden, hh, n_in).ok) return cs;
  return 0;
}

int fit_of(const rk4::Geo& g) {
  // Cached by (cs, mt, smem): the query costs a few microseconds.
  struct Entry {
    int cs, mt;
    size_t smem;
    int fit;
  };
  static Entry cache[32];
  static int used = 0;
  for (int q = 0; q < used; ++q)
    if (cache[q].cs == g.cs && cache[q].mt == g.mt && cache[q].smem == g.smem)
      return cache[q].fit;
  const int fit = g.cs == 4 ? (g.mt == 1 ? rk4::clusters_at_once<4, 1>(g)
                                         : rk4::clusters_at_once<4, 2>(g))
                            : (g.mt == 1 ? rk4::clusters_at_once<8, 1>(g)
                                         : rk4::clusters_at_once<8, 2>(g));
  if (used < 32) cache[used++] = {g.cs, g.mt, g.smem, fit};
  return fit;
}

// The tensor-core configuration of a launch: the shape's cluster size, then
// 32-row tiles where their clusters give at least a quarter of the SMs a
// block and the card holds them all at once, else 16-row tiles.  32-row
// tiles halve the head's L2 reads; at B=64 they would leave 8 blocks with
// work.  g.ok is false if the tensor cores do not take the shape (the
// launch then takes the CUDA cores).  The row tile never changes the bits.
rk4::Geo tc_config(int replicas, int batch, int hidden, int hh, int n_in) {
  rk4::Geo none = {};
  none.ok = false;
  const int cs = cluster_size(hidden, hh, n_in);
  if (cs == 0) return none;
  const rk4::Geo two = config_geometry(cs, 2, hidden, hh, n_in);
  if (two.ok) {
    const long long clusters = (long long)replicas * tc::cdiv(batch, 32);
    if (clusters * cs >= tc::kTargetBlocks / 4 && clusters <= fit_of(two)) return two;
  }
  return config_geometry(cs, 1, hidden, hh, n_in);
}

template <class M, class T = typename M::Storage>
int launch_tensor_cores(const rk4::Geo& G, const T* z, const T* dx, const void* const* trunk_w,
                        const void* const* trunk_b, int n_trunk, const T* head_w,
                        const T* head_b, T* out, int replicas, int batch, int hidden, int hh,
                        int n_in, cudaStream_t s) {
  rk4::Params<T> p;
  p.z = z, p.dx = dx, p.head_w = head_w, p.head_b = head_b, p.out = out;
  bool vec = hidden % 4 == 0 && hh % 4 == 0 && aligned_vec4<T>(z) && aligned_vec4<T>(head_w);
  for (int l = 0; l < tc::kMaxTrunk; ++l) {
    p.trunk.w[l] = l < n_trunk ? static_cast<const T*>(trunk_w[l]) : nullptr;
    p.trunk.b[l] = l < n_trunk ? static_cast<const T*>(trunk_b[l]) : nullptr;
    if (l < n_trunk) vec = vec && aligned_vec4<T>(trunk_w[l]);
  }
  p.trunk.n = n_trunk;
  p.batch = batch, p.hidden = hidden, p.hh = hh, p.n_in = n_in;
  p.h = G.h, p.h_shift = __builtin_ctz(G.h), p.s = G.s, p.o = G.o, p.lda = G.lda;
  p.ldo = G.ldo, p.ldg = G.ldg, p.kh = G.kh;
  p.kc = G.kc, p.gc = G.gc, p.ngroups = G.ngroups, p.nchunks = G.nchunks, p.buf = G.buf;
  cudaError_t err;
  if (G.cs == 4)
    err = G.mt == 1 ? rk4::launch<M, 4, 1>(p, G, vec, replicas, s)
                    : rk4::launch<M, 4, 2>(p, G, vec, replicas, s);
  else
    err = G.mt == 1 ? rk4::launch<M, 8, 1>(p, G, vec, replicas, s)
                    : rk4::launch<M, 8, 2>(p, G, vec, replicas, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ the choice

bool valid(int replicas, int batch, int hidden, int hh, int n_in, int n_trunk) {
  return n_trunk >= 1 && n_trunk <= kMaxTrunk && replicas >= 1 && replicas <= 65535 &&
         batch >= 1 && hidden >= 1 && hh >= 1 && n_in >= 1 && hidden <= kMaxDim &&
         hh <= kMaxDim;
}

template <class M, class T = typename M::Storage>
int interval(const void* zp, const void* dxp, const void* const* trunk_w,
             const void* const* trunk_b, int n_trunk, const void* head_wp,
             const void* head_bp, void* outp, int replicas, int batch, int hidden, int hh,
             int n_in, cudaStream_t s) {
  const T* z = static_cast<const T*>(zp);
  const T* dx = static_cast<const T*>(dxp);
  const T* head_w = static_cast<const T*>(head_wp);
  const T* head_b = static_cast<const T*>(head_bp);
  T* out = static_cast<T*>(outp);
  const rk4::Geo G = tc_config(replicas, batch, hidden, hh, n_in);
  if (G.ok)
    return launch_tensor_cores<M>(G, z, dx, trunk_w, trunk_b, n_trunk, head_w, head_b, out,
                                  replicas, batch, hidden, hh, n_in, s);
  TrunkOf<T> trunk;
  bool vec = hidden % 4 == 0 && hh % 4 == 0 && aligned_vec4<T>(head_w);
  for (int l = 0; l < kMaxTrunk; ++l) {
    trunk.w[l] = l < n_trunk ? static_cast<const T*>(trunk_w[l]) : nullptr;
    trunk.b[l] = l < n_trunk ? static_cast<const T*>(trunk_b[l]) : nullptr;
    if (l < n_trunk) vec = vec && aligned_vec4<T>(trunk_w[l]);
  }
  trunk.n = n_trunk;
  if (n_in == 1)
    return vec ? launch_cuda_cores<1, 4, M>(z, dx, trunk, head_w, head_b, out, replicas, batch,
                                            hidden, hh, n_in, s)
               : launch_cuda_cores<1, 1, M>(z, dx, trunk, head_w, head_b, out, replicas, batch,
                                            hidden, hh, n_in, s);
  return vec ? launch_cuda_cores<kHeadGroups, 4, M>(z, dx, trunk, head_w, head_b, out, replicas,
                                                    batch, hidden, hh, n_in, s)
             : launch_cuda_cores<kHeadGroups, 1, M>(z, dx, trunk, head_w, head_b, out, replicas,
                                                    batch, hidden, hh, n_in, s);
}

int launch_any(const void* z, const void* dx, const void* const* trunk_w,
               const void* const* trunk_b, int n_trunk, const void* head_w,
               const void* head_b, void* out, int replicas, int batch, int hidden, int hh,
               int n_in, int dtype, void* stream) {
  if (!valid(replicas, batch, hidden, hh, n_in, n_trunk) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto call = dtype == 0 ? &interval<F32> : &interval<Mode<__nv_bfloat16, false>>;
  return call(z, dx, trunk_w, trunk_b, n_trunk, head_w, head_b, out, replicas, batch, hidden,
              hh, n_in, s);
}

}  // namespace

extern "C" {

// Both launch on `stream` and return cudaGetLastError() after the launch
// (0 on success); a shape they do not take (H or HH above
// oncde_fused_rk4_max_dim(), 0 or more than four trunk layers) returns
// cudaErrorInvalidValue with no launch.  Every operand and the output are
// stored as `dtype` (0: float32, 1: bfloat16).  trunk_w / trunk_b are host
// arrays of n_trunk device pointers.

// One interval for one model (TPU kernel fused_rk4_interval).
int oncde_fused_rk4_interval(const void* z, const void* dx, const void* const* trunk_w,
                             const void* const* trunk_b, int n_trunk, const void* head_w,
                             const void* head_b, void* out, int batch, int hidden, int hh,
                             int n_in, int dtype, void* stream) {
  return launch_any(z, dx, trunk_w, trunk_b, n_trunk, head_w, head_b, out, 1, batch, hidden,
                    hh, n_in, dtype, stream);
}

// One interval for each of K replicas, stacked layouts (TPU kernel
// fused_rk4_interval_multi).
int oncde_fused_rk4_interval_multi(const void* z, const void* dx, const void* const* trunk_w,
                                   const void* const* trunk_b, int n_trunk,
                                   const void* head_w, const void* head_b, void* out,
                                   int replicas, int batch, int hidden, int hh, int n_in,
                                   int dtype, void* stream) {
  return launch_any(z, dx, trunk_w, trunk_b, n_trunk, head_w, head_b, out, replicas, batch,
                    hidden, hh, n_in, dtype, stream);
}

int oncde_fused_rk4_max_dim() { return kMaxDim; }

// The launch geometry of a call, for reports: returns the route taken (0:
// CUDA cores, 1: tensor cores; -1 if the call would be refused) and fills
// grid[9] = {cluster size, rows a tile, clusters, blocks, clusters the
// card holds at once (-1 if the runtime cannot say), shared memory bytes
// a block, channels a head group, k rows a head chunk, state columns a
// rank}; on the CUDA cores {1, 8, 0, blocks, 0, 0, 0, 0, H}.
int oncde_fused_rk4_grid(int replicas, int batch, int hidden, int hh, int n_in, int n_trunk,
                         int* grid) {
  if (!valid(replicas, batch, hidden, hh, n_in, n_trunk)) return -1;
  const rk4::Geo G = tc_config(replicas, batch, hidden, hh, n_in);
  if (G.ok) {
    const int clusters = replicas * tc::cdiv(batch, 16 * G.mt);
    const int g[9] = {G.cs, 16 * G.mt, clusters, clusters * G.cs, fit_of(G), (int)G.smem,
                      G.gc, G.kc, G.h};
    for (int q = 0; q < 9; ++q) grid[q] = g[q];
    return 1;
  }
  const int g[9] = {1, kRows, 0, replicas * ((batch + kRows - 1) / kRows), 0, 0, 0, 0, hidden};
  for (int q = 0; q < 9; ++q) grid[q] = g[q];
  return 0;
}

const char* oncde_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
