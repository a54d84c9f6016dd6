// Fused CDE vector field, forward, for Hopper (sm_90a): float32 or bfloat16
// storage, products in f32 (3xTF32) or on operands rounded to bf16.
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
// Bound on the H100.  At the flagship training shape (B=512, H=HH=128, two
// trunk layers, I=21) the function does 2*512*(2*128*128 + 128*2688 + 2688)
// = 389 MFLOP of multiply-adds, 352 MFLOP of them in the head, and must read
// about 1.7 MB (weights, z, dX) and write 256 KB: 5.8 us at the 67 TFLOP/s
// f32 CUDA-core peak of the SXM part, 2.4 us at its 495 TFLOP/s dense TF32
// rate divided by the three passes of 3xTF32, against 0.6 us at 3.35 TB/s.
// Bound by operations.  (A reckoning from the data sheet, not a
// measurement.)
//
// Two paths, chosen by the shape alone:
//
// - H and HH up to tc::kMaxDim (256): the tensor cores, two launches in
//   stream order.  Every product is mma.sync m16n8k8 in 3xTF32
//   (mma_tf32.cuh), f32 accumulation.
//     1. trunk_forward  the backward kernel's trunk pass (trunk_mma.cuh),
//                       unchanged, storing only u_n into the caller's (B, HH)
//                       scratch: a cluster of four blocks per 16 rows, each
//                       computing a quarter of every layer's columns and
//                       sharing them through distributed shared memory, so
//                       the trunk runs once per row (128 blocks at B=512).
//     2. head_forward   one block per (16-, 32- or 64-row tile, 64-column
//                       hidden strip, group of channels).  u_n's tile is
//                       staged and split once; for each channel of the group
//                       the W_o strip, the b_o strip and the dX column are
//                       staged while the previous channel computes, and
//                       out += tanh(u W_o + b_o) dX[:, i] accumulates in
//                       registers: every channel's strip lands on the same
//                       (row, column) fragment slots, so the sum over a
//                       group's channels needs no exchange.  The groups of
//                       one tile form a thread-block cluster along y (at most
//                       8, portable); each block leaves its partial tile in
//                       shared memory and the ranks sum it in rank order
//                       through distributed shared memory.  At the flagship
//                       shape: 64-row tiles x 2 strips x 6 groups of 4
//                       channels (the last of 1) = 96 blocks; at I=1, 16-row
//                       tiles, one group, 64 blocks.
//   A 64-row tile's channel costs about 3.7 us on one SM, the rate of
//   mma.sync in TF32 on this card: the head's time is its slowest block's
//   channels, so the grid spreads them over the SMs in one wave.  Grids are
//   sized from constants for the H100 SXM's 132 SMs (kTargetBlocks,
//   kWaveBlocks), so the grouping, the summation order and the bits depend
//   on the shape only, never on the card: two calls give the same bits, and
//   nothing uses atomics or device-memory partials.  Every staged tile is
//   zero-filled past the batch, H, HH and a strip, the K loops run over those
//   zeros to the next multiple of 16 and hold no branch, and outputs past
//   the edges are not stored.  Scratch is allocated by the caller
//   (oncde_fused_field_forward_scratch gives its size in floats).
//
// - H or HH above 256 (widths whose tiles do not fit shared memory on that
//   path): the CUDA cores, one launch of fused_field_forward_kernel, built
//   from field_pass.cuh's passes (the arithmetic of the interval kernel,
//   fused_rk4_interval.cu).  One block of 512 threads per (8-row batch
//   tile, 32-wide hidden strip) recomputes the trunk for its 8 rows and runs
//   the head G channels per pass (G = 8, or 1 for the rectilinear time
//   slice), adding tanh(...) * dX[:, i] into each thread's output registers.
//   It needs no scratch.  This path is the shape's, not a fallback: a launch
//   that fails on either path returns its error.
//
// Operand modes (the JAX op's bf16 storage and precision "bfloat16"; see
// mma_tf32.cuh's Mode).  Every path is instantiated for each of the four
// (storage, precision) pairs; the float32 / "float32" one is the code
// above, unchanged.  bf16 inputs are widened to f32 where they are staged,
// and the output is rounded to bf16 once, after the channel sum.  Under
// "bfloat16" the products' operands (z, each layer's output, u_n, the
// weights) are rounded to bf16 where they are staged; biases, tanh and the
// dX sum stay f32, as in the JAX reference.  A bf16-exact operand drops
// its 3xTF32 passes (f32 x bf16: two, bf16 x bf16: one), which leaves the
// bits as they are.

#include "field_pass.cuh"
#include "trunk_mma.cuh"

namespace {

// ------------------------------------------------- CUDA cores, wide widths

template <int G, int V, class M>
__global__ void __launch_bounds__(kThreads)
fused_field_forward_kernel(const typename M::Storage* __restrict__ z,
                           const typename M::Storage* __restrict__ dx,
                           TrunkOf<typename M::Storage> trunk,
                           const typename M::Storage* __restrict__ head_w,
                           const typename M::Storage* __restrict__ head_b,
                           typename M::Storage* __restrict__ out, int batch, int hidden,
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
    const float v = r < rows ? widen(z[(size_t)row0 * hidden + e]) : 0.f;
    xa[k * kRows + r] = M::kRound ? bf16_round(v) : v;
  }
  for (int e = tid; e < kRows * n_in; e += kThreads) {
    const int r = e / n_in;
    dxs[e] = r < rows ? widen(dx[(size_t)row0 * n_in + e]) : 0.f;
  }
  __syncthreads();

  // Trunk (xa -> xb -> xa ...), then the head's strip at h0.
  const float* u = trunk_forward<V, M>(xa, xb, xa, trunk, hidden, hh, wbuf, red);
  float out_acc[2];
  head_strip<G, V, M>(out_acc, u, head_w, head_b, dxs, hidden, hh, n_in, h0, wbuf, red);
  if (lead) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 2 * pair + r;
      if (h < hidden && row < rows)
        put(out + (size_t)(row0 + row) * hidden + h, out_acc[r]);
    }
  }
}

template <int G, int V, class M, class T = typename M::Storage>
int launch_cuda_cores(const T* z, const T* dx, const TrunkOf<T>& trunk, const T* head_w,
                      const T* head_b, T* out, int batch, int hidden, int hh, int n_in,
                      cudaStream_t stream) {
  const int dmax = hidden > hh ? hidden : hh;
  const size_t smem = sizeof(float) *
      ((size_t)dmax * kRows + (size_t)hh * kRows + ((kRows * n_in + 3) & ~3) +
       kRed + wbuf_floats(G));
  static size_t smem_set = 48 * 1024;  // the default dynamic limit
  const int err = reserve_smem(fused_field_forward_kernel<G, V, M>, smem, smem_set);
  if (err) return err;
  const dim3 grid((batch + kRows - 1) / kRows, (hidden + kLanes - 1) / kLanes);
  fused_field_forward_kernel<G, V, M><<<grid, kThreads, smem, stream>>>(
      z, dx, trunk, head_w, head_b, out, batch, hidden, hh, n_in);
  return (int)cudaGetLastError();
}

// ---------------------------------------- tensor cores, H and HH up to 256

namespace tc {

constexpr int kMaxGroups = 8;  // channel groups of one tile: a portable cluster
constexpr int kWaveBlocks = 3 * kTargetBlocks / 4;  // head blocks of one wave

struct HeadForwardGrid {
  int mt, row_tiles, hstrips;  // m16 tiles a block, row tiles, 64-column strips of H
  int cpg, groups;             // channels a group, groups (the cluster along y)
};

size_t head_forward_smem(int mt, int hh) {
  const size_t rt = 16 * mt, kp = pad16(hh);
  return (2 * rt * (kp + 4) + 2 * kp * kLdW + 2 * rt + 2 * kStrip + rt * kLdS) * sizeof(float);
}

HeadForwardGrid head_forward_grid(int batch, int hidden, int hh, int n_in) {
  HeadForwardGrid G;
  G.hstrips = cdiv(hidden, kStrip);
  const int most = n_in < kMaxGroups ? n_in : kMaxGroups;
  // The largest row tile whose blocks, with the channels in up to
  // kMaxGroups groups, still give half the SMs a block.
  G.mt = 1;
  for (int mt = 2; mt <= 4; mt *= 2)
    if ((long long)cdiv(batch, 16 * mt) * G.hstrips * most >= kTargetBlocks / 2 &&
        head_forward_smem(mt, hh) <= kMaxSmem)
      G.mt = mt;
  G.row_tiles = cdiv(batch, 16 * G.mt);
  // As many channel groups as three quarters of one wave hold: a cluster's
  // blocks must share one GPC, so the card holds fewer clusters of g blocks
  // than 132 / g (15 of 7 on an H100 SXM, where 16 spill into a second
  // wave), and the head's time is its slowest block's channels.
  const long long tiles = (long long)G.row_tiles * G.hstrips;
  const long long fit = kWaveBlocks / tiles;
  const int groups = fit < 1 ? 1 : fit < most ? (int)fit : most;
  G.cpg = cdiv(n_in, groups);
  G.groups = cdiv(n_in, G.cpg);
  return G;
}

// One (row tile, hidden strip, channel group) of the head: MT m16 tiles of
// rows, the strip's 64 columns of every channel of the group, which run in
// order, the next one staged while the current one computes.  The product's
// loop runs over zero-filled rows and columns to a fixed count and has no
// branch.
template <int MT, int V, class M = F32>
__global__ void __launch_bounds__(kThreads, 1)
head_forward(const typename M::Storage* __restrict__ dx, const float* __restrict__ u_last,
             const typename M::Storage* __restrict__ head_w,
             const typename M::Storage* __restrict__ head_b,
             typename M::Storage* __restrict__ out, int batch, int hidden, int hh, int n_in,
             int hstrips, int cpg) {
  constexpr int RT = 16 * MT;
  extern __shared__ __align__(16) float smem[];
  const int kp = pad16(hh), ldu = kp + 4;
  const int su = RT * ldu;            // big-to-small distance
  float* us = smem;                   // [RT][ldu] u_n tile, big; small at + su
  float* ws = us + 2 * su;            // [2][kp][kLdW]  W_o strip
  float* dxs = ws + 2 * kp * kLdW;    // [2][RT]        dX column
  float* bs = dxs + 2 * RT;           // [2][kStrip]    b_o strip
  float* part = bs + 2 * kStrip;      // [RT][kLdS]     the group's partial of out

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4, t = lane % 4;
  const int rt = blockIdx.x / hstrips, hs = blockIdx.x - rt * hstrips;
  const int row0 = rt * RT, h0 = hs * kStrip;
  const int rows = min(RT, batch - row0), ncols = min(kStrip, hidden - h0);
  const int i_begin = blockIdx.y * cpg, i_end = min(n_in, i_begin + cpg);
  const size_t ih = (size_t)n_in * hidden;

  auto load = [&](int i, int buf) {
    const size_t col0 = (size_t)i * hidden + h0;
    stage<V, kThreads, M::kRound>(ws + buf * kp * kLdW, kLdW, head_w + col0, ih, kp, kStrip,
                                  hh, ncols);
    if (tid < RT)
      copy_in<1>(dxs + buf * RT + tid, tid < rows ? dx + (size_t)(row0 + tid) * n_in + i : dx,
                 tid < rows);
    if (tid < kStrip / V)
      copy_in<V>(bs + buf * kStrip + V * tid, V * tid < ncols ? head_b + col0 + V * tid : head_b,
                 V * tid < ncols);
  };

  stage<V, kThreads, M::kRound>(us, ldu, u_last + (size_t)row0 * hh, hh, RT, kp, rows, hh);
  load(i_begin, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int e = tid; e < RT * kp; e += kThreads) {  // split u_n's tile in place
    const int r = e / kp, k = e - r * kp;
    tf32_split(us[r * ldu + k], us[r * ldu + k], us[su + r * ldu + k]);
  }

  // pre (RT x 64) = u_n tile (RT x kp) W_o strip (kp x 64): warp w owns MT
  // n-tiles of one m-tile (m1, n1 + n), so each A fragment serves MT tiles;
  // with fewer than four tiles, even and odd k-steps accumulate apart.
  constexpr int WPM = kWarps / MT, EO = MT == 4 ? 1 : 2;
  const int m1 = warp / WPM, n1 = (warp % WPM) * MT;
  float acc[MT][4] = {};  // out's partial over the group, on pre's slots
  for (int i = i_begin, buf = 0; i < i_end; ++i, buf ^= 1) {
    cp_async_wait<0>();
    __syncthreads();  // channel i staged; every warp is done with channel i - 1
    if (i + 1 < i_end) load(i + 1, buf ^ 1);
    cp_async_commit();

    const float* wsb = ws + buf * kp * kLdW;
    const float* dxb = dxs + buf * RT;
    const float* bsb = bs + buf * kStrip;
    float pre_hi[2][MT][4] = {}, pre_lo[2][MT][4] = {};
#pragma unroll 2
    for (int ks = 0; ks < kp / 8; ks += EO) {
#pragma unroll
      for (int h = 0; h < EO; ++h) {
        const FragA fa = frag_a_rows(us + 16 * m1 * ldu + 8 * (ks + h), ldu, su);
#pragma unroll
        for (int n = 0; n < MT; ++n) {
          const float* wp = wsb + (8 * (ks + h) + t) * kLdW + 8 * (n1 + n) + gq;
          mma_3xtf32<M::kExactAct, M::kExactW>(pre_hi[h][n], pre_lo[h][n], fa,
                                               frag_b(wp[0], wp[4 * kLdW]));
        }
      }
    }
    // Padded rows have dX = 0 and padded columns W_o = b_o = 0: no term.
#pragma unroll
    for (int n = 0; n < MT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * m1 + gq + 8 * (e / 2), col = 8 * (n1 + n) + 2 * t + e % 2;
        const float a = tanhf((pre_hi[0][n][e] + pre_lo[0][n][e]) +
                              (pre_hi[1][n][e] + pre_lo[1][n][e]) + bsb[col]);
        acc[n][e] = fmaf(a, dxb[r], acc[n][e]);
      }
    }
  }
  cp_async_wait<0>();

  if (gridDim.y == 1) {  // one group: the partial is out
#pragma unroll
    for (int n = 0; n < MT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * m1 + gq + 8 * (e / 2), col = 8 * (n1 + n) + 2 * t + e % 2;
        if (r < rows && col < ncols) put(out + (size_t)(row0 + r) * hidden + h0 + col, acc[n][e]);
      }
    return;
  }
  // The groups of this tile are the cluster's ranks (rank = blockIdx.y):
  // each leaves its partial in shared memory, and rank q sums its share of
  // the tile's entries over the ranks, in rank order.
  namespace cg = cooperative_groups;
  const cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
  for (int n = 0; n < MT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      part[(16 * m1 + gq + 8 * (e / 2)) * kLdS + 8 * (n1 + n) + 2 * t + e % 2] = acc[n][e];
  cluster.sync();
  const int groups = (int)gridDim.y;
  constexpr int kEntries = RT * kStrip;
  const int share = cdiv(kEntries, groups), e0 = (int)cluster.block_rank() * share;
  for (int e = e0 + tid; e < min(kEntries, e0 + share); e += kThreads) {
    const int r = e / kStrip, c = e % kStrip;
    float s = 0.f;
    for (int q = 0; q < groups; ++q) s += cluster.map_shared_rank(part, q)[r * kLdS + c];
    if (r < rows && c < ncols) put(out + (size_t)(row0 + r) * hidden + h0 + c, s);
  }
  cluster.sync();  // every block's partial stays until all ranks have read it
}

template <int MT, int V, class M, class T = typename M::Storage>
cudaError_t launch_head_forward(const HeadForwardGrid& G, const T* dx, const float* u_last,
                                const T* head_w, const T* head_b, T* out, int batch,
                                int hidden, int hh, int n_in, cudaStream_t s) {
  const size_t smem = head_forward_smem(MT, hh);
  const cudaError_t err = reserve_smem<head_forward<MT, V, M>>(smem);
  if (err != cudaSuccess) return err;
  return launch_cluster_y(head_forward<MT, V, M>, dim3(G.row_tiles * G.hstrips, G.groups),
                          dim3(kThreads), smem, s, G.groups, dx, u_last, head_w, head_b, out,
                          batch, hidden, hh, n_in, G.hstrips, G.cpg);
}

// How many of the head's clusters (G.groups blocks along y) the card holds
// at once, or -1 if the runtime cannot say; for reports only: the grid
// never depends on it.
template <int MT>
int head_clusters_at_once(const HeadForwardGrid& G, int hh) {
  const size_t smem = head_forward_smem(MT, hh);
  if (reserve_smem<head_forward<MT, 4>>(smem) != cudaSuccess) {
    cudaGetLastError();  // clear it: a report must not fail the next launch
    return -1;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(G.row_tiles * G.hstrips, G.groups);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = G.groups;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  int n = -1;
  if (cudaOccupancyMaxActiveClusters(&n, head_forward<MT, 4>, &config) != cudaSuccess) {
    cudaGetLastError();  // clear it: a report must not fail the next launch
    return -1;
  }
  return n;
}

template <int V, class M, class T = typename M::Storage>
cudaError_t launch(const T* z, const T* dx, const TrunkOf<T>& trunk, const T* head_w,
                   const T* head_b, T* out, float* u_last, int batch, int hidden, int hh,
                   int n_in, cudaStream_t s) {
  cudaError_t err = launch_trunk_forward<V, false, M>(z, trunk, u_last, batch, hidden, hh, s);
  if (err != cudaSuccess) return err;
  const HeadForwardGrid G = head_forward_grid(batch, hidden, hh, n_in);
  const auto head = G.mt == 4   ? launch_head_forward<4, V, M>
                    : G.mt == 2 ? launch_head_forward<2, V, M>
                                : launch_head_forward<1, V, M>;
  err = head(G, dx, u_last, head_w, head_b, out, batch, hidden, hh, n_in, s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace tc

bool valid(int batch, int hidden, int hh, int n_in, int n_trunk) {
  return n_trunk >= 1 && n_trunk <= kMaxTrunk && batch >= 1 && hidden >= 1 && hh >= 1 &&
         n_in >= 1;
}

// The path of a shape: the tensor cores unless H or HH exceeds their tiles.
bool tensor_cores(int hidden, int hh) { return hidden <= tc::kMaxDim && hh <= tc::kMaxDim; }

// Fills either path's trunk (the same fields); returns whether every
// weight is aligned for 4-element loads.
template <class Tr, class T>
bool fill_trunk(Tr& trunk, const void* const* trunk_w, const void* const* trunk_b,
                int n_trunk) {
  bool aligned = true;
  for (int l = 0; l < kMaxTrunk; ++l) {
    trunk.w[l] = l < n_trunk ? static_cast<const T*>(trunk_w[l]) : nullptr;
    trunk.b[l] = l < n_trunk ? static_cast<const T*>(trunk_b[l]) : nullptr;
    if (l < n_trunk) aligned = aligned && aligned_vec4<T>(trunk_w[l]);
  }
  trunk.n = n_trunk;
  return aligned;
}

// One call in operand mode M (the entry point's body).
template <class M, class T = typename M::Storage>
int forward(const void* zp, const void* dxp, const void* const* trunk_w,
            const void* const* trunk_b, int n_trunk, const void* head_wp, const void* head_bp,
            void* outp, float* scratch, long long scratch_floats, int batch, int hidden, int hh,
            int n_in, cudaStream_t s) {
  const T* z = static_cast<const T*>(zp);
  const T* dx = static_cast<const T*>(dxp);
  const T* head_w = static_cast<const T*>(head_wp);
  const T* head_b = static_cast<const T*>(head_bp);
  T* out = static_cast<T*>(outp);
  if (!tensor_cores(hidden, hh)) {
    TrunkOf<T> trunk;
    const bool vec = fill_trunk<TrunkOf<T>, T>(trunk, trunk_w, trunk_b, n_trunk) &&
                     hidden % 4 == 0 && hh % 4 == 0 && aligned_vec4<T>(head_w);
    if (n_in == 1)
      return vec ? launch_cuda_cores<1, 4, M>(z, dx, trunk, head_w, head_b, out, batch, hidden,
                                              hh, n_in, s)
                 : launch_cuda_cores<1, 1, M>(z, dx, trunk, head_w, head_b, out, batch, hidden,
                                              hh, n_in, s);
    return vec ? launch_cuda_cores<kHeadGroups, 4, M>(z, dx, trunk, head_w, head_b, out, batch,
                                                      hidden, hh, n_in, s)
               : launch_cuda_cores<kHeadGroups, 1, M>(z, dx, trunk, head_w, head_b, out, batch,
                                                      hidden, hh, n_in, s);
  }
  if (scratch_floats < (long long)batch * hh) return (int)cudaErrorInvalidValue;
  tc::TrunkOf<T> trunk;
  const bool vec = fill_trunk<tc::TrunkOf<T>, T>(trunk, trunk_w, trunk_b, n_trunk) &&
                   hidden % 4 == 0 && hh % 4 == 0 && aligned_vec4<T>(z) &&
                   aligned_vec4<T>(head_w) && aligned_vec4<T>(head_b) && aligned16(scratch);
  return (int)(vec ? tc::launch<4, M>(z, dx, trunk, head_w, head_b, out, scratch, batch, hidden,
                                      hh, n_in, s)
                   : tc::launch<1, M>(z, dx, trunk, head_w, head_b, out, scratch, batch, hidden,
                                      hh, n_in, s));
}

}  // namespace

extern "C" {

// Floats of scratch one call needs: u_n, (B, HH), on the tensor-core path;
// 0 on the CUDA-core path and for a shape that is not taken.
long long oncde_fused_field_forward_scratch(int batch, int hidden, int hh, int n_in,
                                            int n_trunk) {
  if (!valid(batch, hidden, hh, n_in, n_trunk) || !tensor_cores(hidden, hh)) return 0;
  return (long long)batch * hh;
}

// The launch geometry of a shape, for reports: on the tensor-core path
// (returns 1) grid = {trunk blocks, head blocks along x, channel groups
// (head blocks along y, the cluster), rows a head tile, channels a group,
// head clusters the card holds at once (cudaOccupancyMaxActiveClusters;
// -1 if it cannot say)}; on the CUDA-core path (returns 0) grid = {blocks
// along x, along y, 0, 8, 0, 0}.
int oncde_fused_field_forward_grid(int batch, int hidden, int hh, int n_in, int* grid) {
  if (!tensor_cores(hidden, hh)) {
    const int g[6] = {(batch + kRows - 1) / kRows, (hidden + kLanes - 1) / kLanes, 0, kRows,
                      0, 0};
    for (int q = 0; q < 6; ++q) grid[q] = g[q];
    return 0;
  }
  const tc::HeadForwardGrid G = tc::head_forward_grid(batch, hidden, hh, n_in);
  const auto fit = G.mt == 4 ? tc::head_clusters_at_once<4>
                   : G.mt == 2 ? tc::head_clusters_at_once<2>
                               : tc::head_clusters_at_once<1>;
  const int g[6] = {tc::cdiv(batch, tc::kRowTile) * tc::kCluster, G.row_tiles * G.hstrips,
                    G.groups, 16 * G.mt, G.cpg, fit(G, hh)};
  for (int q = 0; q < 6; ++q) grid[q] = g[q];
  return 1;
}

// Launches on `stream`; returns the first CUDA error that is not 0 (0 on
// success).  Every input and the output are stored as `dtype` (0: float32,
// 1: bfloat16); `precision` 1 rounds every product's operands to bf16 (0:
// they stay as stored).  trunk_w / trunk_b are host arrays of n_trunk
// device pointers; scratch holds scratch_floats floats.
int oncde_fused_field_forward(const void* z, const void* dx, const void* const* trunk_w,
                              const void* const* trunk_b, int n_trunk, const void* head_w,
                              const void* head_b, void* out, float* scratch,
                              long long scratch_floats, int batch, int hidden, int hh,
                              int n_in, int dtype, int precision, void* stream) {
  if (!valid(batch, hidden, hh, n_in, n_trunk)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto call = dtype == 0 && precision == 0   ? &forward<F32>
                    : dtype == 0 && precision == 1 ? &forward<Mode<float, true>>
                    : dtype == 1 && precision == 0 ? &forward<Mode<__nv_bfloat16, false>>
                    : dtype == 1 && precision == 1 ? &forward<Mode<__nv_bfloat16, true>>
                                                   : nullptr;
  if (call == nullptr) return (int)cudaErrorInvalidValue;
  return call(z, dx, trunk_w, trunk_b, n_trunk, head_w, head_b, out, scratch, scratch_floats,
              batch, hidden, hh, n_in, s);
}

const char* oncde_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
