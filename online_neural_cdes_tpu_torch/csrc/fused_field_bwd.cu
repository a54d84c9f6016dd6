// Fused CDE vector field, backward (vector-Jacobian product), for Hopper
// (sm_90a), float32 or bfloat16 storage, products on the tensor cores in
// 3xTF32 (fewer passes on bf16-exact operands).
//
// Replaces the TPU kernel online_neural_cdes_tpu/ops/kernels.py::
// _backward_pallas / _make_bwd_kernel (pl.pallas_call at kernels.py:367).
// Given the forward's inputs and the cotangent g (B, H) of its output
//
//     u_0 = z,  u_l = relu(u_{l-1} @ W_l + b_l)               l = 1..n
//     A   = tanh(u_n @ W_o + b_o)          (B, I*H), column i*H + h
//     out = sum_i A[:, i, :] * dX[:, i]
//
// it computes every cotangent group of _backward_pallas:
//
//     ddx[b, i]  = sum_h A[b, i, h] g[b, h]
//     dpre       = (dX (x) g) (1 - A^2)                       (B, I*H)
//     dW_o       = u_n^T dpre,  db_o = sum_b dpre
//     du_n       = dpre W_o^T, then for l = n..1:
//     dv_l       = du_l * (u_l > 0),  dW_l = u_{l-1}^T dv_l,
//     db_l       = sum_b dv_l,  du_{l-1} = dv_l W_l^T,   dz = du_0.
//
// Bound on the H100.  At the flagship training shape (B=512, H=HH=128,
// two trunk layers, I=21) the three products of each weight (forward
// recompute, weight grad, input grad) are 3 * 2 * 512 * (2*128*128 +
// 128*2688) = 1.16 GFLOP: 17.3 us at the 67 TFLOP/s f32 CUDA-core peak of
// the SXM part, 7.0 us at its 495 TFLOP/s dense TF32 rate divided by the
// three passes of 3xTF32.  The bytes it must move (inputs, weights, their
// grads) are about 4 MB, 1.2 us at 3.35 TB/s.  At I=1 (the rectilinear
// time slice) 0.15 GFLOP: 2.25 us on CUDA cores, 0.92 us in 3xTF32.  Bound
// by operations.  (A reckoning from the data sheet, not a measurement.)
//
// Design.
// - Every product runs on the tensor cores: mma.sync m16n8k8 TF32 with
//   each f32 operand split into a big and a small TF32 part (3xTF32,
//   mma_tf32.cuh), f32 accumulation.  One TF32 pass would miss the f32
//   gate by orders of magnitude; three passes keep about 21 bits.  An
//   operand that every warp of a block reads (the activation tiles, dpre's
//   strip) is split once, where it is written to shared memory.  The MMA
//   loops run to fixed counts over zero-filled padding and hold no branch:
//   ptxas does not overlap one k-step's loads with the last one's MMAs
//   across a branch.
// - Every tile reaches shared memory by cp.async, 16 bytes a copy when H
//   and HH are multiples of 4 (V = 4), else 4 bytes (V = 1), staged while
//   the previous tile computes.
// - The trunk's passes are chains of dependent layers on a 16-row tile
//   (the m16 of an MMA), only 32 tiles at B=512.  A cluster of four blocks
//   shares each tile: each block computes a quarter of every layer's
//   columns and writes them into all four blocks' shared memory
//   (distributed shared memory), so 128 blocks run the trunk.  Cluster
//   barriers are split into arrive and wait around independent work.
// - The TPU kernel sums the weight grads over its batch tiles in place,
//   because a TPU grid runs in order.  Here blocks run in parallel, so each
//   cross-block sum is placed where it is small:
//     * dpre (B x I*H, 5.5 MB at the flagship shape: it stays in L2) is
//       written once, and the weight-grad blocks walk the batch in order
//       over it, so dW_o needs no partials in device memory; where the
//       tiles leave most SMs idle (I=1) the batch splits into a few ranges
//       whose blocks form a cluster and sum their partials in rank order
//       through distributed shared memory;
//     * du_n's sum over the I*H head columns is split into a few column
//       groups (14 at the flagship shape, 3.7 MB) that one block each walks
//       in order, instead of one partial per 64-column strip (42, 11 MB);
//     * ddx's sum over h is split into the ceil(H / 64) strips of a channel.
//   Every partial is summed in a fixed order and nothing uses atomics: two
//   calls give the same bits.
// - Grids are sized for one wave on the H100 SXM's 132 SMs (kTargetBlocks,
//   a constant so that the summation order, and so the bits, do not depend
//   on the card).
//
// Four launches behind one entry point, in stream order:
//
//   1. trunk_forward   u_1..u_n, a cluster of four blocks per 16 rows; each
//                      block stages its columns of W_{l+1} while layer l
//                      computes (trunk_mma.cuh, shared with the forward
//                      kernel, which keeps only u_n).
//   2. head_backward   one block per (16-, 32- or 64-row tile, group of
//                      64-column strips): u_n's tile stays in shared memory,
//                      each strip of W_o, g, dX and b_o is staged while the
//                      previous strip computes; per strip it recomputes A,
//                      writes ddx's strip partial and dpre, and accumulates
//                      du_n += dpre W_o^T in registers over the group,
//                      written once as the group's partial.
//   3. trunk_backward  du_n and ddx from their partials, then back through
//                      the relu trunk to dz, keeping dv_l; a cluster of four
//                      blocks per 16 rows, as trunk_forward.
//   4. weight_grad     dW_o, db_o and every dW_l, db_l in one launch: one
//                      block per 64 x 32 output tile (and batch range),
//                      walking its rows 64 at a time through a three-deep
//                      ring.
//
// K replicas (oncde_fused_field_backward_multi): the same four launches
// with the replica along gridDim.z, every input offset by its replica
// stride (trunk_mma.cuh's Strides; 0 for a shared operand) and every
// output, weight grads included, per replica, summed over that replica's
// batch only.  The scratch holds K layouts; each grid counts the K
// replicas' blocks toward the wave (fewer strip groups, so fewer du_n
// partials, and fewer weight-grad batch ranges), and at K = 1 the grids,
// the code and so the bits are the single entry's.
//
// Ragged edges: every staged tile is zero-filled past the batch, past H
// and HH and past a strip's columns, and the K loops run over those zeros
// to the next multiple of 16; outputs past the edges are not stored.
// Scratch is allocated by the caller (oncde_fused_field_backward_scratch
// gives its size in floats); the kernel allocates nothing.
//
// Operand modes (mma_tf32.cuh's Mode), each launch instantiated for the
// four (storage, precision) pairs; the float32 / "float32" one is the code
// above, unchanged.  The reference is autograd (jax.vjp) through the plain
// forward, and the kernel rounds where it does.  Scratch (u_l, dv_l, dpre,
// the partials) stays f32.  bf16 storage: inputs widened where staged,
// each output (dz, ddx, every weight and bias grad) rounded once, after its
// last sum.  Precision "bfloat16": the products' operands (u_l, the
// weights) rounded where staged, and each cotangent of a rounded operand
// rounded after its full sum: du_n (after the groups' partials), each
// du_{l-1} and dz, and every dW (after the cross-block sum).  The biases,
// dpre and ddx are not products' operands and keep f32.

#include "trunk_mma.cuh"

namespace {

using namespace tc;

// Weight grads: 64 x 32 output tiles, 4 warps of 32 x 16, 64 batch rows a
// stage (strides 8 mod 32: the transposed fragment reads hit distinct banks).
constexpr int kWgThreads = 128;
constexpr int kWgM = 64, kWgN = 32, kWgRows = 64, kWgRing = 3;
constexpr int kMaxSplit = 8;  // batch ranges of one tile: a portable cluster
constexpr int kLdX = kWgM + 8;
constexpr int kLdD = kWgN + 8;
constexpr int kWgStage = kWgRows * (kLdX + kLdD);
constexpr int kProblems = 1 + kMaxTrunk;  // dW_o, then dW_1..dW_n

// One weight gradient W = X^T D (M x N), b = sum_b D, over the batch.  W
// and b are stored in the mode's storage type; X is f32 scratch or, for
// dW_1, z in the storage type (x_storage).
struct GradProblem {
  const void* x;   // (B, M), leading dimension m
  const float* d;  // (B, N), leading dimension n
  void* w;
  void* b;
  long long xs, ds, ws, bs;  // replica strides of x, d, w and b (elements)
  int m, n;
  int tiles_n, tile0;  // output tiles in n; the first tile's block index
  bool x_storage;
};

struct GradProblems {
  GradProblem p[kProblems];
  int count, tiles, split, rows_per_split;
};

struct HeadGrid {
  int mt, row_tiles, spg, groups;  // m16 tiles a block, blocks in rows, strips a group
};

struct Layout {
  HeadGrid head;
  int hstrips, strips;
  size_t acts, dv, dpre, dupart, ddxpart, total;  // offsets / size, floats
};

size_t round4(size_t n) { return (n + 3) & ~static_cast<size_t>(3); }

// W_o strip rows a head block stages: product 2's n-tiles reach 64 NQ
// rows, NQ = 2 up to HH = 128, else 4 (zero rows past HH).
__host__ __device__ constexpr int head_nq(int hh) { return pad16(hh) <= 128 ? 2 : 4; }
size_t head_smem_bytes(int mt, int hh) {
  const size_t rt = 16 * mt, kp = pad16(hh), kw = 64 * head_nq(hh);
  const size_t floats = 2 * rt * (kp + 4) + 2 * kw * kLdW + 2 * rt * kLdS + 2 * rt * kLdS +
                        2 * rt + 2 * kStrip + kWarps * rt;
  return floats * sizeof(float);
}

// Every grid below counts the blocks of all `replicas` replicas toward the
// wave (at K = 1, the single call's grid).
HeadGrid head_grid(int batch, int hh, int strips, int replicas) {
  HeadGrid G;
  // The largest row tile that still gives one block an SM; 64 rows only
  // for HH <= 128 (product 2's accumulators).
  G.mt = 1;
  for (int mt = 2; mt <= 4; mt *= 2)
    if ((long long)cdiv(batch, 16 * mt) * strips * replicas >= kTargetBlocks &&
        head_smem_bytes(mt, hh) <= kMaxSmem && (mt < 4 || head_nq(hh) == 2))
      G.mt = mt;
  G.row_tiles = cdiv(batch, 16 * G.mt);
  G.spg = (int)(((long long)G.row_tiles * strips * replicas + kTargetBlocks - 1) /
                kTargetBlocks);
  G.groups = cdiv(strips, G.spg);
  return G;
}

// The weight-grad problems; pointers are filled at launch.
GradProblems grad_problems(int batch, int hidden, int hh, int n_in, int n_trunk,
                           int replicas) {
  GradProblems P = {};
  P.count = 1 + n_trunk;
  int tiles = 0;
  for (int q = 0; q < P.count; ++q) {
    GradProblem& p = P.p[q];
    p.m = q == 1 ? hidden : hh;
    p.n = q == 0 ? n_in * hidden : hh;
    p.tiles_n = cdiv(p.n, kWgN);
    p.tile0 = tiles;
    tiles += cdiv(p.m, kWgM) * p.tiles_n;
  }
  P.tiles = tiles;
  // Split the batch only when the tiles leave most SMs idle: into up to
  // kMaxSplit ranges of whole stages, about two blocks an SM.
  const int all = tiles * replicas;
  int split = all >= kTargetBlocks / 2 ? 1 : cdiv(2 * kTargetBlocks, all);
  split = split < kMaxSplit ? split : kMaxSplit;
  split = split < cdiv(batch, kWgRows) ? split : cdiv(batch, kWgRows);
  P.rows_per_split = cdiv(cdiv(batch, split), kWgRows) * kWgRows;
  P.split = cdiv(batch, P.rows_per_split);
  return P;
}

// One replica's scratch (`total` floats; K replicas take K times it).
Layout layout(int batch, int hidden, int hh, int n_in, int n_trunk, int replicas = 1) {
  Layout L;
  L.hstrips = cdiv(hidden, kStrip);
  L.strips = n_in * L.hstrips;
  L.head = head_grid(batch, hh, L.strips, replicas);
  size_t off = 0;
  L.acts = off;    off += round4((size_t)n_trunk * batch * hh);
  L.dv = off;      off += round4((size_t)n_trunk * batch * hh);
  L.dpre = off;    off += round4((size_t)batch * n_in * hidden);
  L.dupart = off;  off += round4((size_t)L.head.groups * batch * hh);
  L.ddxpart = off; off += round4((size_t)L.hstrips * batch * n_in);
  L.total = off;
  return L;
}

size_t trunk_backward_smem(int hidden, int hh) {
  const size_t tile = kRowTile * trunk_ld(hidden, hh);
  const int sw = owned_segs(hidden > hh ? hidden : hh) * kSeg;
  const int swh = owned_segs(hh) * kSeg;
  return (5 * tile + 2 * (size_t)sw * (pad16(hh) + 4) + 2 * (size_t)kRowTile * swh) *
         sizeof(float);
}
constexpr size_t kWgSmemBytes = (size_t)kWgRing * kWgStage * sizeof(float);

// Column c_loc of the columns that cluster rank `rank` owns: n-tile j of a
// trunk product belongs to rank (j % 16) / 4, warp j % 4 of it, as its
// (j / 16)-th tile, so a rank owns [32 rank, +32) and [128 + 32 rank, +32).
__device__ __forceinline__ int owned_col(int rank, int c_loc) {
  return (c_loc / kSeg) * (kSeg * kCluster) + kSeg * rank + c_loc % kSeg;
}

// 2. One (row tile, strip group) of the head's backward.  MT m16 tiles of
// rows; the group's strips run in order, the next one staged while the
// current one computes.  Both products' loops run over zero-filled rows
// and columns to fixed counts and have no branch.
template <int MT, int NQ, int V, class M>
__global__ void __launch_bounds__(kThreads, 1)
head_backward(const typename M::Storage* __restrict__ dx,
              const typename M::Storage* __restrict__ g, const float* __restrict__ u_last,
              const typename M::Storage* __restrict__ head_w,
              const typename M::Storage* __restrict__ head_b, float* __restrict__ dpre,
              float* __restrict__ dupart, float* __restrict__ ddxpart, int batch,
              int hidden, int hh, int n_in, int hstrips, int strips, int spg, const Strides S) {
  dx = at_replica(dx, S.dx);
  g = at_replica(g, S.g);
  u_last = at_replica(u_last, S.scratch);
  head_w = at_replica(head_w, S.head_w);
  head_b = at_replica(head_b, S.head_b);
  dpre = at_replica(dpre, S.scratch);
  dupart = at_replica(dupart, S.scratch);
  ddxpart = at_replica(ddxpart, S.scratch);
  constexpr int RT = 16 * MT;
  extern __shared__ __align__(16) float smem[];
  const int kp = pad16(hh), ldu = kp + 4;
  constexpr int kw = 64 * NQ;        // W_o strip rows staged
  const int su = RT * ldu, sd = RT * kLdS;  // big-to-small distances
  float* us = smem;                   // [RT][ldu] u_n tile, big; small at + su
  float* ws = us + 2 * su;            // [2][kw][kLdW]      W_o strip
  float* gs = ws + 2 * kw * kLdW;     // [2][RT][kLdS]      g strip
  float* ds = gs + 2 * RT * kLdS;     // [RT][kLdS] dpre strip, big; small at + sd
  float* dxs = ds + 2 * sd;           // [2][RT]            dX column
  float* bs = dxs + 2 * RT;           // [2][kStrip]        b_o strip
  float* red = bs + 2 * kStrip;       // [kWarps][RT]       ddx's per-warp sums

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4, t = lane % 4;
  const int row0 = blockIdx.x * RT;
  const int rows = min(RT, batch - row0);
  const int s_begin = blockIdx.y * spg;
  const int s_end = min(strips, s_begin + spg);
  const size_t ih = (size_t)n_in * hidden;

  auto load = [&](int s, int buf) {
    const int i = s / hstrips, h0 = (s - i * hstrips) * kStrip;
    const int ncols = min(kStrip, hidden - h0);
    const size_t col0 = (size_t)i * hidden + h0;
    stage<V, kThreads, M::kRound>(ws + buf * kw * kLdW, kLdW, head_w + col0, ih, kw, kStrip,
                                  hh, ncols);
    stage<V, kThreads>(gs + buf * RT * kLdS, kLdS, g + (size_t)row0 * hidden + h0, hidden,
                       RT, kStrip, rows, ncols);
    if (tid < RT)
      copy_in<1>(dxs + buf * RT + tid, tid < rows ? dx + (size_t)(row0 + tid) * n_in + i : dx,
                 tid < rows);
    if (tid < kStrip / V)
      copy_in<V>(bs + buf * kStrip + V * tid, V * tid < ncols ? head_b + col0 + V * tid : head_b,
                 V * tid < ncols);
  };

  stage<V, kThreads, M::kRound>(us, ldu, u_last + (size_t)row0 * hh, hh, RT, kp, rows, hh);
  load(s_begin, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int e = tid; e < RT * kp; e += kThreads) {  // split u_n's tile in place
    const int r = e / kp, k = e - r * kp;
    tf32_split(us[r * ldu + k], us[r * ldu + k], us[su + r * ldu + k]);
  }

  // du_n's accumulators: warp w owns M2 m-tiles from mb2 and the n-tiles
  // j2 + NS2 q of hh (with MT = 4: two m-tiles and four n-tiles, HH <= 128).
  constexpr int M2 = MT == 4 ? 2 : MT, Q2 = MT == 4 ? 4 : NQ, NS2 = MT == 4 ? 4 : kWarps;
  const int mb2 = MT == 4 ? 2 * (warp / 4) : 0, j2 = MT == 4 ? warp % 4 : warp;
  float du_hi[M2][Q2][4] = {}, du_lo[M2][Q2][4] = {};
  const int ntiles = pad8(hh) / 8;

  for (int s = s_begin, buf = 0; s < s_end; ++s, buf ^= 1) {
    cp_async_wait<0>();
    __syncthreads();  // strip s staged; every warp is done with strip s - 1
    if (s + 1 < s_end) load(s + 1, buf ^ 1);
    cp_async_commit();

    const int i = s / hstrips, hs = s - i * hstrips, h0 = hs * kStrip;
    const int ncols = min(kStrip, hidden - h0);
    const size_t col0 = (size_t)i * hidden + h0;
    const float* wsb = ws + buf * kw * kLdW;
    const float* gsb = gs + buf * RT * kLdS;
    const float* dxb = dxs + buf * RT;
    const float* bsb = bs + buf * kStrip;

    // pre (RT x 64) = u_n tile (RT x kp) W_o strip (kp x 64): warp w owns
    // MT n-tiles of one m-tile (m1, n1 + i), so each A fragment serves MT
    // tiles; with fewer than four tiles, even and odd k-steps accumulate
    // apart.
    constexpr int WPM = kWarps / MT, EO = MT == 4 ? 1 : 2;
    const int m1 = warp / WPM, n1 = (warp % WPM) * MT;
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

    // A, ddx's partial over the strip, dpre.  Padded rows and columns give
    // g = 0, so dpre = 0 and no ddx term there.
    float part[2] = {};
#pragma unroll
    for (int n = 0; n < MT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * m1 + gq + 8 * (e / 2), col = 8 * (n1 + n) + 2 * t + e % 2;
        const float a = tanhf((pre_hi[0][n][e] + pre_lo[0][n][e]) +
                              (pre_hi[1][n][e] + pre_lo[1][n][e]) + bsb[col]);
        const float gv = gsb[r * kLdS + col];
        part[e / 2] = fmaf(a, gv, part[e / 2]);
        const float d = dxb[r] * gv * (1.f - a * a);
        tf32_split(d, ds[r * kLdS + col], ds[sd + r * kLdS + col]);
        if (r < rows && col < ncols) dpre[(size_t)(row0 + r) * ih + col0 + col] = d;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      part[h] += __shfl_xor_sync(0xffffffffu, part[h], 1);
      part[h] += __shfl_xor_sync(0xffffffffu, part[h], 2);
      if (t == 0) red[warp * RT + 16 * m1 + gq + 8 * h] = part[h];
    }
    __syncthreads();
    if (tid < rows) {  // the warps that hold the row's m-tile, in warp order
      float sum = 0.f;
      const int w0 = (tid / 16) * WPM;
#pragma unroll
      for (int w = 0; w < WPM; ++w) sum += red[(w0 + w) * RT + tid];
      ddxpart[((size_t)hs * batch + row0 + tid) * n_in + i] = sum;
    }

    // du (RT x kp) += dpre strip (RT x 64) W_o strip^T (64 x kp).
#pragma unroll
    for (int ks = 0; ks < kStrip / 8; ++ks) {
      FragA fa[M2];
#pragma unroll
      for (int m = 0; m < M2; ++m)
        fa[m] = frag_a_rows(ds + 16 * (mb2 + m) * kLdS + 8 * ks, kLdS, sd);
#pragma unroll
      for (int q = 0; q < Q2; ++q) {
        const float* wr = wsb + (8 * (j2 + NS2 * q) + gq) * kLdW + 8 * ks + t;
        const FragB fb = frag_b(wr[0], wr[4]);
#pragma unroll
        for (int m = 0; m < M2; ++m)
          mma_3xtf32<false, M::kExactW>(du_hi[m][q], du_lo[m][q], fa[m], fb);
      }
    }
  }
  cp_async_wait<0>();

  // The group's partial of du_n.
#pragma unroll
  for (int q = 0; q < Q2; ++q) {
    const int j = j2 + NS2 * q;
    if (j < ntiles) {
#pragma unroll
      for (int m = 0; m < M2; ++m) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 16 * (mb2 + m) + gq + 8 * (e / 2), k = 8 * j + 2 * t + e % 2;
          if (r < rows && k < hh)
            dupart[((size_t)blockIdx.y * batch + row0 + r) * hh + k] =
                du_hi[m][q][e] + du_lo[m][q][e];
        }
      }
    }
  }
}

// 3. du_n and ddx from their partials (in group and strip order), then back
// through the relu trunk to dz; keeps dv_l for the weight grads.  A
// cluster of four blocks owns 16 rows; each block owns a quarter of the
// columns (owned_col) of du and dv.  Per layer a block masks its columns of
// du into dv_l and writes them, split, into all four blocks' dv tile; after
// the cluster syncs, it computes its columns of du_{l-1} = dv_l W_l^T from
// its rows of W_l, staged while the previous layer computed.  As in
// trunk_forward, the MMA loop runs over zeros to a multiple of 16 and has
// no branch.
template <int V, int NQ, class M>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kTThreads, 1)
trunk_backward(const float* __restrict__ dupart, int groups,
               const float* __restrict__ ddxpart, int hstrips,
               const float* __restrict__ acts, TrunkOf<typename M::Storage> trunk,
               float* __restrict__ dv, typename M::Storage* __restrict__ dz,
               typename M::Storage* __restrict__ ddx, int batch, int hidden, int hh, int n_in,
               const Strides S) {
  dupart = at_replica(dupart, S.scratch);
  ddxpart = at_replica(ddxpart, S.scratch);
  acts = at_replica(acts, S.scratch);
  trunk = trunk_at_replica(trunk, S);
  dv = at_replica(dv, S.scratch);
  dz = at_replica(dz, S.out);
  ddx = at_replica(ddx, S.ddx);
  namespace cg = cooperative_groups;
  const cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const int ldt = trunk_ld(hidden, hh), tile = kRowTile * ldt;
  float* du = smem;                  // [kRowTile][ldt] (this block's columns)
  float* dvs = smem + tile;         // [2][kRowTile][ldt] big, then the same small
  float* slots = smem + 5 * tile;   // [2][sw][ldb] W_l's owned rows, by layer parity
  const int rank = (int)cluster.block_rank();
  constexpr int sw = NQ * kSeg;
  const int swh = owned_segs(hh) * kSeg;  // owned columns of hh
  const int kph = pad16(hh);
  const int ldb = kph + 4;           // 4 mod 8: row-wise fragment reads hit distinct banks
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = (blockIdx.x / kCluster) * kRowTile;
  const int rows = min(kRowTile, batch - row0);
  const int j0 = 4 * rank + warp;
  float* peer[kCluster];
#pragma unroll
  for (int p = 0; p < kCluster; ++p) peer[p] = cluster.map_shared_rank(smem, p);

  float* acs = slots + 2 * sw * ldb;  // [2][kRowTile][swh] u_l on the owned columns
  // Stages W_l's owned rows and u_l's owned columns (slot l % 2).
  auto load = [&](int l) {
    const int d_in = l == 0 ? hidden : hh;
    const auto* w = layer_w(trunk, l);
#pragma unroll
    for (int sg = 0; sg < NQ; ++sg) {
      const int r0 = sg * kSeg * kCluster + kSeg * rank;
      stage<V, kTThreads, M::kRound>(slots + ((l % 2) * sw + sg * kSeg) * ldb, ldb,
                                     w + (size_t)r0 * hh, hh, kSeg, kph, d_in - r0, hh);
    }
    for (int sg = 0; sg < swh / kSeg; ++sg) {
      const int c0 = sg * kSeg * kCluster + kSeg * rank;
      stage<V, kTThreads>(acs + (l % 2) * kRowTile * swh + sg * kSeg, swh,
                          acts + ((size_t)l * batch + row0) * hh + c0, hh, kRowTile, kSeg, rows,
                          hh - c0);
    }
  };
  load(trunk.n - 1);
  cp_async_commit();

  // du_n on this block's columns: the groups' partials, staged (as many
  // groups at a time as the dv tiles' space holds, before any peer writes
  // there) and summed in group order.
  {
    float* pbuf = dvs;
    const int cap = 4 * tile / (kRowTile * swh);
    float s[kPerT];
#pragma unroll
    for (int u = 0; u < kPerT; ++u) s[u] = 0.f;
    for (int q0 = 0; q0 < groups; q0 += cap) {
      const int qn = min(cap, groups - q0);
      for (int q = 0; q < qn; ++q)
        for (int sg = 0; sg < swh / kSeg; ++sg) {
          const int c0 = sg * kSeg * kCluster + kSeg * rank;
          stage<V, kTThreads>(pbuf + q * kRowTile * swh + sg * kSeg, swh,
                              dupart + ((size_t)(q0 + q) * batch + row0) * hh + c0, hh,
                              kRowTile, kSeg, rows, hh - c0);
        }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      for (int q = 0; q < qn; ++q)
#pragma unroll
        for (int u = 0; u < kPerT; ++u) {
          const int e = tid + u * kTThreads;
          if (e < kRowTile * swh) s[u] += pbuf[q * kRowTile * swh + e];
        }
      __syncthreads();
    }
#pragma unroll
    for (int u = 0; u < kPerT; ++u) {
      const int e = tid + u * kTThreads, r = e / swh, c = owned_col(rank, e % swh);
      if (r < kRowTile && c < kph) du[r * ldt + c] = M::kRound ? bf16_round(s[u]) : s[u];
    }
  }
  for (int e = rank * kTThreads + tid; e < kRowTile * n_in; e += kCluster * kTThreads) {
    const int r = e / n_in, i = e - r * n_in;
    if (r < rows) {
      float v[kMaxDim / kStrip];
#pragma unroll
      for (int q = 0; q < kMaxDim / kStrip; ++q)
        v[q] = q < hstrips ? ddxpart[((size_t)q * batch + row0 + r) * n_in + i] : 0.f;
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < kMaxDim / kStrip; ++q) s += v[q];
      put(ddx + (size_t)(row0 + r) * n_in + i, s);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // du complete; u_{n-1}'s columns and W_{n-1}'s rows landed
  // Barrier phases: S (every block is past its prologue, which used its dv
  // tiles' space; awaited before the first remote write), then D_l
  // (arrived after dv_l's remote writes, awaited before reading them).
  cluster_arrive();

  for (int l = trunk.n - 1; l >= 0; --l) {
    const int d_in = l == 0 ? hidden : hh;
    const int buf = (l % 2) * tile;
    // dv_l = du * (u_l > 0) on this block's columns, to every block's tile;
    // a thread takes column pairs (c, c + 1).
    float dvv[kPerT / 2][2];
#pragma unroll
    for (int u = 0; u < kPerT / 2; ++u) {
      const int e = tid + u * kTThreads, r = e / (swh / 2), cl = 2 * (e % (swh / 2));
      const int c = owned_col(rank, cl);
      const bool in = r < kRowTile && c < kph;
      const float* a = acs + ((l % 2) * kRowTile + r) * swh + cl;
      dvv[u][0] = in && a[0] > 0.f ? du[r * ldt + c] : 0.f;
      dvv[u][1] = in && a[1] > 0.f ? du[r * ldt + c + 1] : 0.f;
    }
    if (l == trunk.n - 1) cluster_wait();  // S: every block of the cluster runs
#pragma unroll
    for (int u = 0; u < kPerT / 2; ++u) {
      const int e = tid + u * kTThreads, r = e / (swh / 2), cl = 2 * (e % (swh / 2));
      const int c = owned_col(rank, cl);
      if (r < kRowTile && c < kph) {
        float2 big, small;
        tf32_split(dvv[u][0], big.x, small.x);
        tf32_split(dvv[u][1], big.y, small.y);
#pragma unroll
        for (int p = 0; p < kCluster; ++p) {
          *reinterpret_cast<float2*>(peer[p] + tile + buf + r * ldt + c) = big;
          *reinterpret_cast<float2*>(peer[p] + 3 * tile + buf + r * ldt + c) = small;
        }
      }
    }
    cluster_arrive();  // D_l
#pragma unroll
    for (int u = 0; u < kPerT / 2; ++u) {  // dv_l for the weight grads
      const int e = tid + u * kTThreads, r = e / (swh / 2), c = owned_col(rank, 2 * (e % (swh / 2)));
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (r < rows && c + h < hh) dv[((size_t)l * batch + row0 + r) * hh + c + h] = dvv[u][h];
    }
    cluster_wait();  // D_l: dv_l complete in every block
    if (l > 0) load(l - 1);
    cp_async_commit();

    // This block's columns of du_{l-1} (16 x d_in) = dv_l (16 x hh) W_l^T.
    const float* wsl = slots + (l % 2) * sw * ldb + (8 * warp + g) * ldb + t;
    const float* dva = dvs + buf;
    const int ntiles = pad16(d_in) / 8;
    float hi[2][NQ][4] = {}, lo[2][NQ][4] = {};  // even and odd k-steps
#pragma unroll 2
    for (int ks = 0; ks < kph / 8; ks += 2) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const FragA fa = frag_a_rows(dva + 8 * (ks + h), ldt, 2 * tile);
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const float* wp = wsl + kSeg * q * ldb + 8 * (ks + h);
          mma_3xtf32<M::kExactAct, M::kExactW>(hi[h][q], lo[h][q], fa, frag_b(wp[0], wp[4]));
        }
      }
    }
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int j = j0 + 16 * q;
      if (j < ntiles) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = g + 8 * (e / 2), col = 8 * j + 2 * t + e % 2;
          const float v = (hi[0][q][e] + lo[0][q][e]) + (hi[1][q][e] + lo[1][q][e]);
          const float vr = M::kRound ? bf16_round(v) : v;
          if (l > 0)
            du[r * ldt + col] = vr;
          else if (r < rows && col < hidden)
            put(dz + (size_t)(row0 + r) * hidden + col, vr);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // du complete for this block's next mask; W_{l-1}'s rows landed
  }
}


// 4. Every weight gradient W = X^T D, b = sum_b D in one launch: block
// (tile, range) owns a 64 x 32 tile of one problem's W and walks its batch
// range in order, 64 rows a stage, the next stage in flight.  Warp w owns
// the tile's rows 32 (w % 2) .. + 31 and columns 16 (w / 2) .. + 15 (2 x 2
// MMA tiles); warp 0 of the first row tile's blocks also sums b.  The
// ranges of one tile form a thread-block cluster: each block leaves its
// partial in shared memory and rank 0 sums them in rank order through
// distributed shared memory and writes W and b.
template <int V, class M>
__global__ void __launch_bounds__(kWgThreads, 1)
weight_grad(GradProblems P, int batch) {
  using T = typename M::Storage;
  extern __shared__ __align__(16) float smem[];  // [kWgRing][X: kWgRows x kLdX, D: x kLdD]
  GradProblem pr = P.p[0];
#pragma unroll
  for (int q = 1; q < kProblems; ++q)
    if (q < P.count && (int)blockIdx.x >= P.p[q].tile0) pr = P.p[q];
  pr.x = pr.x_storage ? static_cast<const void*>(at_replica(static_cast<const T*>(pr.x), pr.xs))
                      : static_cast<const void*>(at_replica(static_cast<const float*>(pr.x), pr.xs));
  pr.d = at_replica(pr.d, pr.ds);
  pr.w = at_replica(static_cast<T*>(pr.w), pr.ws);
  pr.b = at_replica(static_cast<T*>(pr.b), pr.bs);
  const int local = blockIdx.x - pr.tile0;
  const int tm = local / pr.tiles_n, tn = local - tm * pr.tiles_n;
  const int m0 = tm * kWgM, n0 = tn * kWgN;
  const int split = blockIdx.y;
  const int b_begin = split * P.rows_per_split;
  const int b_end = min(batch, b_begin + P.rows_per_split);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = 32 * (warp % 2), wn = 16 * (warp / 2);
  const bool bias = tm == 0 && tid < kWgN;
  const int chunks = b_end > b_begin ? cdiv(b_end - b_begin, kWgRows) : 0;

  auto load = [&](int c) {
    const int r0 = b_begin + c * kWgRows;
    float* st = smem + (c % kWgRing) * kWgStage;
    if (M::kBf16 && pr.x_storage)
      stage<V, kWgThreads, M::kRound>(st, kLdX, static_cast<const T*>(pr.x) + (size_t)r0 * pr.m + m0,
                                      pr.m, kWgRows, kWgM, b_end - r0, pr.m - m0);
    else
      stage<V, kWgThreads, M::kRound>(st, kLdX,
                                      static_cast<const float*>(pr.x) + (size_t)r0 * pr.m + m0,
                                      pr.m, kWgRows, kWgM, b_end - r0, pr.m - m0);
    stage<V, kWgThreads>(st + kWgRows * kLdX, kLdD, pr.d + (size_t)r0 * pr.n + n0, pr.n,
                         kWgRows, kWgN, b_end - r0, pr.n - n0);
  };

  float hi[2][2][4] = {}, lo[2][2][4] = {};
  float bacc = 0.f;
  for (int p = 0; p < kWgRing - 1; ++p) {
    if (p < chunks) load(p);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kWgRing - 2>();
    __syncthreads();  // stage c landed; every warp is done with stage c - 1
    if (c + kWgRing - 1 < chunks) load(c + kWgRing - 1);
    cp_async_commit();
    const float* xb = smem + (c % kWgRing) * kWgStage;
    const float* db = xb + kWgRows * kLdX;
#pragma unroll
    for (int ks = 0; ks < kWgRows / 8; ++ks) {
      // A = X^T: A[m][k] = X[k][m]; B = D.
      FragA fa[2];
      FragB fb[2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const float* x0 = xb + (8 * ks + t) * kLdX + wm + 16 * mi + g;
        fa[mi] = frag_a(x0[0], x0[8], x0[4 * kLdX], x0[4 * kLdX + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        const float* d0 = db + (8 * ks + t) * kLdD + wn + 8 * ni + g;
        fb[ni] = frag_b(d0[0], d0[4 * kLdD]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
          mma_3xtf32<M::kRound, false>(hi[mi][ni], lo[mi][ni], fa[mi], fb[ni]);
    }
    if (bias) {
#pragma unroll 8
      for (int r = 0; r < kWgRows; ++r) bacc += db[r * kLdD + tid];
    }
  }
  cp_async_wait<0>();

  // A weight grad is the cotangent of a rounded operand under precision
  // "bfloat16": rounded once, after the whole sum.
  const auto put_w = [&](size_t e, float v) {
    put(static_cast<T*>(pr.w) + e, M::kRound ? bf16_round(v) : v);
  };
  if (P.split == 1) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = m0 + wm + 16 * mi + g + 8 * (e / 2);
          const int n = n0 + wn + 8 * ni + 2 * t + e % 2;
          if (m < pr.m && n < pr.n) put_w((size_t)m * pr.n + n, hi[mi][ni][e] + lo[mi][ni][e]);
        }
    if (bias && n0 + tid < pr.n) put(static_cast<T*>(pr.b) + n0 + tid, bacc);
    return;
  }
  // The range's partial tile ([kWgM][kWgN], then b's kWgN) in shared memory.
  namespace cg = cooperative_groups;
  const cg::cluster_group cluster = cg::this_cluster();
  float* part = smem;
  __syncthreads();  // every warp is done with the stages
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        part[(wm + 16 * mi + g + 8 * (e / 2)) * kWgN + wn + 8 * ni + 2 * t + e % 2] =
            hi[mi][ni][e] + lo[mi][ni][e];
  if (tid < kWgN) part[kWgM * kWgN + tid] = bacc;
  cluster.sync();
  // Rank r sums its share of the tile's entries over the ranks, in rank order.
  constexpr int kEntries = (kWgM + 1) * kWgN;
  const int share = cdiv(kEntries, P.split), e0 = (int)cluster.block_rank() * share;
  for (int e = e0 + tid; e < min(kEntries, e0 + share); e += kWgThreads) {
    float s = 0.f;
    for (int r = 0; r < P.split; ++r) s += cluster.map_shared_rank(part, r)[e];
    const int m = m0 + e / kWgN, n = n0 + e % kWgN;
    if (e < kWgM * kWgN) {
      if (m < pr.m && n < pr.n) put_w((size_t)m * pr.n + n, s);
    } else if (tm == 0 && n < pr.n) {
      put(static_cast<T*>(pr.b) + n, s);
    }
  }
  cluster.sync();  // every block's partial stays until all ranks have read it
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

bool valid(int batch, int hidden, int hh, int n_in, int n_trunk) {
  return n_trunk >= 1 && n_trunk <= kMaxTrunk && batch >= 1 && hidden >= 1 &&
         hidden <= kMaxDim && hh >= 1 && hh <= kMaxDim && n_in >= 1 &&
         (long long)n_in * ((hidden + kStrip - 1) / kStrip) <= 65535;
}

template <int MT, int NQ, int V, class M, class T = typename M::Storage>
cudaError_t launch_head(dim3 blocks, size_t smem, cudaStream_t s, const T* dx, const T* g,
                        const float* u_last, const T* head_w, const T* head_b, float* scratch,
                        const Layout& L, int batch, int hidden, int hh, int n_in,
                        const Strides& S) {
  const cudaError_t err = reserve_smem<head_backward<MT, NQ, V, M>>(smem);
  if (err != cudaSuccess) return err;
  head_backward<MT, NQ, V, M><<<blocks, kThreads, smem, s>>>(
      dx, g, u_last, head_w, head_b, scratch + L.dpre, scratch + L.dupart, scratch + L.ddxpart,
      batch, hidden, hh, n_in, L.hstrips, L.strips, L.head.spg, S);
  return cudaGetLastError();
}

// The four launches for `replicas` replicas: the inputs at S's strides,
// the outputs dense (K, ...), replica r's scratch at r * S.scratch.
template <int V, class M, class T = typename M::Storage>
cudaError_t launch(const T* z, const T* dx, const T* g, const TrunkOf<T>& trunk,
                   const T* head_w, const T* head_b, T* dz, T* ddx, void* const* dtrunk_w,
                   void* const* dtrunk_b, T* dhead_w, T* dhead_b, float* scratch,
                   const Layout& L, int batch, int hidden, int hh, int n_in, cudaStream_t s,
                   int replicas, const Strides& S) {
  const int n_trunk = trunk.n;
  float* acts = scratch + L.acts;
  float* dv = scratch + L.dv;
  const float* u_last = acts + (size_t)(n_trunk - 1) * batch * hh;
  const dim3 trunk_blocks(cdiv(batch, kRowTile) * kCluster, 1, replicas);
  cudaError_t err;

  if ((err = launch_trunk_forward<V, true, M>(z, trunk, acts, batch, hidden, hh, s, replicas, S,
                                              S.scratch)) != cudaSuccess)
    return err;

  const HeadGrid& H = L.head;
  size_t smem = head_smem_bytes(H.mt, hh);
  const dim3 head_blocks(H.row_tiles, H.groups, replicas);
  const bool nq2 = head_nq(hh) == 2;
  const auto head = H.mt == 4 ? launch_head<4, 2, V, M>
                    : H.mt == 2 ? (nq2 ? launch_head<2, 2, V, M> : launch_head<2, 4, V, M>)
                                : (nq2 ? launch_head<1, 2, V, M> : launch_head<1, 4, V, M>);
  err = head(head_blocks, smem, s, dx, g, u_last, head_w, head_b, scratch, L, batch, hidden, hh,
             n_in, S);
  if (err != cudaSuccess) return err;

  smem = trunk_backward_smem(hidden, hh);
  if (owned_segs(hidden > hh ? hidden : hh) == 2) {
    if ((err = reserve_smem<trunk_backward<V, 2, M>>(smem)) != cudaSuccess) return err;
    trunk_backward<V, 2, M><<<trunk_blocks, kTThreads, smem, s>>>(
        scratch + L.dupart, H.groups, scratch + L.ddxpart, L.hstrips, acts, trunk, dv, dz,
        ddx, batch, hidden, hh, n_in, S);
  } else {
    if ((err = reserve_smem<trunk_backward<V, 1, M>>(smem)) != cudaSuccess) return err;
    trunk_backward<V, 1, M><<<trunk_blocks, kTThreads, smem, s>>>(
        scratch + L.dupart, H.groups, scratch + L.ddxpart, L.hstrips, acts, trunk, dv, dz,
        ddx, batch, hidden, hh, n_in, S);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  GradProblems P = grad_problems(batch, hidden, hh, n_in, n_trunk, replicas);
  P.p[0].x = u_last;
  P.p[0].d = scratch + L.dpre;
  P.p[0].w = dhead_w;
  P.p[0].b = dhead_b;
  P.p[0].xs = P.p[0].ds = S.scratch;
  P.p[0].ws = (long long)hh * n_in * hidden;
  P.p[0].bs = (long long)n_in * hidden;
  for (int l = 0; l < n_trunk; ++l) {
    GradProblem& p = P.p[1 + l];
    p.x = l == 0 ? static_cast<const void*>(z) : acts + (size_t)(l - 1) * batch * hh;
    p.x_storage = l == 0;
    p.d = dv + (size_t)l * batch * hh;
    p.w = dtrunk_w[l];
    p.b = dtrunk_b[l];
    p.xs = l == 0 ? S.z : S.scratch;
    p.ds = S.scratch;
    p.ws = (long long)(l == 0 ? hidden : hh) * hh;
    p.bs = hh;
  }
  if ((err = reserve_smem<weight_grad<V, M>>(kWgSmemBytes)) != cudaSuccess) return err;
  err = launch_cluster_y(weight_grad<V, M>, dim3(P.tiles, P.split, replicas), dim3(kWgThreads),
                         kWgSmemBytes, s, P.split, P, batch);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// One call in operand mode M (the entry points' body): `replicas`
// replicas with S's input strides (one replica and no strides for the
// single entry).
template <class M, class T = typename M::Storage>
int backward(const void* z, const void* dx, const void* g, const void* const* trunk_w,
             const void* const* trunk_b, int n_trunk, const void* head_w, const void* head_b,
             void* dz, void* ddx, void* const* dtrunk_w, void* const* dtrunk_b, void* dhead_w,
             void* dhead_b, float* scratch, const Layout& L, int batch, int hidden, int hh,
             int n_in, cudaStream_t s, int replicas, Strides S) {
  S.out = (long long)batch * hidden;
  S.ddx = (long long)batch * n_in;
  S.scratch = (long long)L.total;
  TrunkOf<T> trunk;
  bool vec = hidden % 4 == 0 && hh % 4 == 0 && aligned_vec4<T>(z) && aligned_vec4<T>(g) &&
             aligned_vec4<T>(head_w) && aligned_vec4<T>(head_b) && aligned16(scratch) &&
             strides_vec4(S, n_trunk);
  for (int l = 0; l < kMaxTrunk; ++l) {
    trunk.w[l] = l < n_trunk ? static_cast<const T*>(trunk_w[l]) : nullptr;
    trunk.b[l] = l < n_trunk ? static_cast<const T*>(trunk_b[l]) : nullptr;
    if (l < n_trunk) vec = vec && aligned_vec4<T>(trunk_w[l]);
  }
  trunk.n = n_trunk;
  const auto go = vec ? launch<4, M> : launch<1, M>;
  return (int)go(static_cast<const T*>(z), static_cast<const T*>(dx), static_cast<const T*>(g),
                 trunk, static_cast<const T*>(head_w), static_cast<const T*>(head_b),
                 static_cast<T*>(dz), static_cast<T*>(ddx), dtrunk_w, dtrunk_b,
                 static_cast<T*>(dhead_w), static_cast<T*>(dhead_b), scratch, L, batch, hidden,
                 hh, n_in, s, replicas, S);
}

using BackwardCall = int (*)(const void*, const void*, const void*, const void* const*,
                             const void* const*, int, const void*, const void*, void*, void*,
                             void* const*, void* const*, void*, void*, float*, const Layout&,
                             int, int, int, int, cudaStream_t, int, Strides);

// The body of an operand mode, or nullptr for codes that name none.
BackwardCall backward_of(int dtype, int precision) {
  return dtype == 0 && precision == 0   ? &backward<F32>
         : dtype == 0 && precision == 1 ? &backward<Mode<float, true>>
         : dtype == 1 && precision == 0 ? &backward<Mode<__nv_bfloat16, false>>
         : dtype == 1 && precision == 1 ? &backward<Mode<__nv_bfloat16, true>>
                                        : nullptr;
}

}  // namespace

extern "C" {

// Floats of scratch one call needs (0 if the shape is not taken).
long long oncde_fused_field_backward_scratch(int batch, int hidden, int hh, int n_in,
                                             int n_trunk) {
  if (!valid(batch, hidden, hh, n_in, n_trunk)) return 0;
  return (long long)layout(batch, hidden, hh, n_in, n_trunk).total;
}

// The largest H and HH taken (the shared-memory tiles' width).
int oncde_fused_field_backward_max_dim() { return kMaxDim; }

// Launches on `stream`; returns the first CUDA error that is not 0 (0 on
// success).  Every input and output is stored as `dtype` (0: float32, 1:
// bfloat16); `precision` 1 rounds every product's operands to bf16 (0:
// they stay as stored).  trunk_w / trunk_b / dtrunk_w / dtrunk_b are host
// arrays of n_trunk device pointers; scratch holds scratch_floats floats.
int oncde_fused_field_backward(const void* z, const void* dx, const void* g,
                               const void* const* trunk_w, const void* const* trunk_b,
                               int n_trunk, const void* head_w, const void* head_b, void* dz,
                               void* ddx, void* const* dtrunk_w, void* const* dtrunk_b,
                               void* dhead_w, void* dhead_b, float* scratch,
                               long long scratch_floats, int batch, int hidden, int hh,
                               int n_in, int dtype, int precision, void* stream) {
  if (!valid(batch, hidden, hh, n_in, n_trunk)) return (int)cudaErrorInvalidValue;
  const Layout L = layout(batch, hidden, hh, n_in, n_trunk);
  if (scratch_floats < (long long)L.total) return (int)cudaErrorInvalidValue;
  const BackwardCall call = backward_of(dtype, precision);
  if (call == nullptr) return (int)cudaErrorInvalidValue;
  return call(z, dx, g, trunk_w, trunk_b, n_trunk, head_w, head_b, dz, ddx, dtrunk_w, dtrunk_b,
              dhead_w, dhead_b, scratch, L, batch, hidden, hh, n_in,
              static_cast<cudaStream_t>(stream), 1, Strides{});
}

// Floats of scratch a K-replica call needs: K replicas' layouts, each
// sized for the K-replica grid (0 if the shape is not taken).
long long oncde_fused_field_backward_multi_scratch(int replicas, int batch, int hidden, int hh,
                                                   int n_in, int n_trunk) {
  if (replicas < 1 || !valid(batch, hidden, hh, n_in, n_trunk)) return 0;
  return (long long)replicas * layout(batch, hidden, hh, n_in, n_trunk, replicas).total;
}

// K replicas of the backward in the single entry's four launches, with the
// replica along gridDim.z.  Inputs as the forward multi entry's (a host
// array of kStrideSlots element strides {z, dx, g, head_w, head_b,
// w_0..3, b_0..3}; 0 for an operand every replica shares); every output
// dense (K, ...): dz (K, B, H), ddx (K, B, I), dW_l, db_l, dW_o, db_o each
// replica's own, summed over that replica's batch only.  Replica r's
// result is the single entry's on replica r's operands; at K = 1 it is the
// same launches, so the same bits.
int oncde_fused_field_backward_multi(const void* z, const void* dx, const void* g,
                                     const void* const* trunk_w, const void* const* trunk_b,
                                     int n_trunk, const void* head_w, const void* head_b,
                                     void* dz, void* ddx, void* const* dtrunk_w,
                                     void* const* dtrunk_b, void* dhead_w, void* dhead_b,
                                     float* scratch, long long scratch_floats, int replicas,
                                     const long long* strides, int batch, int hidden, int hh,
                                     int n_in, int dtype, int precision, void* stream) {
  if (replicas < 1 || replicas > 65535 || !valid(batch, hidden, hh, n_in, n_trunk))
    return (int)cudaErrorInvalidValue;
  const Layout L = layout(batch, hidden, hh, n_in, n_trunk, replicas);
  if (scratch_floats < (long long)replicas * (long long)L.total) return (int)cudaErrorInvalidValue;
  const BackwardCall call = backward_of(dtype, precision);
  if (call == nullptr) return (int)cudaErrorInvalidValue;
  return call(z, dx, g, trunk_w, trunk_b, n_trunk, head_w, head_b, dz, ddx, dtrunk_w, dtrunk_b,
              dhead_w, dhead_b, scratch, L, batch, hidden, hh, n_in,
              static_cast<cudaStream_t>(stream), replicas, input_strides(strides));
}

const char* oncde_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
