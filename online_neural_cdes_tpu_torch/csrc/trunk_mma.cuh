// The fused CDE vector field's trunk pass on Hopper's tensor cores, shared
// by the forward kernel (fused_field.cu) and the backward kernel
// (fused_field_bwd.cu), with the constants and helpers both kernels' tensor-
// core launches use: cp.async staging, cluster barriers, the cluster launch.
//
//     u_0 = z,  u_l = relu(u_{l-1} @ W_l + b_l)               l = 1..n
//
// Every product is mma.sync m16n8k8 in 3xTF32 (mma_tf32.cuh).  The trunk's
// layers are a chain of small dependent products on 16-row tiles (the m16
// of an MMA), only 32 tiles at B=512; a cluster of four blocks shares each
// tile, each block computing a quarter of every layer's columns and writing
// them into all four blocks' shared memory (distributed shared memory), so
// 128 blocks run the trunk.
//
// Everything here is in namespace tc (tensor cores), so that a source can
// also include field_pass.cuh, whose CUDA-core passes use some of the same
// names (Trunk, kThreads, cp_async, trunk_forward).
//
// Operand modes (mma_tf32.cuh's Mode).  A float operand reaches shared
// memory by cp.async; a bf16 one, or a float one that a product rounds to
// bf16 (precision "bfloat16"), is read into registers, widened or rounded
// there and stored as floats, so every tile in shared memory holds f32
// values and the MMA loops are the same in every mode.  The trunk pass
// rounds what the next product reads (z, each layer's output on its way to
// the peers' tiles), never u_l itself: the backward's relu masks read it.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "mma_tf32.cuh"

namespace {
namespace tc {

constexpr int kMaxTrunk = 4;
constexpr int kMaxDim = 256;        // largest H and HH taken
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTargetBlocks = 132;  // one wave on the H100 SXM
constexpr size_t kMaxSmem = 227 * 1024;
// Trunk passes: a cluster of kCluster blocks of kTThreads threads shares a
// 16-row tile (one m16 tile); each block owns segments of kSeg columns
// (owned_col).  Activation tiles are [16][trunk_ld] (4 mod 8: A-fragment
// reads hit distinct banks).
constexpr int kRowTile = 16;
constexpr int kCluster = 4;
constexpr int kTThreads = 128;
constexpr int kSeg = 32;
constexpr int kPerT = kRowTile * 2 * kSeg / kTThreads;  // owned tile elements a thread
// Heads: 64-column strips inside one channel.
constexpr int kStrip = 64;
constexpr int kLdS = kStrip + 4;  // g and dpre strips (4 mod 8: row-wise reads)
constexpr int kLdW = kStrip + 8;  // W_o strip (8 mod 32: column-wise reads)

template <class T>
struct TrunkOf {
  const T* w[kMaxTrunk];  // layer l: (d_in, hh) row-major, d_in = H for l = 0
  const T* b[kMaxTrunk];  // (hh,)
  int n;
};
using Trunk = TrunkOf<float>;

// Replica strides of a launch, in elements.  The K-replica entry points
// (oncde_fused_field_*_multi) launch the single entries' kernels with
// gridDim.z = K: block (x, y, r) runs replica r's operands, each r times its
// stride past replica 0's, with the code a single launch runs.  Inputs may
// have stride 0 (an operand every replica shares); outputs and scratch are
// dense.  A single launch has gridDim.z = 1, so no stride is ever applied.
struct Strides {
  long long z, dx, g, head_w, head_b;  // inputs
  long long w[kMaxTrunk], b[kMaxTrunk];
  long long out, ddx;                  // (B, H) outputs (out, dz), ddx (B, I)
  long long scratch;                   // one replica's scratch, floats
};

// p advanced to this block's replica.
template <class T>
__device__ __forceinline__ T* at_replica(T* p, long long stride) {
  return p + (size_t)blockIdx.z * (size_t)stride;
}

// The input strides a multi entry point receives: a host array of
// kStrideSlots elements, {z, dx, g, head_w, head_b, w_0..w_3, b_0..b_3}
// (the forward ignores g; layers past n_trunk are ignored).
constexpr int kStrideSlots = 5 + 2 * kMaxTrunk;
inline Strides input_strides(const long long* in) {
  Strides S = {};
  S.z = in[0], S.dx = in[1], S.g = in[2], S.head_w = in[3], S.head_b = in[4];
  for (int l = 0; l < kMaxTrunk; ++l) S.w[l] = in[5 + l], S.b[l] = in[5 + kMaxTrunk + l];
  return S;
}

// Whether every replica of the operands loaded 4 elements at a time (z,
// g, the weights, the head bias) stays aligned to 4 elements.
inline bool strides_vec4(const Strides& S, int n_trunk) {
  bool ok = S.z % 4 == 0 && S.g % 4 == 0 && S.head_w % 4 == 0 && S.head_b % 4 == 0;
  for (int l = 0; l < n_trunk; ++l) ok = ok && S.w[l] % 4 == 0;
  return ok;
}

template <class T>
__device__ __forceinline__ TrunkOf<T> trunk_at_replica(TrunkOf<T> t, const Strides& s) {
#pragma unroll
  for (int q = 0; q < kMaxTrunk; ++q) {
    t.w[q] = at_replica(t.w[q], s.w[q]);
    t.b[q] = at_replica(t.b[q], s.b[q]);
  }
  return t;
}

__host__ __device__ constexpr int pad8(int n) { return (n + 7) & ~7; }
__host__ __device__ constexpr int pad16(int n) { return (n + 15) & ~15; }
__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// cp.async of V floats (V = 4: 16 bytes, V = 1: 4 bytes); zeros when !valid.
template <int V>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (V == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(valid ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// V elements at src as floats (widened from bf16; rounded to bf16 if R),
// or zeros when !valid.  With V = 4, src is aligned to 4 elements.
template <int V, bool R, class T>
__device__ __forceinline__ void load_vec(float (&v)[V], const T* src, bool valid) {
  if (!valid) {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = 0.f;
    return;
  }
  if constexpr (V == 4 && std::is_same<T, float>::value) {
    const float4 q = *reinterpret_cast<const float4*>(src);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else if constexpr (V == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(src);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
    v[0] = __low2float(lo), v[1] = __high2float(lo), v[2] = __low2float(hi),
    v[3] = __high2float(hi);
  } else {
    v[0] = widen(*src);
  }
  if (R) {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = bf16_round(v[i]);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* dst, const float (&v)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  else
    dst[0] = v[0];
}

// V elements from src into shared memory at dst as floats, zeros when
// !valid (src is then any readable address): cp.async for a float source
// kept as it is, else a load widened (bf16) or rounded to bf16 (R) in
// registers.
template <int V, bool R = false, class T>
__device__ __forceinline__ void copy_in(float* dst, const T* src, bool valid) {
  if constexpr (std::is_same<T, float>::value && !R) {
    cp_async<V>(dst, src, valid);
  } else {
    float v[V];
    load_vec<V, R>(v, src, valid);
    store_vec<V>(dst, v);
  }
}

// Stages rows x cols (cols a multiple of V) of a row-major matrix at src
// (leading dimension ld) into shared memory at dst (leading dimension
// lds); entries at rows >= rvalid or columns >= cvalid read as 0.  With
// V = 4, ld, cvalid and src are multiples of 4 elements.  A float source
// kept as it is goes by cp.async; a bf16 source, or one rounded to bf16
// (R), by loads into registers, kIn of them in flight a thread.
template <int V, int NT, bool R = false, class T>
__device__ __forceinline__ void stage(float* dst, int lds, const T* src, size_t ld, int rows,
                                      int cols, int rvalid, int cvalid) {
  const int per_row = cols / V;
  if constexpr (std::is_same<T, float>::value && !R) {
    for (int e = threadIdx.x; e < rows * per_row; e += NT) {
      const int r = e / per_row, c = (e - r * per_row) * V;
      const bool ok = r < rvalid && c < cvalid;
      cp_async<V>(dst + r * lds + c, ok ? src + (size_t)r * ld + c : src, ok);
    }
  } else {
    constexpr int kIn = 4;
    const int total = rows * per_row;
    for (int e0 = threadIdx.x; e0 < total; e0 += kIn * NT) {
      float v[kIn][V];
#pragma unroll
      for (int j = 0; j < kIn; ++j) {
        const int e = e0 + j * NT, r = e / per_row, c = (e - r * per_row) * V;
        load_vec<V, R>(v[j], src + (size_t)r * ld + c, e < total && r < rvalid && c < cvalid);
      }
#pragma unroll
      for (int j = 0; j < kIn; ++j) {
        const int e = e0 + j * NT, r = e / per_row, c = (e - r * per_row) * V;
        if (e < total) store_vec<V>(dst + r * lds + c, v[j]);
      }
    }
  }
}

// The two halves of a cluster barrier (release / acquire), so that a block
// does independent work between signalling that its writes are done and
// waiting for its peers'.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// trunk.w[l] / trunk.b[l] without indexing the parameter by a runtime l
// (which would copy the struct to local memory).
template <class T>
__device__ __forceinline__ const T* layer_w(const TrunkOf<T>& t, int l) {
  const T* p = t.w[0];
#pragma unroll
  for (int q = 1; q < kMaxTrunk; ++q)
    if (q == l) p = t.w[q];
  return p;
}
template <class T>
__device__ __forceinline__ const T* layer_b(const TrunkOf<T>& t, int l) {
  const T* p = t.b[0];
#pragma unroll
  for (int q = 1; q < kMaxTrunk; ++q)
    if (q == l) p = t.b[q];
  return p;
}

__host__ __device__ constexpr int trunk_ld(int hidden, int hh) {
  return pad16(hidden > hh ? hidden : hh) + 4;
}
// Segments of kSeg columns a cluster rank owns of a width-d product.
__host__ __device__ constexpr int owned_segs(int d) { return pad8(d) > kSeg * kCluster ? 2 : 1; }
size_t trunk_forward_smem(int hidden, int hh) {
  const size_t tile = kRowTile * trunk_ld(hidden, hh);
  const int kmax = pad16(hidden > hh ? hidden : hh);
  return (4 * tile + 2 * (size_t)kmax * (owned_segs(hh) * kSeg + 8)) * sizeof(float);
}

// u_l for every layer (ALL: acts[l][b][j], the backward's recompute) or
// for the last layer only (!ALL: acts[b][j], the forward's u_n).  A
// cluster of four blocks owns 16 rows (one m16 tile); each block computes
// its quarter of every layer's columns and writes them, split, into all
// four blocks' copy of the next activation tile (distributed shared
// memory), then the cluster syncs.  A block stages only its columns of
// each W_l, the next layer's while the current one computes.  K runs to a
// multiple of 16 over zeros and every warp computes its NQ tiles, so the
// MMA loop has no branch.  M is the operand mode (mma_tf32.cuh); acts
// are f32 in every mode.
template <int V, int NQ, bool ALL, class M = F32>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kTThreads, 1)
trunk_forward(const typename M::Storage* __restrict__ z, TrunkOf<typename M::Storage> trunk,
              float* __restrict__ acts, int batch, int hidden, int hh, const Strides S,
              long long acts_stride) {
  z = at_replica(z, S.z);
  trunk = trunk_at_replica(trunk, S);
  acts = at_replica(acts, acts_stride);
  namespace cg = cooperative_groups;
  const cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const int ldt = trunk_ld(hidden, hh), tile = kRowTile * ldt;
  float* xs = smem;                  // [2][kRowTile][ldt] big, then the same small
  float* slots = smem + 4 * tile;    // [2][kmax][ldw] W_l's owned columns, by layer parity
  const int rank = (int)cluster.block_rank();
  constexpr int ldw = NQ * kSeg + 8;  // 8 mod 32: B-fragment reads hit distinct banks
  const int kmax = pad16(hidden > hh ? hidden : hh);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = (blockIdx.x / kCluster) * kRowTile;
  const int rows = min(kRowTile, batch - row0);
  const int ntiles = pad16(hh) / 8;
  const int j0 = 4 * rank + warp;    // this warp's n-tiles: j0 + 16 q
  float* peer[kCluster];
#pragma unroll
  for (int p = 0; p < kCluster; ++p) peer[p] = cluster.map_shared_rank(smem, p);

  auto load = [&](int l) {
    const int d_in = l == 0 ? hidden : hh;
    const auto* w = layer_w(trunk, l);
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int c0 = q * kSeg * kCluster + kSeg * rank;
      stage<V, kTThreads, M::kRound>(slots + (l % 2) * kmax * ldw + q * kSeg, ldw, w + c0, hh,
                                     pad16(d_in), kSeg, d_in, hh - c0);
    }
  };

  // Barrier phases: S (arrived now, awaited before the first remote write),
  // then P_l (arrived after layer l's remote writes, awaited before layer
  // l + 1 reads them, or before the block exits).
  cluster_arrive();
  load(0);
  stage<V, kTThreads, M::kRound>(xs, ldt, z + (size_t)row0 * hidden, hidden, kRowTile,
                                 pad16(hidden), rows, hidden);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int e = tid; e < kRowTile * pad16(hidden); e += kTThreads) {  // split z in place
    const int r = e / pad16(hidden), k = e - r * pad16(hidden);
    tf32_split(xs[r * ldt + k], xs[r * ldt + k], xs[2 * tile + r * ldt + k]);
  }
  __syncthreads();

  int cur = 0;
  for (int l = 0; l < trunk.n; ++l) {
    // P_{l-1}: the activation tile is complete in every block, W_l landed,
    // and every block is done reading layer l - 1's input.
    if (l > 0) cluster_wait();
    if (l + 1 < trunk.n) load(l + 1);
    cp_async_commit();
    const int d_in = l == 0 ? hidden : hh;
    const float* wsl = slots + (l % 2) * kmax * ldw + 8 * warp + g;
    const float* xa = xs + cur * tile;
    const auto* __restrict__ b = layer_b(trunk, l);
    float bias[NQ][2];
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * (j0 + 16 * q) + 2 * t + e;
        bias[q][e] = col < hh ? widen(b[col]) : 0.f;
      }
    // Even and odd k-steps in separate accumulators: four MMA chains a tile.
    float hi[2][NQ][4] = {}, lo[2][NQ][4] = {};
    const int ksteps = pad16(d_in) / 8;
#pragma unroll 2
    for (int ks = 0; ks < ksteps; ks += 2) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const FragA fa = frag_a_rows(xa + 8 * (ks + h), ldt, 2 * tile);
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const float* wp = wsl + (8 * (ks + h) + t) * ldw + kSeg * q;
          mma_3xtf32<M::kExactAct, M::kExactW>(hi[h][q], lo[h][q], fa,
                                               frag_b(wp[0], wp[4 * ldw]));
        }
      }
    }
    if (l == 0) cluster_wait();  // S: every block of the cluster runs
    const int nxt = (cur ^ 1) * tile;
    float v[NQ][4];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int j = j0 + 16 * q;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + e % 2;
        v[q][e] = col < hh ? fmaxf((hi[0][q][e] + lo[0][q][e]) + (hi[1][q][e] + lo[1][q][e]) +
                                       bias[q][e % 2], 0.f)
                           : 0.f;
      }
      if (j < ntiles && l + 1 < trunk.n) {  // the last layer feeds only acts
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // rows g and g + 8, columns 2t, 2t + 1
          const int off = nxt + (g + 8 * h) * ldt + 8 * j + 2 * t;
          float2 big, small;
          tf32_split(M::kRound ? bf16_round(v[q][2 * h]) : v[q][2 * h], big.x, small.x);
          tf32_split(M::kRound ? bf16_round(v[q][2 * h + 1]) : v[q][2 * h + 1], big.y, small.y);
#pragma unroll
          for (int p = 0; p < kCluster; ++p) {
            *reinterpret_cast<float2*>(peer[p] + off) = big;
            *reinterpret_cast<float2*>(peer[p] + 2 * tile + off) = small;
          }
        }
      }
    }
    cp_async_wait<0>();  // W_{l+1}'s columns, before P_l publishes them
    cluster_arrive();    // P_l
    if (ALL || l + 1 == trunk.n) {
      const size_t layer = ALL ? (size_t)l : 0;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = g + 8 * (e / 2), col = 8 * (j0 + 16 * q) + 2 * t + e % 2;
          if (r < rows && col < hh) acts[(layer * batch + row0 + r) * hh + col] = v[q][e];
        }
      }
    }
    cur ^= 1;
  }
  cluster_wait();  // P_{n-1}: no peer writes into this block any more
}

// Raises a kernel's dynamic shared-memory limit the first time a launch
// needs more than the current one.
template <auto Kernel>
cudaError_t reserve_smem(size_t smem) {
  static size_t smem_set = 48 * 1024;  // the default dynamic limit
  if (smem <= smem_set) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) smem_set = smem;
  return err;
}

// Launches trunk_forward over the batch of each of `replicas` replicas: a
// cluster of four blocks per 16 rows, NQ = owned_segs(hh) column segments
// a rank; replica r's acts at r * acts_stride.
template <int V, bool ALL, class M = F32>
cudaError_t launch_trunk_forward(const typename M::Storage* z,
                                 const TrunkOf<typename M::Storage>& trunk, float* acts,
                                 int batch, int hidden, int hh, cudaStream_t s,
                                 int replicas = 1, const Strides& S = Strides{},
                                 long long acts_stride = 0) {
  const dim3 blocks(cdiv(batch, kRowTile) * kCluster, 1, replicas);
  const size_t smem = trunk_forward_smem(hidden, hh);
  cudaError_t err;
  if (owned_segs(hh) == 2) {
    if ((err = reserve_smem<trunk_forward<V, 2, ALL, M>>(smem)) != cudaSuccess) return err;
    trunk_forward<V, 2, ALL, M><<<blocks, kTThreads, smem, s>>>(z, trunk, acts, batch, hidden,
                                                                hh, S, acts_stride);
  } else {
    if ((err = reserve_smem<trunk_forward<V, 1, ALL, M>>(smem)) != cudaSuccess) return err;
    trunk_forward<V, 1, ALL, M><<<blocks, kTThreads, smem, s>>>(z, trunk, acts, batch, hidden,
                                                                hh, S, acts_stride);
  }
  return cudaGetLastError();
}

// Launches `kernel` with clusters of cy blocks along y.
template <class... Params, class... Args>
cudaError_t launch_cluster_y(void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem,
                             cudaStream_t stream, int cy, Args... args) {
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = block;
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cy;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, args...);
}

}  // namespace tc
}  // namespace
