// One whole RK4 (3/8) interval of the fused CDE field on Hopper's tensor
// cores: a thread-block cluster per row tile, every product in 3xTF32.
// Included by fused_rk4_interval.cu, which chooses between this route and
// its CUDA-core kernel by shape (see the note there).
//
// Layout of the work.  A cluster of CS blocks owns R = 16 MT batch rows.
// Rank r of the cluster owns
//   - a strip of h state columns, [r h, r h + h) (h the power of two >= 8
//     with CS h >= H): its columns of z0, k1, k2, k3, of the stage input
//     and of every k_s, over all I channels of the head;
//   - o columns of every trunk layer's output, [r o, r o + o) (o = pad8 of
//     HH / CS).
// A stage runs the trunk layer by layer: each rank computes its o columns
// from the full input tile and writes them into every rank's copy of the
// next activation tile (distributed shared memory), then the cluster
// syncs.  Tiles hold f32 values; an A fragment is split into its TF32 parts
// as it is read.  The head then needs no
// exchange: the rank's strip of k_s is sum_i tanh(u_n W_o[:, i H + strip]
// + b) dX[:, i], from the full u_n tile.  The rank updates its strip of the
// state and writes its strip of the next stage's input into every rank's
// input tile, and the cluster syncs: n_trunk + 1 cluster barriers a stage.
// Only out is written to device memory.
//
// Weights stream from L2 through a ring of three cp.async tile buffers, the
// same sequence of tiles every stage: each trunk layer's owned columns (all
// rows), then the head strip in (channel group, k chunk) tiles; the next two
// tiles are in flight while the current one computes.
//
// Warps.  Trunk: the (m16 tile, n8 tile) units of the owned columns, one
// warp each.  Head: warp w owns n8 tile w % (h / 8) of the strip and the
// channels i with i % S == w / (h / 8) (S = 8 / (h / 8) channel subsets),
// for all MT m16 tiles, so each B fragment serves MT tiles and each A
// fragment all of the warp's channels of a k step; the warp's channel count
// in a group is a compile-time constant (head_group_n), so a k step's MMAs
// are one unbranched stream.  A warp sums its
// channels' tanh(.) dX in registers in channel order; the S subsets'
// partial sums are added in subset order through shared memory.
//
// Bits.  Every output element is the same arithmetic in the same order for
// any B, any replica count and any MT: the k loops run in order over the
// same zero-padded depths, the channel subsets depend on H and CS only,
// and CS is fixed by the shape's widths.  No atomics.
//
// Operand modes (mma_tf32.cuh's Mode): float32 or bfloat16 storage, f32
// products.  A bf16 weight is exact in TF32, so its passes with a zero
// small part are dropped (EB).  The A operand is bf16-exact only in stage
// 1's first trunk layer (z widened); every later stage input, every u_l
// and u_n are f32 sums and keep all three passes.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "trunk_mma.cuh"

namespace {
namespace tc {
namespace rk4 {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBuffers = 3;  // weight tiles in the ring: two in flight

// Accumulator slots a head warp holds per channel group: CPW channels x
// MT m16 tiles x (hi, lo) x 4 = 64 registers.
__host__ __device__ constexpr int cpw(int mt) { return 8 / mt; }
// Leading dimension of a staged weight tile of n columns (n a multiple of
// 8): 8 mod 16, so the B-fragment reads of a warp hit distinct banks.
__host__ __device__ constexpr int ldw(int n) { return n % 16 == 8 ? n : pad16(n) + 8; }

template <class T>
struct Params {
  const T* z;        // (K, B, H)
  const T* dx;       // (K, B, I)
  TrunkOf<T> trunk;  // layer l (K, d_in, HH), bias (K, HH)
  const T* head_w;   // (K, HH, I*H)
  const T* head_b;   // (K, I*H)
  T* out;            // (K, B, H)
  int batch, hidden, hh, n_in;
  // Geometry (Geo below).
  int h, h_shift, s, o, lda, ldo, ldg, kh, kc, gc, ngroups, nchunks, buf;
};

// The geometry of one (shape, cluster size, m16 tiles) configuration.
struct Geo {
  int cs, mt, h, s, o, lda, ldo, ldg, kh, kc, gc, ngroups, nchunks, buf;
  size_t smem;  // bytes
  bool ok;      // fits the shared-memory budget
};

inline Geo geometry(int cs, int mt, int hidden, int hh, int n_in, size_t budget) {
  Geo g;
  g.cs = cs, g.mt = mt;
  const int rows = 16 * mt;
  g.h = 8;
  while (g.h * cs < hidden) g.h *= 2;
  g.s = kWarps / (g.h / 8);
  if (g.s < 1) g.s = 1;
  g.o = pad8(cdiv(hh, cs));
  const int dmax = pad16(hidden > hh ? hidden : hh);
  // Wide enough for every rank's owned trunk columns and state strip (cs o
  // and cs h may pass pad16 of the widths); 4 mod 8: A-fragment reads hit
  // distinct banks.
  g.lda = (dmax > cs * g.o ? dmax : cs * g.o);
  g.lda = (g.lda > cs * g.h ? g.lda : cs * g.h) + 4;
  g.ldo = ldw(g.o);
  g.kh = pad16(hh);
  const size_t fixed = 3 * (size_t)rows * g.lda               // stage input, two activations
                       + (size_t)g.s * rows * g.h + 4 * (size_t)rows * g.h  // partials, state
                       + ((rows * n_in + 3) & ~3) + (size_t)n_in * g.h;     // dX, head bias
  const long long avail = (long long)(budget / sizeof(float)) - (long long)fixed;
  const int trunk_tile = dmax * g.ldo;
  const long long per = avail / kBuffers;
  // The most channels a group (up to what the warps hold), then the most
  // k rows a chunk, that fit beside the trunk tile's buffer.
  const int most = n_in < g.s * cpw(mt) ? n_in : g.s * cpw(mt);
  g.gc = most;
  while (g.gc > 1 && 16LL * ldw(g.gc * g.h) > (per > trunk_tile ? per : trunk_tile)) --g.gc;
  g.ldg = ldw(g.gc * g.h);
  const long long room = per > trunk_tile ? per : trunk_tile;
  g.kc = 16;
  while (g.kc * 2 <= g.kh && 2LL * g.kc * g.ldg <= room) g.kc *= 2;
  g.ngroups = cdiv(n_in, g.gc);
  g.nchunks = cdiv(g.kh, g.kc);
  g.buf = (trunk_tile > g.kc * g.ldg ? trunk_tile : g.kc * g.ldg);
  g.buf = (g.buf + 3) & ~3;
  g.smem = (fixed + kBuffers * (size_t)g.buf) * sizeof(float);
  g.ok = g.smem <= budget;
  return g;
}

// Stages rows x cols of weights into dst (leading dimension lds) as f32,
// column c of row r read at src + r * ld + off(c) where col(c, off) says
// whether the V-group at c exists (zeros where not, and at rows >=
// rvalid).  Each thread walks its elements by adding a fixed (row, column)
// step, so the loop holds no division.  A float source goes by cp.async, a
// bf16 one by loads widened in registers, four in flight a thread.
template <int V, class T, class Col>
__device__ __forceinline__ void stage_cols(float* dst, int lds, const T* src, size_t ld,
                                           int rows, int cols, int rvalid, Col col) {
  const int step = kThreads * V;
  const int dr = step / cols, dc = step - dr * cols;
  int r = threadIdx.x * V / cols, c = threadIdx.x * V - r * cols;
  auto advance = [&]() {
    r += dr, c += dc;
    if (c >= cols) c -= cols, ++r;
  };
  if constexpr (std::is_same<T, float>::value) {
    for (; r < rows; advance()) {
      size_t off;
      const bool ok = col(c, off) && r < rvalid;
      cp_async<V>(dst + r * lds + c, ok ? src + (size_t)r * ld + off : src, ok);
    }
  } else {
    constexpr int kIn = 4;
    while (r < rows) {
      float v[kIn][V];
      int at[kIn];
#pragma unroll
      for (int j = 0; j < kIn; ++j) {
        size_t off = 0;
        const bool in = r < rows;
        const bool ok = in && col(c, off) && r < rvalid;
        load_vec<V, false>(v[j], src + (ok ? (size_t)r * ld + off : 0), ok);
        at[j] = in ? r * lds + c : -1;
        advance();
      }
#pragma unroll
      for (int j = 0; j < kIn; ++j)
        if (at[j] >= 0) store_vec<V>(dst + at[j], v[j]);
    }
  }
}

// The A fragment of the 16 x 8 block at p of a row-major f32 tile
// (leading dimension ld), split into its TF32 parts as it is read.
__device__ __forceinline__ FragA frag_a_raw(const float* p, int ld) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const float* r0 = p + g * ld + t;
  const float* r1 = r0 + 8 * ld;
  return frag_a(r0[0], r1[0], r0[4], r1[4]);
}

// The rank's owned columns of one trunk layer: u = relu(x W_l + b_l) for
// the (m16, n8) units of its o columns, written into every rank's tile
// (at dst_off of each rank's shared memory).  x is the full input tile, w
// the staged [pad16(d_in)][ldo] owned columns.
template <int CS, int MT, bool EA, bool EB, class T>
__device__ __forceinline__ void trunk_layer(const float* x, const float* w, const T* bias,
                                            float* const (&peer)[CS], int dst_off, int lda,
                                            int ldo, int d_in, int hh, int j0, int o) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int units = MT * (o / 8);
  const int ksteps = pad16(d_in) / 8;
  for (int u = warp; u < units; u += kWarps) {
    const int m = u % MT, jn = u / MT;
    // Even and odd k-steps in separate accumulators: four MMA chains.
    float hi[2][4] = {}, lo[2][4] = {};
    const float* xa = x + 16 * m * lda;
    const float* wp0 = w + t * ldo + 8 * jn + g;
#pragma unroll 2
    for (int ks = 0; ks < ksteps; ks += 2) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const FragA fa = frag_a_raw(xa + 8 * (ks + e), lda);
        const float* wp = wp0 + 8 * (ks + e) * ldo;
        mma_3xtf32<EA, EB>(hi[e], lo[e], fa, frag_b(wp[0], wp[4 * ldo]));
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {  // rows g and g + 8, columns 2t, 2t + 1
      const int row = 16 * m + g + 8 * hr, col = j0 + 8 * jn + 2 * t;
      float v[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 2 * hr + c;
        v[c] = col + c < hh ? fmaxf((hi[0][e] + lo[0][e]) + (hi[1][e] + lo[1][e]) +
                                        widen(bias[col + c]), 0.f)
                            : 0.f;
      }
      const float2 pair = make_float2(v[0], v[1]);
      const int off = dst_off + row * lda + col;
#pragma unroll
      for (int p = 0; p < CS; ++p) *reinterpret_cast<float2*>(peer[p] + off) = pair;
    }
  }
}

// One channel group of the head for one warp: NQ channels (the warp's of
// the group, q * S apart), its n8 tile of the strip, all MT m16 tiles, over
// the group's k chunks (next() waits for each and returns its tile); then
// acc += tanh(pre + b) dX[:, i] in channel order.  NQ is a compile-time
// count, so the MMAs of a k step run in one unbranched stream.  wcol is
// the slot-0 column of the warp's n8 tile in the staged tile, bias and dx
// point at slot 0's head bias strip (+ the n8 tile) and dX column.
template <int NQ, int MT, bool EB, class Next>
__device__ __forceinline__ void head_group(Next& next, float (&acc)[MT][4], const float* x,
                                           int lda, int wcol, int ldg, int kc, int kh,
                                           int nchunks, int s, int h, const float* bias,
                                           const float* dx, int n_in) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  constexpr int Q = NQ > 0 ? NQ : 1;
  float hi[Q][MT][4] = {}, lo[Q][MT][4] = {};
  const int qstride = s * h;
  for (int c = 0; c < nchunks; ++c) {
    const float* w = next();
    if constexpr (NQ > 0) {
      const int k0 = c * kc, ksteps = min(kc, kh - k0) / 8;
      const float* wp0 = w + t * ldg + wcol + g;
      for (int ks = 0; ks < ksteps; ++ks) {
        FragA fa[MT];
#pragma unroll
        for (int m = 0; m < MT; ++m) fa[m] = frag_a_raw(x + 16 * m * lda + k0 + 8 * ks, lda);
        const float* wp = wp0 + 8 * ks * ldg;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const FragB fb = frag_b(wp[q * qstride], wp[q * qstride + 4 * ldg]);
#pragma unroll
          for (int m = 0; m < MT; ++m) mma_3xtf32<false, EB>(hi[q][m], lo[q][m], fa[m], fb);
        }
      }
    }
  }
  // Padded rows have dX = 0 and padded columns W_o = b_o = 0: no term.
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * m + g + 8 * (e / 2), col = 2 * t + e % 2;
        const float a = tanhf((hi[q][m][e] + lo[q][m][e]) + bias[q * qstride + col]);
        acc[m][e] = fmaf(a, dx[r * n_in + q * s], acc[m][e]);
      }
  }
}

// head_group with its channel count nq (0..cpw(MT)) made a compile-time
// constant.
template <int MT, bool EB, int NQ = 0, class Next>
__device__ __forceinline__ void head_group_n(int nq, Next& next, float (&acc)[MT][4],
                                             const float* x, int lda, int wcol, int ldg,
                                             int kc, int kh, int nchunks, int s, int h,
                                             const float* bias, const float* dx, int n_in) {
  if constexpr (NQ <= cpw(MT)) {
    if (nq == NQ)
      head_group<NQ, MT, EB>(next, acc, x, lda, wcol, ldg, kc, kh, nchunks, s, h, bias, dx,
                             n_in);
    else
      head_group_n<MT, EB, NQ + 1>(nq, next, acc, x, lda, wcol, ldg, kc, kh, nchunks, s, h,
                                   bias, dx, n_in);
  }
}

// The interval for one row tile (blockIdx.x / CS), rank blockIdx.x % CS of
// its cluster, replica blockIdx.y.  M is the operand mode, V the vector
// width of the weight loads (4 when H, HH and the pointers allow).
template <class M, int CS, int MT, int V>
__global__ void __launch_bounds__(kThreads, MT == 1 ? 2 : 1)
rk4_interval_tc(Params<typename M::Storage> p) {
  using T = typename M::Storage;
  namespace cg = cooperative_groups;
  constexpr int R = 16 * MT;
  const cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const int lda = p.lda, tile = R * p.lda;
  const int h = p.h, nt8 = h / 8;
  float* zin = smem;                          // [R][lda] the stage input
  float* act = zin + tile;                    // [2][R][lda] u_l, by layer parity
  float* wb = act + 2 * tile;                 // [kBuffers][buf] weight tiles
  float* part = wb + kBuffers * p.buf;        // [S][R][h] head partials
  float* st = part + p.s * R * h;             // [4][R][h] z0, k1, k2, k3 of the strip
  float* dxs = st + 4 * R * h;                // [R][I]
  float* bs = dxs + ((R * p.n_in + 3) & ~3);  // [I][h] head bias strip

  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid / 32;
  const int hidden = p.hidden, hh = p.hh, n_in = p.n_in, n = p.trunk.n;
  const int row0 = (blockIdx.x / CS) * R;
  const int rows = min(R, p.batch - row0);
  const int c0 = rank * h, j0 = rank * p.o;
  const size_t ih = (size_t)n_in * hidden;

  // This block's replica.
  const size_t rep = blockIdx.y;
  const T* z = p.z + rep * p.batch * hidden;
  const T* dx = p.dx + rep * p.batch * n_in;
  T* out = p.out + rep * p.batch * hidden;
  const T* head_w = p.head_w + rep * hh * ih;
  const T* head_b = p.head_b + rep * ih;
  TrunkOf<T> trunk = p.trunk;
#pragma unroll
  for (int l = 0; l < kMaxTrunk; ++l) {
    if (l < n) {
      trunk.w[l] += rep * (l == 0 ? hidden : hh) * hh;
      trunk.b[l] += rep * hh;
    }
  }
  float* peer[CS];
#pragma unroll
  for (int q = 0; q < CS; ++q) peer[q] = cluster.map_shared_rank(smem, q);

  // Tile j of the interval's weight sequence (the same every stage):
  // trunk layer q for q < n, then head (group, chunk) in group-major order.
  const int per_stage = n + p.ngroups * p.nchunks;
  const int total = 4 * per_stage;
  auto load = [&](int j) {
    float* dst = wb + (j % kBuffers) * p.buf;
    const int q = j % per_stage;
    if (q < n) {
      const int d_in = q == 0 ? hidden : hh;
      stage_cols<V>(dst, p.ldo, layer_w(trunk, q), hh, pad16(d_in), p.o, d_in,
                    [&](int c, size_t& off) {
                      off = j0 + c;
                      return j0 + c < hh;
                    });
    } else {
      const int grp = (q - n) / p.nchunks, k0 = ((q - n) % p.nchunks) * p.kc;
      const int i0 = grp * p.gc;
      stage_cols<V>(dst, p.ldg, head_w + (size_t)k0 * ih, ih, min(p.kc, p.kh - k0),
                    p.gc * h, hh - k0, [&](int c, size_t& off) {
                      const int i = i0 + (c >> p.h_shift), hc = c0 + (c & (h - 1));
                      off = (size_t)i * hidden + hc;
                      return i < n_in && hc < hidden;
                    });
    }
  };

  // The first cluster barrier (every block of the cluster runs) is awaited
  // before the first remote write.
  cluster_arrive();
  stage<V, kThreads>(zin, lda, z + (size_t)row0 * hidden, hidden, R, pad16(hidden), rows,
                     hidden);
  load(0);
  cp_async_commit();
  load(1);
  cp_async_commit();
  for (int e = tid; e < R * h; e += kThreads) {
    const int r = e / h, c = e % h;
    const bool ok = r < rows && c0 + c < hidden;
    st[e] = ok ? widen(z[(size_t)(row0 + r) * hidden + c0 + c]) : 0.f;
  }
  for (int e = tid; e < R * n_in; e += kThreads) {
    const int r = e / n_in;
    dxs[e] = r < rows ? widen(dx[(size_t)row0 * n_in + e]) : 0.f;
  }
  for (int e = tid; e < n_in * h; e += kThreads) {
    const int i = e / h, c = e % h;
    bs[e] = c0 + c < hidden ? widen(head_b[(size_t)i * hidden + c0 + c]) : 0.f;
  }

  // Waits for tile j (and everything staged before it), frees the ring's
  // oldest buffer, puts tile j + 2 in flight and returns tile j.
  int j = 0;
  auto next = [&]() -> const float* {
    cp_async_wait<kBuffers - 2>();
    __syncthreads();
    if (j + 2 < total) load(j + 2);
    cp_async_commit();
    return wb + (j++ % kBuffers) * p.buf;
  };

  const int jn = warp % nt8, sub = warp / nt8;
  const float third = 1.f / 3.f;
#pragma unroll 1
  for (int s = 0; s < 4; ++s) {
    const float* x = zin;
    for (int l = 0; l < n; ++l) {
      const float* w = next();
      const int dst = (1 + (l & 1)) * tile;
      const int d_in = l == 0 ? hidden : hh;
      if (s == 0 && l == 0) cluster_wait();  // every block of the cluster runs
      if (s == 0 && l == 0 && M::kBf16)      // z is bf16-exact only here
        trunk_layer<CS, MT, true, M::kExactW>(x, w, layer_b(trunk, l), peer, dst, lda, p.ldo,
                                              d_in, hh, j0, p.o);
      else
        trunk_layer<CS, MT, false, M::kExactW>(x, w, layer_b(trunk, l), peer, dst, lda,
                                               p.ldo, d_in, hh, j0, p.o);
      cluster_arrive();  // u_l complete in every block once all arrive
      cluster_wait();
      x = smem + dst;
    }

    // Head: this warp's n8 tile of the strip, its channel subset.
    float acc[MT][4] = {};
    for (int grp = 0; grp < p.ngroups; ++grp) {
      const int i0 = grp * p.gc, i1 = min(n_in, i0 + p.gc);
      const int first = i0 + ((sub - i0 % p.s) % p.s + p.s) % p.s;
      const int nq = sub < p.s && first < i1 ? cdiv(i1 - first, p.s) : 0;
      head_group_n<MT, M::kExactW>(nq, next, acc, x, lda, (first - i0) * h + 8 * jn, p.ldg,
                                   p.kc, p.kh, p.nchunks, p.s, h, bs + first * h + 8 * jn,
                                   dxs + first, n_in);
    }
    if (sub < p.s) {
      const int lane = tid % 32, g = lane / 4, t = lane % 4;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          part[(sub * R + 16 * m + g + 8 * (e / 2)) * h + 8 * jn + 2 * t + e % 2] = acc[m][e];
    }
    __syncthreads();

    // The strip's k_s: the subsets' partials in subset order; then the
    // state update, and the next stage's input into every block.
    float* k1 = st + R * h;
    float* k2 = k1 + R * h;
    float* k3 = k2 + R * h;
    for (int e = 2 * tid; e < R * h; e += 2 * kThreads) {
      const int r = e / h, c = e % h;
      float nxt[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float k = part[e + q];
        for (int b = 1; b < p.s; ++b) k += part[b * R * h + e + q];
        const float zz = st[e + q];
        if (s == 0) {
          k1[e + q] = k;
          nxt[q] = zz + third * k;
        } else if (s == 1) {
          k2[e + q] = k;
          nxt[q] = zz + k - third * k1[e + q];
        } else if (s == 2) {
          k3[e + q] = k;
          nxt[q] = zz + k1[e + q] - k2[e + q] + k;
        } else {
          nxt[q] = zz + (k1[e + q] + 3.f * (k2[e + q] + k3[e + q]) + k) * 0.125f;
          if (r < rows && c0 + c + q < hidden)
            put(out + (size_t)(row0 + r) * hidden + c0 + c + q, nxt[q]);
        }
      }
      if (s < 3) {
        const float2 pair = make_float2(nxt[0], nxt[1]);
#pragma unroll
        for (int q = 0; q < CS; ++q)
          *reinterpret_cast<float2*>(peer[q] + r * lda + c0 + c) = pair;
      }
    }
    if (s < 3) {
      cluster_arrive();  // the next stage's input complete in every block
      cluster_wait();
    }
  }
  cp_async_wait<0>();
}

// Launches the interval over the batch and the replicas: a cluster of CS
// blocks along x per R-row tile.
template <class M, int CS, int MT>
cudaError_t launch(const Params<typename M::Storage>& p, const Geo& G, bool vec, int replicas,
                   cudaStream_t s) {
  const auto kernel = vec ? rk4_interval_tc<M, CS, MT, 4> : rk4_interval_tc<M, CS, MT, 1>;
  const cudaError_t err =
      vec ? reserve_smem<rk4_interval_tc<M, CS, MT, 4>>(G.smem)
          : reserve_smem<rk4_interval_tc<M, CS, MT, 1>>(G.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cdiv(p.batch, 16 * MT) * CS, replicas);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = G.smem;
  config.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, p);
}

// How many clusters of this configuration the card holds at once (-1 if
// the runtime cannot say); clears any error it meets.
template <int CS, int MT>
int clusters_at_once(const Geo& G) {
  const auto kernel = rk4_interval_tc<F32, CS, MT, 4>;
  if (reserve_smem<rk4_interval_tc<F32, CS, MT, 4>>(G.smem) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(CS * 64);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = G.smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  int fit = -1;
  if (cudaOccupancyMaxActiveClusters(&fit, kernel, &config) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return fit;
}

}  // namespace rk4
}  // namespace tc
}  // namespace
