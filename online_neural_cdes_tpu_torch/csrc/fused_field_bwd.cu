// Fused CDE vector field, backward (vector-Jacobian product), for Hopper
// (sm_90a), f32.
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
// A and dpre never reach device memory.
//
// Bound on the H100.  At the flagship training shape (B=512, H=HH=128,
// two trunk layers, I=21) the three products of each weight (forward
// recompute, weight grad, input grad) are 3 * 2 * 512 * (2*128*128 +
// 128*2688) = 1.16 GFLOP of f32 multiply-adds, 17.3 us at the 67 TFLOP/s
// f32 CUDA-core peak of the SXM part; the bytes it must move (inputs,
// weights, their grads) are about 4 MB, 1.2 us at 3.35 TB/s.  At I=1 (the
// rectilinear time slice) 0.15 GFLOP, 2.25 us.  Bound by operations.  (A
// reckoning from the data sheet, not a measurement.)
//
// Design.  The TPU kernel sums the weight grads over its batch tiles in
// place, because a TPU grid runs in order; here blocks run in parallel, so
// every sum over the batch is split into per-tile partials in scratch and
// summed in a fixed order by a later pass.  No atomics: two calls give the
// same bits.  Five launches behind one entry point, in stream order:
//
//   1. trunk_forward   recomputes u_1..u_n for 8 rows a block (scratch).
//   2. head_backward   one block per (32-row batch tile, 64-column strip of
//                      one channel's H columns): stages W_o's strip, u_n's
//                      tile and g in shared memory, recomputes the strip of
//                      A, forms dpre on chip, and writes
//                        - ddx's partial over the strip's h,
//                        - db_o's and dW_o's partial over the tile's rows,
//                        - du_n's partial over the strip's columns.
//   3. reduce_head     dW_o, db_o = sums of the tile partials.
//   4. trunk_backward  du_n = sum of the strip partials, ddx = sum of its
//                      partials, then the relu trunk back to dz (8 rows a
//                      block), keeping each dv_l (scratch).
//   5. trunk_wgrad     dW_l, db_l = u_{l-1}^T dv_l over the whole batch, one
//                      block per 32 x 32 output tile.
//
// Every product is a plain f32 FMA loop over shared-memory tiles, a few
// outputs a thread.  Tensor cores (3xTF32 wgmma), TMA staging and fewer,
// smaller partials are left for later work.  Scratch is allocated by the
// caller (oncde_fused_field_backward_scratch gives its size in floats);
// the kernel allocates nothing.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxTrunk = 4;
constexpr int kMaxDim = 256;    // largest H and HH taken
constexpr int kThreads = 256;
constexpr int kTile = 32;       // batch rows of one head block / weight-grad partial
constexpr int kStrip = 64;      // head columns of one head block, inside one channel
constexpr int kRowsT = 8;       // batch rows of one trunk block
constexpr int kWg = 32;         // trunk weight-grad output tile
constexpr int kChunkT = 16;     // trunk weight columns staged per step

struct Trunk {
  const float* w[kMaxTrunk];  // layer l: (d_in, hh) row-major, d_in = H for l = 0
  const float* b[kMaxTrunk];  // (hh,)
  int n;
};

struct TrunkGrad {
  float* w[kMaxTrunk];
  float* b[kMaxTrunk];
};

struct Layout {
  int tiles, hstrips, strips;
  size_t acts, dv, wpart, bpart, dupart, ddxpart, total;  // offsets / size, floats
};

// cp.async of one float into shared memory, zero-filled (src not read)
// when !valid: the staging loops issue every copy before any is waited on,
// instead of one device-memory round trip per element.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// sum_{t < n} p[t * stride], in order of t, with kUnroll loads in flight.
constexpr int kUnroll = 8;
__device__ __forceinline__ float ordered_sum(const float* __restrict__ p, size_t stride,
                                             int n) {
  float s = 0.f;
  int t = 0;
  for (; t + kUnroll <= n; t += kUnroll) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = p[(size_t)(t + u) * stride];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) s += v[u];
  }
  for (; t < n; ++t) s += p[(size_t)t * stride];
  return s;
}

size_t round4(size_t n) { return (n + 3) & ~static_cast<size_t>(3); }

Layout layout(int batch, int hidden, int hh, int n_in, int n_trunk) {
  Layout L;
  L.tiles = (batch + kTile - 1) / kTile;
  L.hstrips = (hidden + kStrip - 1) / kStrip;
  L.strips = n_in * L.hstrips;
  const size_t ih = (size_t)n_in * hidden;
  size_t off = 0;
  L.acts = off;    off += round4((size_t)n_trunk * batch * hh);
  L.dv = off;      off += round4((size_t)n_trunk * batch * hh);
  L.wpart = off;   off += round4((size_t)L.tiles * hh * ih);
  L.bpart = off;   off += round4((size_t)L.tiles * ih);
  L.dupart = off;  off += round4((size_t)L.strips * batch * hh);
  L.ddxpart = off; off += round4((size_t)L.hstrips * batch * n_in);
  L.total = off;
  return L;
}

size_t head_smem_bytes(int hh) {
  const size_t floats = (size_t)hh * (kStrip + 1) + (size_t)kTile * (hh + 1) + 8 +
                        2 * (size_t)kTile * kStrip + kTile + kStrip;
  return floats * sizeof(float);
}

// 1. u_l for every layer, kRowsT rows a block: acts[l][b][j].  Each
// layer's weight streams through shared memory kChunkF rows at a time.
constexpr int kChunkF = 16;
__global__ void __launch_bounds__(kThreads)
trunk_forward(const float* __restrict__ z, Trunk trunk, float* __restrict__ acts,
              int batch, int hidden, int hh) {
  __shared__ float xs[2][kRowsT][kMaxDim];
  __shared__ float wc[kChunkF][kMaxDim];
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRowsT;
  const int rows = min(kRowsT, batch - row0);
  for (int e = tid; e < kRowsT * hidden; e += kThreads) {
    const int r = e / hidden, k = e - r * hidden;
    cp_async4(&xs[0][r][k], z + (size_t)(row0 + r) * hidden + k, r < rows);
  }
  cp_async_wait_all();
  __syncthreads();
  // Thread: columns j = tid % 128 (+ 128 q), rows r0..r0+3.
  const int r0 = (tid / 128) * 4;
  int cur = 0, d_in = hidden;
  for (int l = 0; l < trunk.n; ++l) {
    const float* __restrict__ w = trunk.w[l];
    const float* __restrict__ b = trunk.b[l];
    float acc[kMaxDim / 128][4] = {};
    for (int k0 = 0; k0 < d_in; k0 += kChunkF) {
      const int kn = min(kChunkF, d_in - k0);
      for (int e = tid; e < kChunkF * hh; e += kThreads) {
        const int kk = e / hh, j = e - kk * hh;
        cp_async4(&wc[kk][j], w + (size_t)(k0 + kk) * hh + j, kk < kn);
      }
      cp_async_wait_all();
      __syncthreads();
      for (int kk = 0; kk < kn; ++kk) {
        float x[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) x[m] = xs[cur][r0 + m][k0 + kk];
#pragma unroll
        for (int q = 0; q < kMaxDim / 128; ++q) {
          const int j = tid % 128 + 128 * q;
          if (j < hh) {
            const float wv = wc[kk][j];
#pragma unroll
            for (int m = 0; m < 4; ++m) acc[q][m] = fmaf(x[m], wv, acc[q][m]);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int q = 0; q < kMaxDim / 128; ++q) {
      const int j = tid % 128 + 128 * q;
      if (j < hh) {
        const float bj = b[j];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float v = fmaxf(acc[q][m] + bj, 0.f);
          xs[cur ^ 1][r0 + m][j] = v;
          if (r0 + m < rows) acts[((size_t)l * batch + row0 + r0 + m) * hh + j] = v;
        }
      }
    }
    __syncthreads();
    cur ^= 1;
    d_in = hh;
  }
}

// 2. One (batch tile, column strip) of the head's backward.
__global__ void __launch_bounds__(kThreads)
head_backward(const float* __restrict__ dx, const float* __restrict__ g,
              const float* __restrict__ u_last, const float* __restrict__ head_w,
              const float* __restrict__ head_b, float* __restrict__ wpart,
              float* __restrict__ bpart, float* __restrict__ dupart,
              float* __restrict__ ddxpart, int batch, int hidden, int hh,
              int n_in, int hstrips) {
  extern __shared__ __align__(16) float smem[];
  constexpr int ldw = kStrip + 1;  // odd: column reads across lanes hit distinct banks
  const int ldu = hh + 1;
  float* ws = smem;                       // [hh][ldw]   W_o strip
  float* us = ws + hh * ldw;              // [kTile][ldu] u_n tile (+8 floats of slack)
  float* gs = us + kTile * ldu + 8;       // [kTile][kStrip]
  float* ds = gs + kTile * kStrip;        // [kTile][kStrip] dpre
  float* dxs = ds + kTile * kStrip;       // [kTile]
  float* bs = dxs + kTile;                // [kStrip]

  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int strip = blockIdx.y;           // i * hstrips + hs
  const int i = strip / hstrips, hs = strip - i * hstrips;
  const int h0 = hs * kStrip;
  const int ncols = min(kStrip, hidden - h0);
  const int row0 = tile * kTile;
  const int rows = min(kTile, batch - row0);
  const size_t ih = (size_t)n_in * hidden;
  const size_t col0 = (size_t)i * hidden + h0;

  for (int e = tid; e < hh * kStrip; e += kThreads) {
    const int k = e / kStrip, c = e - k * kStrip;
    cp_async4(ws + k * ldw + c, head_w + (size_t)k * ih + col0 + c, c < ncols);
  }
  for (int e = tid; e < kTile * hh; e += kThreads) {
    const int r = e / hh, k = e - r * hh;
    cp_async4(us + r * ldu + k, u_last + (size_t)(row0 + r) * hh + k, r < rows);
  }
  if (tid < 8) us[kTile * ldu + tid] = 0.f;
  for (int e = tid; e < kTile * kStrip; e += kThreads) {
    const int r = e / kStrip, c = e - r * kStrip;
    cp_async4(gs + e, g + (size_t)(row0 + r) * hidden + h0 + c, r < rows && c < ncols);
  }
  if (tid < kTile) cp_async4(dxs + tid, dx + (size_t)(row0 + tid) * n_in + i, tid < rows);
  if (tid < kStrip) cp_async4(bs + tid, head_b + col0 + tid, tid < ncols);
  cp_async_wait_all();
  __syncthreads();

  const int tx = tid % 16, ty = tid / 16;
  // Recompute the strip of A (rows 2ty, 2ty+1; columns tx + 16q), then
  // ddx's partial and dpre.  Padded rows and columns give dpre = 0.
  {
    float acc[2][4] = {};
    const float* u0 = us + (2 * ty) * ldu;
    const float* u1 = u0 + ldu;
    for (int k = 0; k < hh; ++k) {
      const float a0 = u0[k], a1 = u1[k];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float wv = ws[k * ldw + tx + 16 * q];
        acc[0][q] = fmaf(a0, wv, acc[0][q]);
        acc[1][q] = fmaf(a1, wv, acc[1][q]);
      }
    }
    float part[2] = {0.f, 0.f};
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = 2 * ty + rr;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = tx + 16 * q;
        const float a = tanhf(acc[rr][q] + bs[c]);
        const float gv = gs[r * kStrip + c];
        part[rr] = fmaf(a, gv, part[rr]);
        ds[r * kStrip + c] = dxs[r] * gv * (1.f - a * a);
      }
    }
    // Sum over the 16 lanes (tx) of this half-warp, which share the rows.
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      part[0] += __shfl_xor_sync(0xffffffffu, part[0], off);
      part[1] += __shfl_xor_sync(0xffffffffu, part[1], off);
    }
    if (tx == 0) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = 2 * ty + rr;
        if (r < rows) ddxpart[((size_t)hs * batch + row0 + r) * n_in + i] = part[rr];
      }
    }
  }
  __syncthreads();

  // db_o's partial over the tile's rows.
  if (tid < ncols) {
    float s = 0.f;
    for (int r = 0; r < kTile; ++r) s += ds[r * kStrip + tid];
    bpart[(size_t)tile * ih + col0 + tid] = s;
  }

  // dW_o's partial: rows k = kb..kb+7, columns tx + 16q, summed over the tile.
  for (int kb = ty * 8; kb < hh; kb += 128) {
    float acc[8][4] = {};
    for (int r = 0; r < kTile; ++r) {
      float d[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) d[q] = ds[r * kStrip + tx + 16 * q];
      const float* ur = us + r * ldu + kb;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float uv = ur[j];
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][q] = fmaf(uv, d[q], acc[j][q]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = kb + j;
      if (k < hh) {
        float* dst = wpart + ((size_t)tile * hh + k) * ih + col0;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (tx + 16 * q < ncols) dst[tx + 16 * q] = acc[j][q];
      }
    }
  }

  // du_n's partial over the strip's columns: rows 4w..4w+3, k = lane + 32j.
  const int lane = tid % 32, warp = tid / 32;
  for (int kb = 0; kb < hh; kb += 128) {
    float acc[4][4] = {};
    for (int c = 0; c < ncols; ++c) {
      float d[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) d[m] = ds[(warp * 4 + m) * kStrip + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = kb + lane + 32 * j;
        const float wv = k < hh ? ws[k * ldw + c] : 0.f;
#pragma unroll
        for (int m = 0; m < 4; ++m) acc[m][j] = fmaf(d[m], wv, acc[m][j]);
      }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int r = warp * 4 + m;
      if (r < rows) {
        float* dst = dupart + ((size_t)strip * batch + row0 + r) * hh;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = kb + lane + 32 * j;
          if (k < hh) dst[k] = acc[m][j];
        }
      }
    }
  }
}

// 3. dW_o and db_o: the tile partials summed in tile order.
__global__ void __launch_bounds__(kThreads)
reduce_head(const float* __restrict__ wpart, const float* __restrict__ bpart,
            float* __restrict__ dhw, float* __restrict__ dhb, int tiles,
            size_t n_w, size_t n_b) {
  const size_t stride = (size_t)gridDim.x * kThreads;
  for (size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x; e < n_w + n_b; e += stride) {
    if (e < n_w)
      dhw[e] = ordered_sum(wpart + e, n_w, tiles);
    else
      dhb[e - n_w] = ordered_sum(bpart + (e - n_w), n_b, tiles);
  }
}

// 4. du_n and ddx from their partials, then back through the relu trunk
// to dz, kRowsT rows a block; keeps dv_l for the weight grads.
__global__ void __launch_bounds__(kThreads)
trunk_backward(const float* __restrict__ dupart, const float* __restrict__ ddxpart,
               const float* __restrict__ acts, Trunk trunk, float* __restrict__ dv,
               float* __restrict__ dz, float* __restrict__ ddx, int batch,
               int hidden, int hh, int n_in, int strips, int hstrips) {
  __shared__ float du[kRowsT][kMaxDim];
  __shared__ float dvs[kRowsT][kMaxDim];
  __shared__ float wt[kMaxDim * (kChunkT + 1)];
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRowsT;
  const int rows = min(kRowsT, batch - row0);

  for (int e = tid; e < kRowsT * hh; e += kThreads) {
    const int r = e / hh, k = e - r * hh;
    du[r][k] = r < rows ? ordered_sum(dupart + (size_t)(row0 + r) * hh + k,
                                      (size_t)batch * hh, strips)
                        : 0.f;
  }
  for (int e = tid; e < kRowsT * n_in; e += kThreads) {
    const int r = e / n_in, i = e - r * n_in;
    if (r < rows)
      ddx[(size_t)(row0 + r) * n_in + i] = ordered_sum(
          ddxpart + (size_t)(row0 + r) * n_in + i, (size_t)batch * n_in, hstrips);
  }
  __syncthreads();

  const int lane = tid % 32, r = tid / 32;  // one row per warp
  for (int l = trunk.n - 1; l >= 0; --l) {
    const int d_in = l == 0 ? hidden : hh;
    const float* __restrict__ act = acts + (size_t)l * batch * hh;
    const float* __restrict__ w = trunk.w[l];
    for (int e = tid; e < kRowsT * hh; e += kThreads) {
      const int rr = e / hh, j = e - rr * hh;
      const bool live = rr < rows && act[(size_t)(row0 + rr) * hh + j] > 0.f;
      const float v = live ? du[rr][j] : 0.f;
      dvs[rr][j] = v;
      if (rr < rows) dv[((size_t)l * batch + row0 + rr) * hh + j] = v;
    }
    __syncthreads();
    // du_{l-1}[r][k] = sum_j dv[r][j] W_l[k][j], W_l staged kChunkT columns at a time.
    float acc[kMaxDim / 32] = {};
    for (int j0 = 0; j0 < hh; j0 += kChunkT) {
      const int jn = min(kChunkT, hh - j0);
      for (int e = tid; e < d_in * kChunkT; e += kThreads) {
        const int k = e / kChunkT, jj = e - k * kChunkT;
        cp_async4(wt + k * (kChunkT + 1) + jj, w + (size_t)k * hh + j0 + jj, jj < jn);
      }
      cp_async_wait_all();
      __syncthreads();
      for (int jj = 0; jj < jn; ++jj) {
        const float dvv = dvs[r][j0 + jj];
#pragma unroll
        for (int q = 0; q < kMaxDim / 32; ++q) {
          const int k = lane + 32 * q;
          if (k < d_in) acc[q] = fmaf(dvv, wt[k * (kChunkT + 1) + jj], acc[q]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int q = 0; q < kMaxDim / 32; ++q) {
      const int k = lane + 32 * q;
      if (k < d_in) du[r][k] = acc[q];
    }
    __syncthreads();
  }
  for (int e = tid; e < kRowsT * hidden; e += kThreads) {
    const int rr = e / hidden, k = e - rr * hidden;
    if (rr < rows) dz[(size_t)(row0 + rr) * hidden + k] = du[rr][k];
  }
}

// 5. dW_l = u_{l-1}^T dv_l and db_l = sum_b dv_l over the whole batch, in
// batch order: one 32 x 32 output tile a block, blockIdx.z = layer; the
// batch streams through shared memory kWgRows rows at a time.
constexpr int kWgRows = 64;
__global__ void __launch_bounds__(kThreads)
trunk_wgrad(const float* __restrict__ z, const float* __restrict__ acts,
            const float* __restrict__ dv, TrunkGrad grad, int batch, int hidden,
            int hh) {
  __shared__ float ins[kWgRows][kWg + 1];
  __shared__ float dvt[kWgRows][kWg + 1];
  const int l = blockIdx.z;
  const int d_in = l == 0 ? hidden : hh;
  const int k0 = blockIdx.y * kWg, j0 = blockIdx.x * kWg;
  if (k0 >= d_in) return;  // uniform over the block
  const float* __restrict__ in = l == 0 ? z : acts + (size_t)(l - 1) * batch * hh;
  const float* __restrict__ d = dv + (size_t)l * batch * hh;
  const int tid = threadIdx.x;
  const int tx = tid % kWg, ty = tid / kWg;  // column j0 + tx; rows k0 + 4ty .. +3
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float bacc = 0.f;
  for (int b0 = 0; b0 < batch; b0 += kWgRows) {
    for (int e = tid; e < kWgRows * kWg; e += kThreads) {
      const int bb = e / kWg, c = e - bb * kWg;
      const bool row = b0 + bb < batch;
      cp_async4(&ins[bb][c], in + (size_t)(b0 + bb) * d_in + k0 + c, row && k0 + c < d_in);
      cp_async4(&dvt[bb][c], d + (size_t)(b0 + bb) * hh + j0 + c, row && j0 + c < hh);
    }
    cp_async_wait_all();
    __syncthreads();
    for (int bb = 0; bb < kWgRows; ++bb) {
      const float dvv = dvt[bb][tx];
#pragma unroll
      for (int m = 0; m < 4; ++m) acc[m] = fmaf(ins[bb][4 * ty + m], dvv, acc[m]);
      bacc += dvv;
    }
    __syncthreads();
  }
  const int j = j0 + tx;
  if (j < hh) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int k = k0 + 4 * ty + m;
      if (k < d_in) grad.w[l][(size_t)k * hh + j] = acc[m];
    }
    if (blockIdx.y == 0 && ty == 0) grad.b[l][j] = bacc;
  }
}

bool valid(int batch, int hidden, int hh, int n_in, int n_trunk) {
  return n_trunk >= 1 && n_trunk <= kMaxTrunk && batch >= 1 && hidden >= 1 &&
         hidden <= kMaxDim && hh >= 1 && hh <= kMaxDim && n_in >= 1 &&
         (long long)n_in * ((hidden + kStrip - 1) / kStrip) <= 65535;
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

// Launches on `stream`; returns the first cudaGetLastError() that is not 0
// (0 on success).  trunk_w / trunk_b / dtrunk_w / dtrunk_b are host arrays
// of n_trunk device pointers; scratch holds scratch_floats floats.
int oncde_fused_field_backward(const float* z, const float* dx, const float* g,
                               const float* const* trunk_w,
                               const float* const* trunk_b, int n_trunk,
                               const float* head_w, const float* head_b, float* dz,
                               float* ddx, float* const* dtrunk_w,
                               float* const* dtrunk_b, float* dhead_w,
                               float* dhead_b, float* scratch,
                               long long scratch_floats, int batch, int hidden,
                               int hh, int n_in, void* stream) {
  if (!valid(batch, hidden, hh, n_in, n_trunk)) return (int)cudaErrorInvalidValue;
  const Layout L = layout(batch, hidden, hh, n_in, n_trunk);
  if (scratch_floats < (long long)L.total) return (int)cudaErrorInvalidValue;
  Trunk trunk;
  TrunkGrad grad;
  for (int l = 0; l < kMaxTrunk; ++l) {
    trunk.w[l] = l < n_trunk ? trunk_w[l] : nullptr;
    trunk.b[l] = l < n_trunk ? trunk_b[l] : nullptr;
    grad.w[l] = l < n_trunk ? dtrunk_w[l] : nullptr;
    grad.b[l] = l < n_trunk ? dtrunk_b[l] : nullptr;
  }
  trunk.n = n_trunk;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* acts = scratch + L.acts;
  float* dv = scratch + L.dv;
  float* wpart = scratch + L.wpart;
  float* bpart = scratch + L.bpart;
  float* dupart = scratch + L.dupart;
  float* ddxpart = scratch + L.ddxpart;
  const int row_blocks = (batch + kRowsT - 1) / kRowsT;
  cudaError_t err;

  trunk_forward<<<row_blocks, kThreads, 0, s>>>(z, trunk, acts, batch, hidden, hh);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const size_t smem = head_smem_bytes(hh);
  static size_t smem_set = 48 * 1024;  // the default dynamic limit
  if (smem > smem_set) {
    err = cudaFuncSetAttribute(head_backward, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  head_backward<<<dim3(L.tiles, L.strips), kThreads, smem, s>>>(
      dx, g, acts + (size_t)(n_trunk - 1) * batch * hh, head_w, head_b, wpart, bpart,
      dupart, ddxpart, batch, hidden, hh, n_in, L.hstrips);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const size_t n_w = (size_t)hh * n_in * hidden, n_b = (size_t)n_in * hidden;
  const size_t red_blocks = (n_w + n_b + kThreads - 1) / kThreads;
  reduce_head<<<(unsigned)(red_blocks < 4096 ? red_blocks : 4096), kThreads, 0, s>>>(
      wpart, bpart, dhead_w, dhead_b, L.tiles, n_w, n_b);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  trunk_backward<<<row_blocks, kThreads, 0, s>>>(dupart, ddxpart, acts, trunk, dv, dz,
                                                  ddx, batch, hidden, hh, n_in,
                                                  L.strips, L.hstrips);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int dmax = hidden > hh ? hidden : hh;
  const dim3 wg_grid((hh + kWg - 1) / kWg, (dmax + kWg - 1) / kWg, n_trunk);
  trunk_wgrad<<<wg_grid, kThreads, 0, s>>>(z, acts, dv, grad, batch, hidden, hh);
  return (int)cudaGetLastError();
}

const char* oncde_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
