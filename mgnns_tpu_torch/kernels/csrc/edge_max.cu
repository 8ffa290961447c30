// K1 and K2: windowed edge-weighted max aggregation for the text GCN, its
// forward (K1, below) and its backward (K2, further down).
//
//   out[b, j, :] = max_{o in [-g, g], 0 <= j+o < len_b} emb[b, j+o, :] * w[b, j, g+o]
//   for j < len_b; rows j >= len_b are -inf.
//
// Replaces the Pallas TPU kernel mgnns_tpu/kernels/edge_max.py:_kernel.  That
// kernel keeps one document's [L, D] tile in VMEM and realises the window
// shift as a circular pltpu.roll killed by a validity mask.  Here each thread
// reads the shifted row j+o directly and skips the invalid ones, so no mask is
// materialised and padded rows read nothing.
//
// Bound: bytes.  Each element of emb is read and each element of out written
// about once (the 2g+1 re-reads of a source row hit L1/L2), plus the [B, L, W]
// weights: at B=16, L=100, D=300, g=4 about 3.9 MB, ~1.2 us of HBM time on an
// H100, against ~9 MFLOP of multiply+max.  At that size a launch costs more
// than the traffic, so this simple layout is launch-bound; making it faster
// is later work.
//
// Layout: grid (B, ceil(L / kRows)); a block of (kLanes, kRows) threads holds
// kRows destination rows, lanes stride over D in float4 vectors when D % 4 == 0
// (D = 300 is 75 vectors).  The row's 2g+1 weights are staged in shared memory
// once per block.  Max follows jnp.maximum / torch.maximum: a NaN operand
// wins (fmaxf would drop it).

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;
constexpr int kRows = 4;
constexpr int kMaxWindow = 33;  // ngram <= 16

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ void fill_neg_inf(float& v) { v = neg_inf(); }
__device__ __forceinline__ void fill_neg_inf(float4& v) {
  v.x = v.y = v.z = v.w = neg_inf();
}

__device__ __forceinline__ void max_msg(float& acc, float s, float wk) {
  acc = nan_max(acc, __fmul_rn(s, wk));
}
__device__ __forceinline__ void max_msg(float4& acc, float4 s, float wk) {
  max_msg(acc.x, s.x, wk);
  max_msg(acc.y, s.y, wk);
  max_msg(acc.z, s.z, wk);
  max_msg(acc.w, s.w, wk);
}

template <typename T>
__global__ void __launch_bounds__(kLanes * kRows)
edge_max_fwd_kernel(const float* __restrict__ emb, const float* __restrict__ w,
                    const int* __restrict__ lens, float* __restrict__ out,
                    int L, int D, int ngram) {
  constexpr int kVec = sizeof(T) / sizeof(float);
  __shared__ float w_s[kRows][kMaxWindow];

  const int b = blockIdx.x;
  const int j = blockIdx.y * kRows + threadIdx.y;
  const int W = 2 * ngram + 1;
  const bool row_in_range = j < L;
  // lens beyond L would read past the document; the padded buffer holds L rows
  const int len = min(lens[b], L);

  if (row_in_range) {
    for (int k = threadIdx.x; k < W; k += kLanes) {
      w_s[threadIdx.y][k] = w[((size_t)b * L + j) * W + k];
    }
  }
  __syncthreads();
  if (!row_in_range) return;

  const int nvec = D / kVec;
  const T* src = reinterpret_cast<const T*>(emb + (size_t)b * L * D);
  T* dst = reinterpret_cast<T*>(out + ((size_t)b * L + j) * D);
  const float* wr = w_s[threadIdx.y];

  for (int v = threadIdx.x; v < nvec; v += kLanes) {
    T acc;
    fill_neg_inf(acc);
    // slot k reads source row s = j + k - g; invalid slots are skipped, which
    // equals the Pallas kernel's -inf fill.  (Looping o over a precomputed
    // [lo, hi] range instead was miscompiled by ptxas -O3 of CUDA 12.9: the
    // loop ran to +g whatever hi held.)
    for (int k = 0; k < W; ++k) {
      const int s = j + k - ngram;
      if (s >= 0 && s < len && j < len) max_msg(acc, src[(size_t)s * nvec + v], wr[k]);
    }
    dst[v] = acc;
  }
}

// ---------------------------------------------------------------------------
// K2: the backward of K1.
//
// Replaces the Pallas TPU kernel mgnns_tpu/kernels/edge_max.py:_bwd_kernel
// (entered through _backward and the custom-VJP rule _bwd).  Per (b, j, d) it
// recomputes K1's max chain acc_0 = -inf, acc_{k+1} = max(acc_k, msg_k), then
// walks it backwards with jnp.maximum's VJP, k from W-1 down to 0:
//
//   d_msg_k = g_acc * [msg_k == acc_{k+1}] / (1 + [acc_k == acc_{k+1}])
//   g_acc   = g_acc * [acc_k == acc_{k+1}] / (1 + [msg_k == acc_{k+1}])
//
// (a strict winner takes the gradient, an exact tie splits it 0.5/0.5, the
// -inf initial value absorbs nothing, a NaN message gets nothing because ==
// is false), and only valid slots keep their d_msg.  Then
//
//   d_emb[b, s, :] = sum_{k = W-1 .. 0} d_msg[b, s-o_k, k, :] * w[b, s-o_k, k]
//   d_w[b, j, k]   = sum_d d_msg[b, j, k, d] * emb[b, j+o_k, d]
//
// over valid (row, slot) pairs; invalid slots of d_w are 0.
//
// Layout: grid (B, ceil(L / kBwdRows)); a block owns kBwdRows rows, both as
// source rows (d_emb) and as destination rows (d_w), and walks D in chunks of
// blockDim.x lanes (one float each).  A source row's d_emb needs the chains of
// the destination rows up to g away, so the block recomputes the chains of
// its rows plus a halo of g rows each side and keeps their d_msg in shared
// memory ([kBwdRows + 2g][2g+1][lanes] floats, 55 KB at g=4 and 128 lanes).
// Every output element is written by exactly one thread, so there are no
// atomics: d_emb adds its terms in the plain backward's order (k descending,
// __fmul_rn/__fadd_rn so nvcc contracts nothing into an FMA) and equals it
// bit for bit.  d_w reduces over D per lane, then across lanes by warp
// shuffles and across warps in a fixed order: deterministic, but in another
// order than the plain version's sum.
//
// Bound: bytes.  It reads emb, g and w and writes d_emb and d_w, about
// 4*B*L*D*4 + 2*B*L*W*4 bytes (7.8 MB at B=16, L=100, D=300, g=4, ~2.3 us of
// HBM time on an H100), against ~50 MFLOP of compare, multiply and add.  This
// first version re-reads the halo rows' emb from L1/L2 and recomputes each
// chain (kBwdRows + 2g) / kBwdRows times; staging with TMA and float4 lanes
// are later work.

constexpr int kBwdRows = 4;
constexpr int kBwdMaxLanes = 128;
constexpr size_t kMaxDynamicSmem = 232448;  // 227 KB a block may opt into

__global__ void __launch_bounds__(kBwdMaxLanes)
edge_max_bwd_kernel(const float* __restrict__ emb, const float* __restrict__ w,
                    const float* __restrict__ g, const int* __restrict__ lens,
                    float* __restrict__ d_emb, float* __restrict__ d_w,
                    int L, int D, int ngram) {
  extern __shared__ float smem[];
  const int W = 2 * ngram + 1;
  const int H = kBwdRows + 2 * ngram;   // owned rows plus the halo
  const int C = blockDim.x;             // lanes: the D chunk width
  float* w_s = smem;                    // [H][W]
  float* dm_s = smem + H * W;           // [H][W][C] d_msg of the span

  const int b = blockIdx.x;
  const int j0 = blockIdx.y * kBwdRows;
  const int h0 = j0 - ngram;            // row of halo slot 0
  const int tid = threadIdx.x;
  const int len = min(lens[b], L);
  const float* eb = emb + (size_t)b * L * D;
  const float* gb = g + (size_t)b * L * D;

  for (int i = tid; i < H * W; i += C) {
    const int j = h0 + i / W;
    w_s[i] = (j >= 0 && j < L) ? w[((size_t)b * L + j) * W + i % W] : 0.f;
  }
  float dw_part[kBwdRows][kMaxWindow];
  for (int r = 0; r < kBwdRows; ++r)
    for (int k = 0; k < W; ++k) dw_part[r][k] = 0.f;
  __syncthreads();

  for (int c0 = 0; c0 < D; c0 += C) {
    const int d = c0 + tid;
    const bool lane_ok = d < D;
    // 1. the chain of every row of the span, walked backwards into d_msg
    for (int hj = 0; hj < H; ++hj) {
      const int j = h0 + hj;
      float* dm = dm_s + (size_t)hj * W * C + tid;   // slot k at dm[k * C]
      const float* wr = w_s + hj * W;
      if (lane_ok && j >= 0 && j < len) {
        float acc[kMaxWindow + 1];
        acc[0] = neg_inf();
        for (int k = 0; k < W; ++k) {
          const int s = j + k - ngram;
          const float msg = (s >= 0 && s < len) ? __fmul_rn(eb[(size_t)s * D + d], wr[k])
                                                : neg_inf();
          dm[k * C] = msg;
          acc[k + 1] = nan_max(acc[k], msg);
        }
        float g_acc = gb[(size_t)j * D + d];
        for (int k = W - 1; k >= 0; --k) {
          const float out = acc[k + 1];
          const float msg_hit = dm[k * C] == out ? 1.f : 0.f;
          const float prev_hit = acc[k] == out ? 1.f : 0.f;
          const float d_msg = __fdiv_rn(__fmul_rn(g_acc, msg_hit), __fadd_rn(1.f, prev_hit));
          g_acc = __fdiv_rn(__fmul_rn(g_acc, prev_hit), __fadd_rn(1.f, msg_hit));
          const int s = j + k - ngram;
          dm[k * C] = (s >= 0 && s < len) ? d_msg : 0.f;
        }
      } else {
        for (int k = 0; k < W; ++k) dm[k * C] = 0.f;
      }
    }
    __syncthreads();
    // 2. each owned row as a source (d_emb) and as a destination (d_w partials)
    if (lane_ok) {
      for (int r = 0; r < kBwdRows && j0 + r < L; ++r) {
        const int s = j0 + r;
        float acc = 0.f;
        for (int k = W - 1; k >= 0; --k) {
          const int j = s - k + ngram;        // the row whose slot k reads row s
          const int hj = r + 2 * ngram - k;
          if (j >= 0 && j < len && s < len) {
            acc = __fadd_rn(acc, __fmul_rn(dm_s[((size_t)hj * W + k) * C + tid], w_s[hj * W + k]));
          }
        }
        d_emb[((size_t)b * L + s) * D + d] = acc;
        if (s < len) {
          const int hj = r + ngram;
          for (int k = 0; k < W; ++k) {
            const int src = s + k - ngram;
            if (src >= 0 && src < len) {
              dw_part[r][k] += dm_s[((size_t)hj * W + k) * C + tid] * eb[(size_t)src * D + d];
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // 3. d_w: lanes by warp shuffles, then warps in order (dm_s is free now)
  const int nwarps = C / 32;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* red = dm_s;                    // [kBwdRows * W][nwarps]
  for (int r = 0; r < kBwdRows; ++r) {
    for (int k = 0; k < W; ++k) {
      float v = dw_part[r][k];
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) red[(r * W + k) * nwarps + warp] = v;
    }
  }
  __syncthreads();
  for (int i = tid; i < kBwdRows * W; i += C) {
    const int j = j0 + i / W;
    const int s = j + i % W - ngram;
    if (j >= L) continue;
    float v = 0.f;
    for (int q = 0; q < nwarps; ++q) v += red[i * nwarps + q];
    d_w[((size_t)b * L + j) * W + i % W] = (j < len && s >= 0 && s < len) ? v : 0.f;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).  The
// caller checks shapes, types, contiguity and, for vec == 4, that D % 4 == 0
// and both pointers are 16-byte aligned.
extern "C" int mgnns_edge_max_forward(const float* emb, const float* w,
                                      const int* lens, float* out, int B, int L,
                                      int D, int ngram, int vec, int device,
                                      cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ngram < 0 || 2 * ngram + 1 > kMaxWindow) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid(B, (L + kRows - 1) / kRows);
  dim3 block(kLanes, kRows);
  if (vec == 4) {
    edge_max_fwd_kernel<float4><<<grid, block, 0, stream>>>(emb, w, lens, out, L, D, ngram);
  } else {
    edge_max_fwd_kernel<float><<<grid, block, 0, stream>>>(emb, w, lens, out, L, D, ngram);
  }
  return static_cast<int>(cudaGetLastError());
}

// K2.  Launches on `stream` and returns the first CUDA error (0 = launched).
// The caller checks shapes, types and contiguity and passes B, L >= 1.
extern "C" int mgnns_edge_max_backward(const float* emb, const float* w,
                                       const float* g, const int* lens,
                                       float* d_emb, float* d_w, int B, int L,
                                       int D, int ngram, int device,
                                       cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ngram < 0 || 2 * ngram + 1 > kMaxWindow) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int W = 2 * ngram + 1;
  const size_t span = (size_t)(kBwdRows + 2 * ngram) * W;
  // the widest chunk whose d_msg span fits in shared memory, no wider than D
  int lanes = kBwdMaxLanes;
  while (lanes > 32 && (span * (lanes + 1) * sizeof(float) > kMaxDynamicSmem ||
                        lanes / 2 >= D)) {
    lanes /= 2;
  }
  const size_t bytes = span * (lanes + 1) * sizeof(float);
  err = cudaFuncSetAttribute(edge_max_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B, (L + kBwdRows - 1) / kBwdRows);
  edge_max_bwd_kernel<<<grid, lanes, bytes, stream>>>(emb, w, g, lens, d_emb, d_w, L, D, ngram);
  return static_cast<int>(cudaGetLastError());
}
