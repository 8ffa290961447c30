// K1: windowed edge-weighted max aggregation for the text GCN, forward.
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
