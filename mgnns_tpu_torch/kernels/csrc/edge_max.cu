// K1 and K2: windowed edge-weighted max aggregation for the text GCN, its
// forward (K1, below) and its backward (K2, further down).
//
//   out[b, j, :] = max_{o in [-g, g], 0 <= j+o < len_b} emb[b, j+o, :] * w[b, j, g+o]
//   for j < len_b; rows j >= len_b are -inf.
//
// K1 replaces the Pallas TPU kernel mgnns_tpu/kernels/edge_max.py:_kernel
// (entered through _forward).  That kernel keeps one document's [L, D] tile in
// VMEM and realises the window shift as a circular pltpu.roll killed by a
// validity mask.
//
// Bound: bytes.  K1 must read the valid rows of emb and w once and write every
// row of out once: at B=16, L=100, D=300, g=4 with lens drawn in [0, 100]
// about 2.7 MB, 0.81 us of HBM time on an H100, against a few MFLOP of
// multiply and max.  At that size the grid is one wave of small blocks, so
// what a launch costs is the latency from its start to its last store, and
// the design shortens that chain:
//
// - Grid (B, ceil(L / kFwdRows), column tiles); a block owns kFwdRows
//   destination rows j0 .. j0+kFwdRows-1 of one document and a tile of
//   columns (one tile whenever the kFwdRows + 2g source rows of D floats fit
//   the stage: D = 300 up to g = 11).
// - A block whose rows all lie at or past len_b (about half of them at the
//   model's lengths) reads lens[b] only and writes -inf with 16-byte stores.
// - Otherwise one thread stages the source rows [max(0, j0-g),
//   min(len_b, j0+kFwdRows+g)) in shared memory with Hopper's bulk copy
//   (cp.async.bulk, completion counted in bytes on an mbarrier): one copy
//   when the block spans D, where the rows are contiguous in emb and in the
//   stage, else one a row.  Rows at or past len_b are never copied or read.
//   While the copy flies, each thread loads its row's 2g+1 weights into
//   registers, so the only memory round trips before the arithmetic are
//   lens[b] and, side by side, the copy and the weights.  Each source row
//   comes from memory once for the block and is read 2g+1 times from shared
//   memory.
// - One thread per (row, float4 column) item, as many threads as fill the
//   block's items in the fewest rounds of at most kFwdMaxThreads.  The
//   window is a template parameter (g = 0 .. 16 behind one switch), so the
//   slot loop unrolls: an item issues its 2g+1 shared-memory reads at once,
//   runs the max chain in registers and writes one float4, coalesced.  Rows
//   whose whole window is valid (j - g >= 0, j + g < len_b) run it without
//   the per-slot tests.
// - When D % 4 != 0 or a pointer is not 16-byte aligned the bulk copy is not
//   allowed: the same body stages with a cooperative copy of floats and
//   computes one float an item.
//
// The chain is the plain version's: acc = -inf, k ascending, one __fmul_rn
// product and a max each, invalid slots skipped (equal to its -inf fill).  Max
// follows jnp.maximum / torch.maximum: a NaN operand wins (fmaxf would drop
// it).  So K1 equals the plain version bit for bit, NaN and the sign of a zero
// result included (tests/test_torch_cuda.py).
// Shared memory is static (at most kFwdStageFloats floats of staged rows), so
// a launch sets no attribute.  No atomics.  On an H100 at B=16, L=100, D=300,
// g=4 it takes ~2.9 us a launch, against the 0.81 us bound and ~1.3 us for a
// kernel that only writes out (times and the rows sweep in PERF.md).

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

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

constexpr int kFwdRows = 4;             // rows a block owns, the fastest of 4, 8, 16 (PERF.md)
constexpr int kFwdMaxThreads = 512;
constexpr int kFwdStageFloats = 8192;   // 32 KB of staged source rows

// Floats of one staged row: the widest column tile, a multiple of 4, whose
// kFwdRows + 2g rows fit the stage.
__host__ __device__ constexpr int fwd_tile_cap(int ngram) {
  return kFwdStageFloats / (kFwdRows + 2 * ngram) / 4 * 4;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Hopper's bulk copy from global to shared memory, counted on `bar` in bytes:
// both addresses 16-byte aligned, `bytes` a multiple of 16.
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src, uint32_t bytes,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Spins until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// kBulk: float4 items, rows staged by bulk copy; else floats, staged by a
// cooperative copy.  dt is the column tile's width, D when one tile spans D,
// else a multiple of 4 (the last tile may be narrower).
template <int NGRAM, bool kBulk>
__global__ void __launch_bounds__(kFwdMaxThreads)
edge_max_fwd_kernel(const float* __restrict__ emb, const float* __restrict__ w,
                    const int* __restrict__ lens, float* __restrict__ out,
                    int L, int D, int dt) {
  using T = typename std::conditional<kBulk, float4, float>::type;
  constexpr int kVec = sizeof(T) / sizeof(float);
  constexpr int W = 2 * NGRAM + 1;
  // stage row h holds columns [c0, c0 + ct) of source row j0 - NGRAM + h, at stride dt
  __shared__ __align__(128) float stage[(kFwdRows + 2 * NGRAM) * fwd_tile_cap(NGRAM)];
  __shared__ uint64_t bar;

  const int b = blockIdx.x;
  const int j0 = blockIdx.y * kFwdRows;
  const int rows = min(kFwdRows, L - j0);
  const int c0 = blockIdx.z * dt;
  const int nv = min(dt, D - c0) / kVec;  // items a row
  const int tid = threadIdx.x;
  // lens beyond L would read past the document; the padded buffer holds L rows
  const int len = min(lens[b], L);
  T* dst = reinterpret_cast<T*>(out + ((size_t)b * L + j0) * D + c0);

  if (j0 >= len) {  // every owned row is padding: nothing to read
    T ninf;
    fill_neg_inf(ninf);
    for (int i = tid; i < rows * nv; i += blockDim.x) {
      const int r = i / nv;
      dst[(size_t)r * (D / kVec) + i - r * nv] = ninf;
    }
    return;
  }

  const int lo = max(0, j0 - NGRAM);
  const int n_src = min(len, j0 + kFwdRows + NGRAM) - lo;  // >= 1: row j0 is valid
  const int ct = nv * kVec;
  float* stage_lo = stage + (lo - j0 + NGRAM) * dt;
  const float* src_lo = emb + ((size_t)b * L + lo) * D + c0;
  if constexpr (kBulk) {
    if (tid == 0) {
      mbar_init(&bar, 1);
      const uint32_t row_bytes = ct * sizeof(float);
      mbar_arrive_expect_tx(&bar, n_src * row_bytes);
      if (ct == D) {  // one tile: the rows are contiguous in emb and in the stage
        bulk_copy_g2s(stage_lo, src_lo, n_src * row_bytes, &bar);
      } else {
        for (int s = 0; s < n_src; ++s) {
          bulk_copy_g2s(stage_lo + s * dt, src_lo + (size_t)s * D, row_bytes, &bar);
        }
      }
    }
  } else {
    for (int i = tid; i < n_src * ct; i += blockDim.x) {
      const int s = i / ct;
      stage_lo[s * dt + i - s * ct] = src_lo[(size_t)s * D + i - s * ct];
    }
  }
  __syncthreads();  // bar is initialised (the floats' stage is filled)

  const float* w_blk = w + ((size_t)b * L + j0) * W;
  const T* st = reinterpret_cast<const T*>(stage);
  const int sv = dt / kVec;  // a stage row's stride in items
  for (int i = tid; i < rows * nv; i += blockDim.x) {
    const int r = i / nv;
    const int v = i - r * nv;
    const int j = j0 + r;
    // the row's weights go out before the wait, beside the copy; after the
    // first item the wait returns at once
    float wk[W];
#pragma unroll
    for (int k = 0; k < W; ++k) wk[k] = w_blk[r * W + k];
    if constexpr (kBulk) mbar_wait(&bar, 0);
    // slot k reads source row j + k - g, stage row r + k
    const T* col = st + r * sv + v;
    T acc;
    fill_neg_inf(acc);
    if (j >= NGRAM && j + NGRAM < len) {  // every slot valid: no tests
      T e[W];
#pragma unroll
      for (int k = 0; k < W; ++k) e[k] = col[k * sv];
#pragma unroll
      for (int k = 0; k < W; ++k) max_msg(acc, e[k], wk[k]);
    } else if (j < len) {
      // invalid slots are skipped, which equals the plain version's -inf fill
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const int s = j + k - NGRAM;
        if (s >= 0 && s < len) max_msg(acc, col[k * sv], wk[k]);
      }
    }
    dst[(size_t)r * (D / kVec) + v] = acc;
  }
}

// Splits D into the fewest column tiles the stage holds and launches K1 with
// the fewest rounds of items a thread.
template <int NGRAM>
int launch_fwd(const float* emb, const float* w, const int* lens, float* out, int B, int L, int D,
               int vec, cudaStream_t stream) {
  static_assert(2 * NGRAM + 1 <= kMaxWindow, "the window the wrapper allows");
  constexpr int cap = fwd_tile_cap(NGRAM);
  const int tiles = (D + cap - 1) / cap;
  const int dt = tiles == 1 ? D : ((D + tiles - 1) / tiles + 3) / 4 * 4;
  const int items = kFwdRows * (vec == 4 ? dt / 4 : dt);
  const int rounds = (items + kFwdMaxThreads - 1) / kFwdMaxThreads;
  const int threads = ((items + rounds - 1) / rounds + 31) / 32 * 32;
  const dim3 grid(B, (L + kFwdRows - 1) / kFwdRows, tiles);
  if (vec == 4) {
    edge_max_fwd_kernel<NGRAM, true><<<grid, threads, 0, stream>>>(emb, w, lens, out, L, D, dt);
  } else {
    edge_max_fwd_kernel<NGRAM, false><<<grid, threads, 0, stream>>>(emb, w, lens, out, L, D, dt);
  }
  return static_cast<int>(cudaGetLastError());
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
// Bound: bytes.  It reads emb, g and w and writes d_emb and d_w, about
// 4*B*L*D*4 + 2*B*L*W*4 bytes (7.8 MB at B=16, L=100, D=300, g=4, ~2.3 us of
// HBM time on an H100; less for the valid rows of short documents), against
// ~50 MFLOP of compare, multiply and add.  So the kernel has to read each
// element a small number of times, keep its intermediates out of memory, and
// put enough threads on the card to hide the latency of a serial chain.
//
// Layout: grid (B, ceil(L / kBwdRows)), one thread per column d (a block of
// D lanes rounded up to whole warps, walking column tiles of at most
// kBwdMaxLanes).  A block owns kBwdRows rows, as source rows (d_emb) and as
// destination rows (d_w).  Each thread sweeps the rows j of
// [j0 - g, j0 + kBwdRows + g) in ascending order; for each row it recomputes
// the chain and walks it back in registers, with two rings:
//
// - the W values emb[j-g .. j+g, d]: one row enters per step, so each element
//   of emb is loaded (kBwdRows + 4g) / kBwdRows times, from HBM once;
// - W running d_emb sums, one per source row s = j-g .. j+g, into which row j
//   adds d_msg_k * w[j, k] for s = j + k - g.  As j rises a source row's k
//   falls, so its terms arrive in the plain backward's order (k descending,
//   __fmul_rn/__fadd_rn so nvcc contracts nothing into an FMA) and d_emb
//   equals it bit for bit.  After row j, source row j - g is complete and is
//   written if the block owns it.
//
// For an owned row, each lane's W products d_msg_k * emb[j+k-g, d] are summed
// over the warp by shuffles into a shared [kBwdRows][W][warps] array (over
// column tiles too), and the warps are summed in a fixed order at the end:
// deterministic, in another order than the plain sum.
//
// The window W = 2g+1 is a template parameter (g = 0 .. 16 behind one
// switch), so the rings and the chain are indexed at compile time and stay
// in registers.  The tie split multiplies by 0.5 or 1 where the plain version
// divides by 2 or 1: both round the same exact value, so the bits match.
// Shared memory is static and a few KB (the chunk's weights and the d_w
// partials), so a launch sets no attribute.  No atomics.  The cost of the
// design: each chain is recomputed in every block whose rows it reaches,
// (kBwdRows + 2g) / kBwdRows times in all.  On an H100 at B=16, L=100,
// D=300, g=4 it takes 18-20 us a launch, still far above the bound (times
// and the rows sweep in PERF.md).

constexpr int kBwdRows = 8;  // rows a block owns, the fastest of 4, 8, 16 (PERF.md)
constexpr int kBwdMaxLanes = 512;
constexpr int kBwdMaxWarps = kBwdMaxLanes / 32;

template <int NGRAM>
__global__ void __launch_bounds__(kBwdMaxLanes)
edge_max_bwd_kernel(const float* __restrict__ emb, const float* __restrict__ w,
                    const float* __restrict__ g, const int* __restrict__ lens,
                    float* __restrict__ d_emb, float* __restrict__ d_w, int L, int D) {
  constexpr int W = 2 * NGRAM + 1;
  constexpr int H = kBwdRows + 2 * NGRAM;   // rows whose chains the block needs
  __shared__ float w_s[H][W];
  __shared__ float red[kBwdRows][W][kBwdMaxWarps];

  const int b = blockIdx.x;
  const int j0 = blockIdx.y * kBwdRows;
  const int rows = min(kBwdRows, L - j0);
  const int len = min(lens[b], L);
  const int tid = threadIdx.x;
  const int C = blockDim.x;
  const size_t base = (size_t)b * L * D;

  if (j0 >= len) {  // every owned row is padding
    for (int i = tid; i < rows * D; i += C) d_emb[base + (size_t)j0 * D + i] = 0.f;
    for (int i = tid; i < rows * W; i += C) d_w[((size_t)b * L + j0) * W + i] = 0.f;
    return;
  }
  for (int i = tid; i < H * W; i += C) {
    const int j = j0 - NGRAM + i / W;
    w_s[i / W][i % W] = (j >= 0 && j < len) ? w[((size_t)b * L + j) * W + i % W] : 0.f;
  }
  for (int i = tid; i < kBwdRows * W * kBwdMaxWarps; i += C) (&red[0][0][0])[i] = 0.f;
  __syncthreads();

  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int c0 = 0; c0 < D; c0 += C) {
    const int d = c0 + tid;
    const bool lane_ok = d < D;
    // Rows outside [0, len) and lanes past D read 0, so such a lane's
    // d_msg and d_w products are 0 too.
    const float* e_col = emb + base + d;
    const float* g_col = g + base + d;
    auto load = [&](const float* col, int r) {
      return (lane_ok && r >= 0 && r < len) ? col[(size_t)r * D] : 0.f;
    };
    float e[W];     // e[k] = emb[j + k - g, d] for the current row j
    float part[W];  // part[k] = d_emb[j + k - g, d] so far
    e[0] = 0.f;
#pragma unroll
    for (int k = 1; k < W; ++k) e[k] = load(e_col, j0 - 2 * NGRAM - 1 + k);
#pragma unroll
    for (int k = 0; k < W; ++k) part[k] = 0.f;
    float e_next = load(e_col, j0);
    float g_next = load(g_col, j0 - NGRAM);

    for (int h = 0; h < H; ++h) {
      const int j = j0 - NGRAM + h;
#pragma unroll
      for (int k = 0; k + 1 < W; ++k) e[k] = e[k + 1];
      e[W - 1] = e_next;
      const float g_j = g_next;
      // the next row's loads go out before this row's arithmetic
      e_next = load(e_col, j + 1 + NGRAM);
      g_next = load(g_col, j + 1);

      if (j >= 0 && j < len) {  // the same for every thread of the block
        const float* wr = w_s[h];
        float msg[W], acc[W + 1], dw[W];
        acc[0] = neg_inf();
#pragma unroll
        for (int k = 0; k < W; ++k) {
          const int s = j + k - NGRAM;
          msg[k] = (s >= 0 && s < len) ? __fmul_rn(e[k], wr[k]) : neg_inf();
          acc[k + 1] = nan_max(acc[k], msg[k]);
        }
        float g_acc = g_j;
#pragma unroll
        for (int k = W - 1; k >= 0; --k) {
          const float out = acc[k + 1];
          const bool msg_hit = msg[k] == out;
          const bool prev_hit = acc[k] == out;
          // g * hit stays a multiply: inf * 0 is NaN, as in the plain version
          const float d_msg =
              __fmul_rn(__fmul_rn(g_acc, msg_hit ? 1.f : 0.f), prev_hit ? 0.5f : 1.f);
          g_acc = __fmul_rn(__fmul_rn(g_acc, prev_hit ? 1.f : 0.f), msg_hit ? 0.5f : 1.f);
          const int s = j + k - NGRAM;
          if (s >= 0 && s < len) part[k] = __fadd_rn(part[k], __fmul_rn(d_msg, wr[k]));
          dw[k] = __fmul_rn(d_msg, e[k]);
        }
        const int r = h - NGRAM;  // the owned row j is j0 + r
        if (r >= 0 && r < rows) {
#pragma unroll
          for (int k = 0; k < W; ++k) {
            float v = dw[k];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
            if (lane == 0) red[r][k][warp] += v;
          }
        }
      }
      const int s = j - NGRAM;  // its last term came from row j
      if (lane_ok && s >= j0 && s < j0 + rows) d_emb[base + (size_t)s * D + d] = part[0];
#pragma unroll
      for (int k = 0; k + 1 < W; ++k) part[k] = part[k + 1];
      part[W - 1] = 0.f;
    }
  }
  __syncthreads();

  const int nwarps = C / 32;
  for (int i = tid; i < rows * W; i += C) {
    const int r = i / W;
    const int k = i % W;
    const int j = j0 + r;
    const int s = j + k - NGRAM;
    float v = 0.f;
    if (j < len && s >= 0 && s < len) {
      for (int q = 0; q < nwarps; ++q) v += red[r][k][q];
    }
    d_w[((size_t)b * L + j) * W + k] = v;
  }
}

}  // namespace

// K1.  Launches on `stream` and returns cudaGetLastError() (0 = launched).
// The caller checks shapes, types, contiguity and, for vec == 4, that
// D % 4 == 0 and both pointers are 16-byte aligned, and passes B, L, D >= 1.
extern "C" int mgnns_edge_max_forward(const float* emb, const float* w,
                                      const int* lens, float* out, int B, int L,
                                      int D, int ngram, int vec, int device,
                                      cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
#define MGNNS_K1_CASE(N) \
  case N:                \
    return launch_fwd<N>(emb, w, lens, out, B, L, D, vec, stream);
  switch (ngram) {  // 2 * ngram + 1 <= kMaxWindow
    MGNNS_K1_CASE(0) MGNNS_K1_CASE(1) MGNNS_K1_CASE(2) MGNNS_K1_CASE(3)
    MGNNS_K1_CASE(4) MGNNS_K1_CASE(5) MGNNS_K1_CASE(6) MGNNS_K1_CASE(7)
    MGNNS_K1_CASE(8) MGNNS_K1_CASE(9) MGNNS_K1_CASE(10) MGNNS_K1_CASE(11)
    MGNNS_K1_CASE(12) MGNNS_K1_CASE(13) MGNNS_K1_CASE(14) MGNNS_K1_CASE(15)
    MGNNS_K1_CASE(16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MGNNS_K1_CASE
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
  // the fewest column tiles of at most kBwdMaxLanes, split evenly
  const int tiles = max(1, (D + kBwdMaxLanes - 1) / kBwdMaxLanes);
  const int lanes = max(32, ((D + tiles - 1) / tiles + 31) / 32 * 32);
  dim3 grid(B, (L + kBwdRows - 1) / kBwdRows);
#define MGNNS_K2_CASE(N)                                                            \
  case N:                                                                           \
    edge_max_bwd_kernel<N><<<grid, lanes, 0, stream>>>(emb, w, g, lens, d_emb, d_w, \
                                                       L, D);                       \
    break;
  switch (ngram) {  // 2 * ngram + 1 <= kMaxWindow
    MGNNS_K2_CASE(0) MGNNS_K2_CASE(1) MGNNS_K2_CASE(2) MGNNS_K2_CASE(3)
    MGNNS_K2_CASE(4) MGNNS_K2_CASE(5) MGNNS_K2_CASE(6) MGNNS_K2_CASE(7)
    MGNNS_K2_CASE(8) MGNNS_K2_CASE(9) MGNNS_K2_CASE(10) MGNNS_K2_CASE(11)
    MGNNS_K2_CASE(12) MGNNS_K2_CASE(13) MGNNS_K2_CASE(14) MGNNS_K2_CASE(15)
    MGNNS_K2_CASE(16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MGNNS_K2_CASE
  return static_cast<int>(cudaGetLastError());
}
