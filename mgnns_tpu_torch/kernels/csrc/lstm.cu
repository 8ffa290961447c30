// The BiLSTM's recurrence (mgnns_tpu_torch/nn/lstm.py) as two persistent
// kernels: mgnns_lstm_fwd_kernel runs every step of one layer, both
// directions, in one launch; mgnns_lstm_bwd_kernel runs that layer's
// reverse-time gradient chain in one launch.
//
// Replaces no TPU kernel: the JAX package's LSTM is a lax.scan that XLA
// compiles into one loop on the device.  The port's plain version is a
// Python loop of L steps a direction and layer, about 5,000 small kernels a
// forward (and more in the backward), and inside a captured step the card
// idles between them.  So what bounds the recurrence here is the latency of
// its L dependent steps, not FLOPs (2 * B * H * 4H a step and direction,
// 2.9 MFLOP at B=16, H=150) or bytes (w_hh, 360 KB a direction, is read once).
//
// Design.  Each step is h_{t-1} @ w_hh [H, 4H] for the rows of a batch tile,
// then the cell.  One thread-block cluster of C CTAs works one (batch tile,
// direction); rows of the batch are independent, so tiles spread over
// clusters.  CTA `rank` of a cluster owns U = ceil(H / C) hidden units
// [rank * U, ...) and keeps the matching slice of w_hh resident in shared
// memory for the whole launch: the forward the four gate columns of each of
// its units (H x U float4), the backward the units' rows of w_hh (the
// product dgates_t @ w_hh^T).  The vector a step multiplies, h_{t-1} (the
// forward) or dgates_t (the backward) of every unit and row of the tile,
// lives in each CTA's shared memory, double-buffered.  A step is:
//
//   1. the product: thread (unit j, 4-row group, lane s of ks) sums its
//      k-slice k = s, s + ks, ... of a 4-row x 4-gate tile from shared
//      memory, then the ks lanes of the group add their partials by
//      shuffles, in a fixed order;
//   2. the cell, by lane s < 4 of the group for row s of its rows, unit j;
//   3. the new vector slice, written by each owner into the next buffer of
//      every CTA of the cluster through distributed shared memory, then one
//      cluster barrier, split: between its arrive (release) and its wait
//      (acquire) a thread stores the step's outputs to global memory and
//      loads the next step's inputs, so neither waits on the chain.
//
// On an H100 a step costs ~2.8 us (PERF.md has the times): the barrier and
// the exchange, the tile's product and the cell's accurate expf / tanhf in
// a row, against a few us of bound for the whole layer.
//
// Rows hold their carry at t >= len (the output there is 0) and the reverse
// direction walks from L - 1, as the plain version does; steps where every
// row of a tile is past its length do no product and no barrier.  The
// forward saves the post-activation gates (i, f, g, o) and the cell of every
// step for the backward, zeros at held steps.  The backward seeds dh and dc
// with the gradients of h_T and c_T (zero when null), passes them through
// held steps with dgates = 0, and writes dgates [dirs, B, L, 4H]; the
// weight and input gradients are GEMMs over all steps outside the kernel,
// each direction's operands contiguous.
//
// IEEE float32 throughout: FFMA, accurate expf and tanhf, no atomics, a
// fixed order of every sum, so two launches on the same inputs are
// bit-equal.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 4;          // batch rows of one thread group's tile
constexpr int kMaxThreads = 512;  // the launcher's largest block

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// Value `i` of row `s` (0 .. kRows - 1) of a [kRows][n] register tile,
// by selects, so the tile stays in registers.
template <int N>
__device__ __forceinline__ float row_value(const float (&v)[kRows * N], int s, int i) {
  return s == 0 ? v[i] : s == 1 ? v[N + i] : s == 2 ? v[2 * N + i] : v[3 * N + i];
}

// Sums each value over the `ks` adjacent lanes of a group (ks a power of
// two, at most 32).  Every lane ends with the same sums: each level adds a
// pair of equal partial sums in either order.
template <int N>
__device__ __forceinline__ void group_sum(float (&v)[N], int ks) {
  for (int off = ks >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
  }
}

// Row strides of the vector buffers, in floats, padded so that the 8 lanes
// of a quarter warp, which read 16 bytes each at consecutive k, hit
// distinct banks.  The forward's is h at k of the tile's rows, the
// backward's dgates at m of each row's four gates.
__device__ constexpr int fwd_stride(int rows) { return rows % 8 == 0 ? rows + 4 : rows; }
__device__ constexpr int bwd_stride(int rows) { return 4 * rows + 4; }

// The split cluster barrier: arrive releases this thread's earlier writes
// (its stores into the other CTAs' buffers), wait acquires everyone's.
// Between the two a thread does work that no other CTA reads in this step.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The largest length of the tile's rows, clamped to [0, L].
__device__ int tile_length(const int* lens, int b0, int rows, int B, int L) {
  int m = 0;
  for (int q = 0; q < rows && b0 + q < B; ++q) m = max(m, min(max(lens[b0 + q], 0), L));
  return m;
}

}  // namespace

// Grid (C, ceil(B / rows), dirs) in clusters of (C, 1, 1); blockDim a
// multiple of 32 that covers U * rows / 4 groups of ks lanes; dynamic shared
// memory 16 * H * (U | 1) + 8 * H * fwd_stride(rows) bytes.
// xw [dirs, B, L, 4H] (x @ w_ih + b_ih of each direction), w_hh [dirs, H,
// 4H], b_hh [dirs, 4H], lens [B] -> out [B, L, dirs * H], h_n and c_n
// [dirs, B, H]; gates [dirs, B, L, 4H] and cells [B, L, dirs * H] when not
// null.
extern "C" __global__ void __launch_bounds__(kMaxThreads, 1) mgnns_lstm_fwd_kernel(
    const float* __restrict__ xw, const float* __restrict__ w_hh,
    const float* __restrict__ b_hh, const int* __restrict__ lens, float* __restrict__ out,
    float* __restrict__ h_n, float* __restrict__ c_n, float* __restrict__ gates,
    float* __restrict__ cells, int B, int L, int H, int rows, int ks) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int dirs = gridDim.z, d = blockIdx.z;
  const int G = 4 * H;
  const int U = (H + C - 1) / C;
  const int ws = U | 1;  // row stride of the weights, in float4: odd, so 8 lanes at
                         // consecutive k hit distinct banks
  const int j0 = rank * U;
  const int units = max(0, min(U, H - j0));
  const int vs = fwd_stride(rows);
  extern __shared__ float4 smem[];
  float4* w_s = smem;                                     // [H][ws]: gates i, f, g, o
  float* h_s = reinterpret_cast<float*>(smem + H * ws);   // [2][H][vs]: h^T of the tile

  const int tid = threadIdx.x;
  const int s = tid % ks, grp = tid / ks;
  const int j = grp / (rows / kRows), rg = grp % (rows / kRows);
  const bool active = j < units;
  const bool owner = active && s < kRows;
  const int r = rg * kRows + s;
  const int b = blockIdx.y * rows + r;
  const bool row_ok = owner && b < B;
  const int len = row_ok ? min(max(lens[b], 0), L) : 0;

  const float* w = w_hh + static_cast<size_t>(d) * H * G;
  for (int i = tid; i < H * U; i += blockDim.x) {
    const int k = i / U, jj = i % U;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (jj < units) {
      const float* wk = w + static_cast<size_t>(k) * G + j0 + jj;
      v = make_float4(wk[0], wk[H], wk[2 * H], wk[3 * H]);
    }
    w_s[k * ws + jj] = v;
  }
  for (int i = tid; i < H * vs; i += blockDim.x) h_s[i] = 0.0f;  // h_{-1} = 0
  float bias[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (row_ok) {
#pragma unroll
    for (int g = 0; g < 4; ++g) bias[g] = b_hh[d * G + g * H + j0 + j];
  }
  // the step's input projection, loaded a step ahead
  float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  auto fetch = [&](int step) {
    const int t = d == 0 ? step : L - 1 - step;
    if (step < L && row_ok && t < len) {
      const size_t xo = ((static_cast<size_t>(d) * B + b) * L + t) * G + j0 + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) x[g] = xw[xo + g * H];
    }
  };
  fetch(0);
  const int tl = tile_length(lens, blockIdx.y * rows, rows, B, L);
  float h = 0.0f, c = 0.0f;
  cluster.sync();  // every CTA of the cluster runs, its weights and h_{-1} in place

  int cur = 0;
  for (int step = 0; step < L; ++step) {
    const int t = d == 0 ? step : L - 1 - step;
    const bool live = row_ok && t < len;
    const size_t xo = ((static_cast<size_t>(d) * B + b) * L + t) * G + j0 + j;
    const size_t ho = (static_cast<size_t>(b) * L + t) * dirs * H + d * H + j0 + j;
    if (t >= tl) {  // every row of the tile holds its carry
      if (row_ok) {
        out[ho] = 0.0f;
        if (cells != nullptr) {
          cells[ho] = 0.0f;
#pragma unroll
          for (int g = 0; g < 4; ++g) gates[xo + g * H] = 0.0f;
        }
      }
      fetch(step + 1);
      continue;
    }
    float acc[kRows * 4];
#pragma unroll
    for (int i = 0; i < kRows * 4; ++i) acc[i] = 0.0f;
    if (active) {
      const float* hv = h_s + cur * H * vs + rg * kRows;
      const float4* wj = w_s + j;
#pragma unroll 4
      for (int k = s; k < H; k += ks) {
        const float4 wv = wj[k * ws];
        const float4 hk = *reinterpret_cast<const float4*>(hv + k * vs);
        const float hr[kRows] = {hk.x, hk.y, hk.z, hk.w};
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          acc[q * 4 + 0] += hr[q] * wv.x;
          acc[q * 4 + 1] += hr[q] * wv.y;
          acc[q * 4 + 2] += hr[q] * wv.z;
          acc[q * 4 + 3] += hr[q] * wv.w;
        }
      }
    }
    group_sum(acc, ks);
    float gate[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (owner) {
      if (live) {
        gate[0] = sigmoid(row_value<4>(acc, s, 0) + x[0] + bias[0]);
        gate[1] = sigmoid(row_value<4>(acc, s, 1) + x[1] + bias[1]);
        gate[2] = tanhf(row_value<4>(acc, s, 2) + x[2] + bias[2]);
        gate[3] = sigmoid(row_value<4>(acc, s, 3) + x[3] + bias[3]);
        c = gate[1] * c + gate[0] * gate[2];
        h = gate[3] * tanhf(c);
      }
      // h_t of (row r, unit j0 + j), new or held, into every CTA's next buffer
      float* dst = h_s + (cur ^ 1) * H * vs + (j0 + j) * vs + r;
      for (int q = 0; q < C; ++q) *cluster.map_shared_rank(dst, q) = h;
    }
    cluster_arrive();
    // off the chain, until the cluster is through: this step's stores, the
    // next step's loads
    if (row_ok) {
      out[ho] = live ? h : 0.0f;
      if (cells != nullptr) {
        cells[ho] = live ? c : 0.0f;
#pragma unroll
        for (int g = 0; g < 4; ++g) gates[xo + g * H] = gate[g];
      }
    }
    fetch(step + 1);
    cluster_wait();
    cur ^= 1;
  }
  if (row_ok) {
    const size_t so = (static_cast<size_t>(d) * B + b) * H + j0 + j;
    h_n[so] = h;
    c_n[so] = c;
  }
}

// Grid, clusters and blocks as the forward's; dynamic shared memory
// 16 * H * (U | 1) + 8 * H * bwd_stride(rows) bytes.
// gates [dirs, B, L, 4H] and cells [B, L, dirs * H] (the forward's saves),
// w_hh [dirs, H, 4H], lens [B], and the gradients g_out [B, L, dirs * H],
// g_hn and g_cn [dirs, B, H] (each may be null: zero) -> dgates
// [dirs, B, L, 4H], the gradient of the gates' pre-activations.
extern "C" __global__ void __launch_bounds__(kMaxThreads, 1) mgnns_lstm_bwd_kernel(
    const float* __restrict__ gates, const float* __restrict__ cells,
    const float* __restrict__ w_hh, const int* __restrict__ lens,
    const float* __restrict__ g_out, const float* __restrict__ g_hn,
    const float* __restrict__ g_cn, float* __restrict__ dgates, int B, int L, int H, int rows,
    int ks) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int dirs = gridDim.z, d = blockIdx.z;
  const int G = 4 * H;
  const int U = (H + C - 1) / C;
  const int ws = U | 1;
  const int j0 = rank * U;
  const int units = max(0, min(U, H - j0));
  const int vs = bwd_stride(rows);
  extern __shared__ float4 smem[];
  float4* w_s = smem;                                     // [H][ws]: w_hh[j0 + j][g * H + m] at m
  float* v_s = reinterpret_cast<float*>(smem + H * ws);   // [2][H][vs]: dgates_t of (m, row, gate)

  const int tid = threadIdx.x;
  const int s = tid % ks, grp = tid / ks;
  const int j = grp / (rows / kRows), rg = grp % (rows / kRows);
  const bool active = j < units;
  const bool owner = active && s < kRows;
  const int r = rg * kRows + s;
  const int b = blockIdx.y * rows + r;
  const bool row_ok = owner && b < B;
  const int len = row_ok ? min(max(lens[b], 0), L) : 0;

  const float* w = w_hh + static_cast<size_t>(d) * H * G;
  for (int i = tid; i < H * U; i += blockDim.x) {
    const int m = i / U, jj = i % U;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (jj < units) {
      const float* wr = w + static_cast<size_t>(j0 + jj) * G + m;
      v = make_float4(wr[0], wr[H], wr[2 * H], wr[3 * H]);
    }
    w_s[m * ws + jj] = v;
  }
  float dh = 0.0f, dc = 0.0f;
  if (row_ok) {
    const size_t so = (static_cast<size_t>(d) * B + b) * H + j0 + j;
    if (g_hn != nullptr) dh = g_hn[so];
    if (g_cn != nullptr) dc = g_cn[so];
  }
  // the step's saves and output gradient, loaded a step ahead: gates i, f,
  // g, o, the cell, the carry the step updated (the neighbour step's cell,
  // 0 at either end and after a held step, where the saves are 0), dh_t
  float in[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  auto fetch = [&](int step) {
    const int t = d == 0 ? L - 1 - step : step;
    if (step < L && row_ok && t < len) {
      const size_t xo = ((static_cast<size_t>(d) * B + b) * L + t) * G + j0 + j;
      const size_t ho = (static_cast<size_t>(b) * L + t) * dirs * H + d * H + j0 + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) in[g] = gates[xo + g * H];
      in[4] = cells[ho];
      in[5] = 0.0f;
      if (d == 0 && t > 0) in[5] = cells[ho - static_cast<size_t>(dirs) * H];
      if (d == 1 && t + 1 < L) in[5] = cells[ho + static_cast<size_t>(dirs) * H];
      in[6] = g_out != nullptr ? g_out[ho] : 0.0f;
    }
  };
  fetch(0);
  const int tl = tile_length(lens, blockIdx.y * rows, rows, B, L);
  cluster.sync();

  int cur = 0;
  for (int step = 0; step < L; ++step) {
    const int t = d == 0 ? L - 1 - step : step;
    const bool live = row_ok && t < len;
    const size_t xo = ((static_cast<size_t>(d) * B + b) * L + t) * G + j0 + j;
    if (t >= tl) {  // every row of the tile is held: dh and dc pass, dgates = 0
      if (row_ok) {
#pragma unroll
        for (int g = 0; g < 4; ++g) dgates[xo + g * H] = 0.0f;
      }
      fetch(step + 1);
      continue;
    }
    float4 da = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (live) {
      const float ig = in[0], fg = in[1], gg = in[2], og = in[3];
      const float dht = dh + in[6];
      const float tc = tanhf(in[4]);
      const float dct = dc + dht * og * (1.0f - tc * tc);
      da.x = dct * gg * ig * (1.0f - ig);
      da.y = dct * in[5] * fg * (1.0f - fg);
      da.z = dct * ig * (1.0f - gg * gg);
      da.w = dht * tc * og * (1.0f - og);
      dc = dct * fg;
    }
    if (owner) {  // dgates_t of (row r, unit j0 + j) into every CTA's buffer
      float4* dst = reinterpret_cast<float4*>(v_s + (cur * H + j0 + j) * vs + r * 4);
      for (int q = 0; q < C; ++q) *cluster.map_shared_rank(dst, q) = da;
    }
    cluster_arrive();
    if (row_ok) {
      dgates[xo] = da.x;
      dgates[xo + H] = da.y;
      dgates[xo + 2 * H] = da.z;
      dgates[xo + 3 * H] = da.w;
    }
    fetch(step + 1);
    cluster_wait();
    float acc[kRows] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (active) {
      const float* v = v_s + cur * H * vs + rg * kRows * 4;
      const float4* wj = w_s + j;
#pragma unroll 4
      for (int m = s; m < H; m += ks) {
        const float4 wv = wj[m * ws];
        const float4* vm = reinterpret_cast<const float4*>(v + m * vs);
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          const float4 a = vm[q];
          acc[q] += a.x * wv.x + a.y * wv.y + a.z * wv.z + a.w * wv.w;
        }
      }
    }
    group_sum(acc, ks);
    if (live) dh = row_value<1>(acc, s, 0);  // dh_{t-1} = dgates_t @ w_hh^T
    cur ^= 1;
  }
}

namespace {

template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), int C, int B, int dirs, int rows, int threads, int smem,
           cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, (B + rows - 1) / rows, dirs);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

bool plan_ok(int B, int H, int dirs, int C, int rows, int ks, int threads) {
  const int U = (H + C - 1) / C;
  return B >= 1 && H >= 1 && (dirs == 1 || dirs == 2) && C >= 1 && C <= 8 &&
         (rows == 4 || rows == 8 || rows == 16) && ks >= kRows && ks <= 32 &&
         (ks & (ks - 1)) == 0 && threads % 32 == 0 && threads <= kMaxThreads &&
         threads >= U * (rows / kRows) * ks;
}

}  // namespace

// The forward.  Launches on `stream` and returns the first CUDA error (0 =
// launched).  The caller checks shapes, types and contiguity and passes the
// plan (cluster C, rows, ks, threads, smem) that kernels/lstm.py:plan
// computes; gates and cells are both null or both not.
extern "C" int mgnns_lstm_forward(const float* xw, const float* w_hh, const float* b_hh,
                                  const int* lens, float* out, float* h_n, float* c_n,
                                  float* gates, float* cells, int B, int L, int H, int dirs,
                                  int C, int rows, int ks, int threads, int smem, int device,
                                  cudaStream_t stream) {
  if (!plan_ok(B, H, dirs, C, rows, ks, threads) || (gates == nullptr) != (cells == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch(mgnns_lstm_fwd_kernel, C, B, dirs, rows, threads, smem, stream, xw, w_hh, b_hh,
                lens, out, h_n, c_n, gates, cells, B, L, H, rows, ks);
}

// The backward, as the forward.  g_out, g_hn and g_cn may be null (zero).
extern "C" int mgnns_lstm_backward(const float* gates, const float* cells, const float* w_hh,
                                   const int* lens, const float* g_out, const float* g_hn,
                                   const float* g_cn, float* dgates, int B, int L, int H,
                                   int dirs, int C, int rows, int ks, int threads, int smem,
                                   int device, cudaStream_t stream) {
  if (!plan_ok(B, H, dirs, C, rows, ks, threads)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch(mgnns_lstm_bwd_kernel, C, B, dirs, rows, threads, smem, stream, gates, cells,
                w_hh, lens, g_out, g_hn, g_cn, dgates, B, L, H, rows, ks);
}
