// The optimizer's chain (mgnns_tpu_torch/engine/optim.py) as multi-tensor
// kernels: mgnns_adam_sumsq_kernel and mgnns_adam_sumsq_finish_kernel take
// the clip's global norm, mgnns_adam_update_kernel (Adam, or SGD) runs the
// rest of the chain, and mgnns_adam_select_kernel is the nan-guard's
// guarded copy of other state (the BN running statistics, the
// accumulation window).
//
// Replaces no TPU kernel: the JAX package's optax chain is elementwise work
// that XLA fuses into one pass over each leaf.  The port's plain chain is
// ~16 torch._foreach_* passes and three torch.where launches a leaf, each
// reading and writing whole float32 temporaries (~170 B an element).  The
// chain is memory-bound: its least traffic is 4 B an element to read the
// gradient for the norm, 16 B to read p, g, m and v, 12 B to write p, m and
// v, 32 B in all, so the fusion model's 91 M trained elements take ~0.9 ms
// at 3.35 TB/s and a 2.74 B-element text encoder ~26 ms.
//
// Design.  A launch takes a table of up to kMax*Leaves leaves by value in
// its parameters (Hopper with CUDA >= 12.1 takes 32,764 bytes of them), so
// a captured graph records it with no host-to-device copy.  A leaf is split
// into chunks of `chunk` elements; block c finds its leaf by a binary
// search of the table's first-chunk prefix and walks its chunk in groups of
// four elements, one group a thread at a time, with 16-byte loads where the
// leaf's pointers allow.  A gradient laid out as its parameter is walked
// as flat storage; a channels_last gradient of a contiguous OIHW parameter
// (the trunks' conv weights, whose gradients come back through
// channels_last convs) is read through its index map, `cl` = (I << 16) |
// H * W.
//
// The norm is deterministic: each thread sums the squares of its groups in
// order (a fixed walk of the parameter's logical order, whichever path
// loads them), each block reduces its threads in a fixed tree into one
// partial a chunk, and one block adds the partials in a fixed order in
// double.  No atomics, so two runs, and two engines whose gradients differ
// only in layout or alignment, give the same bits.
//
// The update computes, in float32 with IEEE intrinsics so that nvcc
// contracts nothing, the chain of engine/optim.py in its order: the clip's
// scale from the norm read on the device, + wd * p, the moments, m / bc1
// over sqrt(v / bc2) + eps, the leaf's group factor, * -lr(step), the add
// to p.  The step's device scalars (norm, ok, bc1, bc2, -lr) are read on
// the device, so a launch captures.  Where `ok` is false nothing is stored:
// every old value is kept bit for bit and no non-finite value is ever
// multiplied into it.  A null gradient reads as zeros.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFinishThreads = 1024;
constexpr int kMaxUpdateLeaves = 672;   // kernels/adam.py: MAX_UPDATE_LEAVES
constexpr int kMaxNormLeaves = 1536;    // MAX_NORM_LEAVES
constexpr int kMaxCopies = 1280;        // MAX_COPIES
constexpr int kParamBytes = 32764;      // a kernel's parameters, CUDA >= 12.1

struct UpdateTable {
  float* p[kMaxUpdateLeaves];
  const float* g[kMaxUpdateLeaves];  // null: a zero gradient
  float* m[kMaxUpdateLeaves];        // null under SGD
  float* v[kMaxUpdateLeaves];
  int n[kMaxUpdateLeaves];           // elements
  int start[kMaxUpdateLeaves];       // the leaf's first chunk in this launch
  unsigned cl[kMaxUpdateLeaves];     // 0: g walks as p; else (I << 16) | H * W
  float factor[kMaxUpdateLeaves];    // the leaf's group factor
  int leaves;
};

struct UpdateArgs {
  const float* norm;    // the clip's global norm
  const bool* ok;       // null: always
  const float* bc1;     // 1 - b1^t, 1 - b2^t (Adam)
  const float* bc2;
  const float* neg_lr;  // -lr(step)
  float clip, wd;
  int chunk;
};

struct NormTable {
  const float* g[kMaxNormLeaves];
  int n[kMaxNormLeaves];
  int start[kMaxNormLeaves];
  unsigned cl[kMaxNormLeaves];
  int leaves;
};

struct CopyTable {
  char* dst[kMaxCopies];
  const char* src[kMaxCopies];
  int n[kMaxCopies];  // bytes
  int start[kMaxCopies];
  int leaves;
};

static_assert(sizeof(UpdateTable) + sizeof(UpdateArgs) <= kParamBytes, "update table");
static_assert(sizeof(NormTable) + 2 * sizeof(void*) + 2 * sizeof(int) <= kParamBytes,
              "norm table");
static_assert(sizeof(CopyTable) + sizeof(void*) + sizeof(int) <= kParamBytes, "copy table");

// The last leaf whose first chunk is at most `c` (empty leaves are not in a
// table, so that leaf holds chunk c).
template <int N>
__device__ __forceinline__ int leaf_of(const int (&start)[N], int leaves, int c) {
  int lo = 0, hi = leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (start[mid] <= c) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Offset in a gradient of the parameter's element i: itself, or its place
// in channels_last storage (strides I * H * W, 1, W * I, I) of an OIHW
// element.
__device__ __forceinline__ unsigned grad_offset(unsigned i, unsigned cl) {
  if (cl == 0) return i;
  const unsigned I = cl >> 16, hw_n = cl & 0xffffu, per_o = I * hw_n;
  const unsigned o = i / per_o, r = i - o * per_o;
  const unsigned c = r / hw_n, hw = r - c * hw_n;
  return o * per_o + hw * I + c;
}

// The whole block's sum of x in a fixed order, in thread 0.
template <typename T, int kN>
__device__ __forceinline__ T block_sum(T x) {
  __shared__ T warps[kN / 32];
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warps[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < kN / 32 ? warps[lane] : T(0);
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  }
  return x;
}

struct Chain {
  float scale, wd, b1c, b2c, factor, neg_lr;

  // One element of the chain; p, m, v in place.
  template <bool kAdam>
  __device__ __forceinline__ void step(float& p, float g, float& m, float& v) const {
    g = __fmul_rn(g, scale);
    if (wd != 0.0f) g = __fadd_rn(g, __fmul_rn(wd, p));
    float u = g;
    if (kAdam) {
      m = __fadd_rn(__fmul_rn(m, 0.9f), __fmul_rn(0.1f, g));
      v = __fadd_rn(__fmul_rn(v, 0.999f), __fmul_rn(0.001f, __fmul_rn(g, g)));
      u = __fdiv_rn(__fdiv_rn(m, b1c), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, b2c)), 1e-8f));
    }
    p = __fadd_rn(p, __fmul_rn(__fmul_rn(u, factor), neg_lr));
  }
};

}  // namespace

// Grid: the launch's chunks; block kThreads.  partials[c] = the sum of the
// squares of chunk c's gradient elements.
__global__ void __launch_bounds__(kThreads) mgnns_adam_sumsq_kernel(const NormTable t,
                                                                    float* partials, int chunk) {
  const int c = blockIdx.x;
  const int l = leaf_of(t.start, t.leaves, c);
  const unsigned begin = static_cast<unsigned>(c - t.start[l]) * chunk;
  const unsigned end = min(begin + chunk, static_cast<unsigned>(t.n[l]));
  const float* __restrict__ g = t.g[l];
  const unsigned cl = t.cl[l];
  const bool vec = cl == 0 && aligned16(g);
  float acc = 0.0f;
  for (unsigned i = begin + 4 * threadIdx.x; i < end; i += 4 * kThreads) {
    if (vec && i + 4 <= end) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(g + i));
      acc = __fmaf_rn(x.x, x.x, acc);
      acc = __fmaf_rn(x.y, x.y, acc);
      acc = __fmaf_rn(x.z, x.z, acc);
      acc = __fmaf_rn(x.w, x.w, acc);
    } else {
      for (unsigned k = i; k < i + 4 && k < end; ++k) {
        const float x = __ldg(g + grad_offset(k, cl));
        acc = __fmaf_rn(x, x, acc);
      }
    }
  }
  acc = block_sum<float, kThreads>(acc);
  if (threadIdx.x == 0) partials[c] = acc;
}

// One block of kFinishThreads: out[0] = the sum of `total` partials (added
// in double, in a fixed order), out[1] = its square root.
__global__ void __launch_bounds__(kFinishThreads) mgnns_adam_sumsq_finish_kernel(
    const float* __restrict__ partials, int total, float* __restrict__ out) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < total; i += kFinishThreads) acc += partials[i];
  acc = block_sum<double, kFinishThreads>(acc);
  if (threadIdx.x == 0) {
    out[0] = static_cast<float>(acc);
    out[1] = static_cast<float>(__dsqrt_rn(acc));
  }
}

// Grid: the launch's chunks; block kThreads.
template <bool kAdam>
__global__ void __launch_bounds__(kThreads) mgnns_adam_update_kernel(const UpdateTable t,
                                                                     const UpdateArgs a) {
  if (a.ok != nullptr && !*a.ok) return;
  const int c = blockIdx.x;
  const int l = leaf_of(t.start, t.leaves, c);
  const unsigned begin = static_cast<unsigned>(c - t.start[l]) * a.chunk;
  const unsigned end = min(begin + a.chunk, static_cast<unsigned>(t.n[l]));
  float* __restrict__ p = t.p[l];
  const float* __restrict__ g = t.g[l];
  float* __restrict__ m = t.m[l];
  float* __restrict__ v = t.v[l];
  const unsigned cl = t.cl[l];
  const float norm = *a.norm;
  Chain ch;
  // optim.py's where(norm < clip, 1, clip / norm), clip / norm as torch
  // computes a scalar over a tensor: reciprocal(norm) * clip
  ch.scale = norm < a.clip ? 1.0f : __fmul_rn(__frcp_rn(norm), a.clip);
  ch.wd = a.wd;
  ch.b1c = kAdam ? *a.bc1 : 1.0f;
  ch.b2c = kAdam ? *a.bc2 : 1.0f;
  ch.factor = t.factor[l];
  ch.neg_lr = *a.neg_lr;
  const bool vec = aligned16(p) && (!kAdam || (aligned16(m) && aligned16(v))) &&
                   (g == nullptr || cl != 0 || aligned16(g));
  for (unsigned i = begin + 4 * threadIdx.x; i < end; i += 4 * kThreads) {
    if (vec && i + 4 <= end) {
      float4 pv = *reinterpret_cast<const float4*>(p + i);
      float4 gv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (g != nullptr && cl == 0) {
        gv = __ldg(reinterpret_cast<const float4*>(g + i));
      } else if (g != nullptr) {
        gv = make_float4(__ldg(g + grad_offset(i, cl)), __ldg(g + grad_offset(i + 1, cl)),
                         __ldg(g + grad_offset(i + 2, cl)), __ldg(g + grad_offset(i + 3, cl)));
      }
      float4 mv = make_float4(0.0f, 0.0f, 0.0f, 0.0f), vv = mv;
      if (kAdam) {
        mv = *reinterpret_cast<const float4*>(m + i);
        vv = *reinterpret_cast<const float4*>(v + i);
      }
      ch.step<kAdam>(pv.x, gv.x, mv.x, vv.x);
      ch.step<kAdam>(pv.y, gv.y, mv.y, vv.y);
      ch.step<kAdam>(pv.z, gv.z, mv.z, vv.z);
      ch.step<kAdam>(pv.w, gv.w, mv.w, vv.w);
      *reinterpret_cast<float4*>(p + i) = pv;
      if (kAdam) {
        *reinterpret_cast<float4*>(m + i) = mv;
        *reinterpret_cast<float4*>(v + i) = vv;
      }
    } else {
      for (unsigned k = i; k < i + 4 && k < end; ++k) {
        float pk = p[k], mk = 0.0f, vk = 0.0f;
        const float gk = g != nullptr ? __ldg(g + grad_offset(k, cl)) : 0.0f;
        if (kAdam) {
          mk = m[k];
          vk = v[k];
        }
        ch.step<kAdam>(pk, gk, mk, vk);
        p[k] = pk;
        if (kAdam) {
          m[k] = mk;
          v[k] = vk;
        }
      }
    }
  }
}

// Grid: the launch's chunks of `chunk` bytes; block kThreads.  dst = src
// where *ok (always for a null ok), byte for byte.
__global__ void __launch_bounds__(kThreads) mgnns_adam_select_kernel(const CopyTable t,
                                                                     const bool* ok,
                                                                     int chunk) {
  if (ok != nullptr && !*ok) return;
  const int c = blockIdx.x;
  const int l = leaf_of(t.start, t.leaves, c);
  const unsigned begin = static_cast<unsigned>(c - t.start[l]) * chunk;
  const unsigned end = min(begin + chunk, static_cast<unsigned>(t.n[l]));
  char* __restrict__ dst = t.dst[l];
  const char* __restrict__ src = t.src[l];
  const bool vec = aligned16(dst) && aligned16(src);
  for (unsigned i = begin + 16 * threadIdx.x; i < end; i += 16 * kThreads) {
    if (vec && i + 16 <= end) {
      *reinterpret_cast<uint4*>(dst + i) = __ldg(reinterpret_cast<const uint4*>(src + i));
    } else {
      for (unsigned k = i; k < i + 16 && k < end; ++k) dst[k] = src[k];
    }
  }
}

namespace {

bool launch_ok(int leaves, int max_leaves, int chunks, int chunk) {
  return leaves >= 1 && leaves <= max_leaves && chunks >= 1 && chunk >= 16 && chunk % 16 == 0;
}

}  // namespace

// The plan's arrays for one launch (kernels/adam.py: plan): ptrs [leaves][4]
// (p, g, m, v; g null for a zero gradient, m and v null under SGD), n,
// start and cl [leaves] and factor [leaves].  The device scalars: norm
// (float), ok (bool, may be null), bc1 and bc2 (float, Adam), neg_lr
// (float).  Returns cudaGetLastError() (0 = launched).
extern "C" int mgnns_adam_update(const int64_t* ptrs, const int* n, const int* start,
                                 const unsigned* cl, const float* factor, int leaves,
                                 int chunks, int chunk, const float* norm, const bool* ok,
                                 const float* bc1, const float* bc2, const float* neg_lr,
                                 float clip, float wd, int adam, int device,
                                 cudaStream_t stream) {
  if (!launch_ok(leaves, kMaxUpdateLeaves, chunks, chunk) || norm == nullptr ||
      neg_lr == nullptr || (adam && (bc1 == nullptr || bc2 == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  UpdateTable t;
  for (int i = 0; i < leaves; ++i) {
    t.p[i] = reinterpret_cast<float*>(ptrs[4 * i]);
    t.g[i] = reinterpret_cast<const float*>(ptrs[4 * i + 1]);
    t.m[i] = reinterpret_cast<float*>(ptrs[4 * i + 2]);
    t.v[i] = reinterpret_cast<float*>(ptrs[4 * i + 3]);
    t.n[i] = n[i];
    t.start[i] = start[i];
    t.cl[i] = cl[i];
    t.factor[i] = factor[i];
  }
  t.leaves = leaves;
  const UpdateArgs a{norm, ok, bc1, bc2, neg_lr, clip, wd, chunk};
  if (adam)
    mgnns_adam_update_kernel<true><<<chunks, kThreads, 0, stream>>>(t, a);
  else
    mgnns_adam_update_kernel<false><<<chunks, kThreads, 0, stream>>>(t, a);
  return static_cast<int>(cudaGetLastError());
}

// One launch of the norm's first pass: g [leaves], n, start and cl
// [leaves]; writes partials[0, chunks).
extern "C" int mgnns_adam_sumsq(const int64_t* g, const int* n, const int* start,
                                const unsigned* cl, int leaves, int chunks, int chunk,
                                float* partials, int device, cudaStream_t stream) {
  if (!launch_ok(leaves, kMaxNormLeaves, chunks, chunk) || partials == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  NormTable t;
  for (int i = 0; i < leaves; ++i) {
    t.g[i] = reinterpret_cast<const float*>(g[i]);
    t.n[i] = n[i];
    t.start[i] = start[i];
    t.cl[i] = cl[i];
  }
  t.leaves = leaves;
  mgnns_adam_sumsq_kernel<<<chunks, kThreads, 0, stream>>>(t, partials, chunk);
  return static_cast<int>(cudaGetLastError());
}

// The norm's second pass over `total` partials: out[0] the sum of squares,
// out[1] its square root.
extern "C" int mgnns_adam_sumsq_finish(const float* partials, int total, float* out, int device,
                                       cudaStream_t stream) {
  if (total < 0 || out == nullptr || (total > 0 && partials == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  mgnns_adam_sumsq_finish_kernel<<<1, kFinishThreads, 0, stream>>>(partials, total, out);
  return static_cast<int>(cudaGetLastError());
}

// One launch of the guarded copy: ptrs [leaves][2] (dst, src), n (bytes)
// and start [leaves], chunks of `chunk` bytes; ok may be null.
extern "C" int mgnns_adam_select(const int64_t* ptrs, const int* n, const int* start, int leaves,
                                 int chunks, int chunk, const bool* ok, int device,
                                 cudaStream_t stream) {
  if (!launch_ok(leaves, kMaxCopies, chunks, chunk)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  CopyTable t;
  for (int i = 0; i < leaves; ++i) {
    t.dst[i] = reinterpret_cast<char*>(ptrs[2 * i]);
    t.src[i] = reinterpret_cast<const char*>(ptrs[2 * i + 1]);
    t.n[i] = n[i];
    t.start[i] = start[i];
  }
  t.leaves = leaves;
  mgnns_adam_select_kernel<<<chunks, kThreads, 0, stream>>>(t, ok, chunk);
  return static_cast<int>(cudaGetLastError());
}
