// Mark kernels: one empty kernel per mark id, launched with one thread at
// the edges of a model or engine stage while a CUDA graph is captured
// (mgnns_tpu_torch/tracing.py), so that every replay of the graph shows in
// the device trace where each stage begins and ends.
//
// Replaces no TPU kernel: it exists because a CUDA graph replay records no
// host range, so nothing else ties a replay's kernels to the step's stages.
// A mark does no work and moves no bytes; what it costs is its slot in the
// graph, 0.85 us of device time on an H100.  Its name is its id
// (mgnns_mark_<id>, extern "C", so not mangled), and a trace reader maps the
// id back to the mark's name through tracing.MARKS.

#include <cuda_runtime.h>

#define MGNNS_MARK_IDS(X)                                                   \
  X(0) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) \
  X(14) X(15) X(16) X(17) X(18) X(19) X(20) X(21) X(22) X(23) X(24) X(25)   \
  X(26) X(27) X(28) X(29) X(30) X(31) X(32) X(33) X(34) X(35) X(36) X(37)  \
  X(38) X(39) X(40) X(41) X(42) X(43) X(44) X(45) X(46) X(47) X(48) X(49)  \
  X(50) X(51) X(52) X(53) X(54) X(55) X(56) X(57) X(58) X(59) X(60) X(61)  \
  X(62) X(63)

#define MGNNS_MARK_KERNEL(N) extern "C" __global__ void mgnns_mark_##N() {}
MGNNS_MARK_IDS(MGNNS_MARK_KERNEL)
#undef MGNNS_MARK_KERNEL

// Launches mark `id` with one thread on `stream` and returns
// cudaGetLastError() (0 = launched; an id with no kernel: invalid value).
extern "C" int mgnns_launch_mark(int id, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
#define MGNNS_MARK_CASE(N)                \
  case N:                                 \
    mgnns_mark_##N<<<1, 1, 0, stream>>>(); \
    break;
  switch (id) {
    MGNNS_MARK_IDS(MGNNS_MARK_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MGNNS_MARK_CASE
  return static_cast<int>(cudaGetLastError());
}
