// Row shuffle for Hopper (sm_90a): out[i, :] = x[idx[i], :].
//
// Replaces the TPU kernel scripts/spmm_micro.py::tga_kernel (K6, the
// micro-benchmark probe: a `take_along_axis` over an (S, f) f32 chunk held
// in VMEM, driven by an (S, 1) int32 index).  It computes what that kernel
// computes: each output row is a copy of the input row its index names, so
// the result is bit-identical to the plain PyTorch gather in
// ops/row_shuffle.py, whatever the launch.
//
// What bounds it on the H100: bytes.  It does no arithmetic; it reads each
// referenced row once and writes each output row once: 2·S·f·4 bytes, at
// S = 2048 and f = 128 about 2.1 MB, or 0.63 µs at 3.35 TB/s — below the
// launch latency, so at the probe's size the launch is the cost.  The TPU
// premise, a chunk resident in VMEM, does not carry over: the 1 MiB chunk
// is more than a block's 227 KB of shared memory but well inside the 50 MB
// L2.  So the design is a plain row gather through L2: one warp per output
// row, neighbouring lanes on neighbouring columns; 16-byte loads and stores
// (float4) when f is a multiple of 4 and both bases are 16-byte aligned,
// otherwise one float per lane.  No shared memory, no atomics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;            // 8 warps, 8 output rows per block
constexpr int kRowsPerBlock = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
row_shuffle_f32_kernel(const float* __restrict__ x,
                       const int32_t* __restrict__ idx,
                       float* __restrict__ out, int s, int n_rows, int f,
                       int vec) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= s) return;
  const int src = idx[row];
  // an index outside the chunk is a caller bug: fail the launch loudly
  // rather than read out of bounds
  if ((unsigned)src >= (unsigned)n_rows) __trap();
  const float* in = x + (long long)src * f;
  float* o = out + (long long)row * f;
  if (vec) {
    const float4* in4 = reinterpret_cast<const float4*>(in);
    float4* o4 = reinterpret_cast<float4*>(o);
    for (int j = lane; j < (f >> 2); j += 32) o4[j] = __ldg(in4 + j);
  } else {
    for (int j = lane; j < f; j += 32) o[j] = __ldg(in + j);
  }
}

}  // namespace

// out (s, f) row-major = x (n_rows, f) row-major gathered by idx (s,)
// int32.  Device pointers; launches on `stream` of CUDA device `device`,
// does not synchronize, returns the cudaError_t of the launch.
extern "C" int sgcn_row_shuffle_f32(const void* x, const void* idx,
                                    void* out, int s, int n_rows, int f,
                                    int device, void* stream) {
  if (s < 1 || n_rows < 1 || f < 1) return (int)cudaErrorInvalidValue;
  // this library carries its own CUDA runtime: select the tensors' device
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int vec = (f % 4 == 0) && ((uintptr_t)x % 16 == 0) &&
                  ((uintptr_t)out % 16 == 0);
  const unsigned blocks = (unsigned)((s + kRowsPerBlock - 1) / kRowsPerBlock);
  row_shuffle_f32_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const int32_t*)idx, (float*)out, s, n_rows, f, vec);
  return (int)cudaGetLastError();
}

extern "C" const char* sgcn_row_shuffle_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
