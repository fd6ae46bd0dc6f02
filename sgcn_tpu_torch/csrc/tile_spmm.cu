// Destination-tiled SpMM for Hopper (sm_90a): out = Â_tiles · table.
//
// Replaces the TPU kernel sgcn_tpu/ops/pallas_spmm.py::spmm_pallas.  It
// computes what that kernel computes, not how: per tile of `tb` destination
// rows, start every (row, column) sum at 0.0f, walk the tile's `emax` padded
// edges in STORED order and add w * table[src] into row `ld`.  Pad edges
// (w = 0, ld = tb-1) are not skipped — they add 0*x exactly as the
// reference does — and rows with no edges come out as exact zeros.
//
// Numerics contract (later ragged == a2a bit-identity rests on it): every
// output element is a serial chain in stored edge order, multiply and add
// rounded separately (__fmul_rn / __fadd_rn, so nvcc cannot contract them
// into an FMA), no float atomics — two launches on the same inputs are
// bit-identical, and equal to the plain PyTorch loop in ops/tile_spmm.py.
//
// What bounds it on the H100: bytes, not operations.  Each edge slot is
// 12 bytes of (src, ld, w) and 2 flops per feature column; each gathered
// table row is f*4 bytes read from HBM through the 50 MB L2 (the TPU
// kernel's premise that the whole table sits in VMEM does not apply here).
// Design against that: one block per (tile, part) — the part is grid.y
// over the stacked (k, ...) arrays, so one launch serves all k parts; the
// tile's edges are staged through shared memory in chunks so every thread
// reads indices from smem, not HBM; a warp covers up to 32 consecutive
// columns of one table row, so each gathered row is one coalesced 128-byte
// read; the (tb, 32) accumulator lives in shared memory and each (row,
// column) sum is owned by exactly one thread (row group = ld mod groups),
// which is what makes the per-element order the stored order without
// atomics.  Four edges are loaded ahead of their adds to keep several row
// reads in flight.  No wgmma, TMA or tuning yet: a right and simple first
// kernel, timed against its bound in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;    // threads per block
constexpr int kMaxTile = 256;    // largest tile height tb
constexpr int kMaxCols = 32;     // columns per pass over the edges
constexpr int kEdgeChunk = 1024; // edges staged in shared memory at once
constexpr int kAhead = 4;        // edges whose row reads are issued together

__global__ void __launch_bounds__(kThreads)
tile_spmm_f32_kernel(const int32_t* __restrict__ tsrc,
                     const int32_t* __restrict__ tld,
                     const float* __restrict__ tw,
                     const float* __restrict__ table,
                     float* __restrict__ out,
                     int emax, int tb, int n_rows, int f, int cols_log2,
                     long long idx_part_stride, long long table_part_stride,
                     long long out_part_stride) {
  __shared__ float acc[kMaxTile * kMaxCols];
  __shared__ int32_t s_src[kEdgeChunk];
  __shared__ int32_t s_ld[kEdgeChunk];
  __shared__ float s_w[kEdgeChunk];

  const int tile = blockIdx.x;
  const int part = blockIdx.y;
  const int cols = 1 << cols_log2;                 // columns per pass
  const int groups = kThreads >> cols_log2;        // row groups
  const int c = threadIdx.x & (cols - 1);
  const int rg = threadIdx.x >> cols_log2;

  const long long eoff =
      (long long)part * idx_part_stride + (long long)tile * emax;
  const int32_t* src_p = tsrc + eoff;
  const int32_t* ld_p = tld + eoff;
  const float* w_p = tw + eoff;
  const float* tab = table + (long long)part * table_part_stride;
  float* outp = out + (long long)part * out_part_stride +
                (long long)tile * tb * f;

  for (int c0 = 0; c0 < f; c0 += cols) {
    const int col = c0 + c;
    const bool col_ok = col < f;
    // rows r ≡ rg (mod groups), column c belong to this thread alone
    for (int r = rg; r < tb; r += groups) acc[r * cols + c] = 0.0f;
    for (int e0 = 0; e0 < emax; e0 += kEdgeChunk) {
      const int cnt = min(kEdgeChunk, emax - e0);
      __syncthreads();                   // previous chunk fully consumed
      for (int i = threadIdx.x; i < cnt; i += kThreads) {
        const int s = src_p[e0 + i];
        const int l = ld_p[e0 + i];
        // a bad index is a plan bug: fail the launch loudly rather than
        // read or write out of bounds
        if ((unsigned)s >= (unsigned)n_rows || (unsigned)l >= (unsigned)tb)
          __trap();
        s_src[i] = s;
        s_ld[i] = l;
        s_w[i] = w_p[e0 + i];
      }
      __syncthreads();
      int e = 0;
      for (; e + kAhead <= cnt; e += kAhead) {
        bool mine[kAhead];
        int row[kAhead];
        float w[kAhead], x[kAhead];
#pragma unroll
        for (int j = 0; j < kAhead; ++j) {
          row[j] = s_ld[e + j];
          mine[j] = (row[j] & (groups - 1)) == rg;
          w[j] = s_w[e + j];
          x[j] = (mine[j] && col_ok)
                     ? __ldg(tab + (long long)s_src[e + j] * f + col)
                     : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < kAhead; ++j) {
          if (mine[j]) {
            float* a = &acc[row[j] * cols + c];
            *a = __fadd_rn(*a, __fmul_rn(w[j], x[j]));
          }
        }
      }
      for (; e < cnt; ++e) {
        const int r = s_ld[e];
        if ((r & (groups - 1)) == rg) {
          const float x =
              col_ok ? __ldg(tab + (long long)s_src[e] * f + col) : 0.0f;
          float* a = &acc[r * cols + c];
          *a = __fadd_rn(*a, __fmul_rn(s_w[e], x));
        }
      }
    }
    if (col_ok)
      for (int r = rg; r < tb; r += groups)
        outp[(long long)r * f + col] = acc[r * cols + c];
  }
}

}  // namespace

// Launch over k stacked parts of one tile class.  Pointers are device
// pointers; the index arrays of part p start at p * idx_part_stride and
// hold t rows of emax slots; table part p is (n_rows, f) row-major at
// p * table_part_stride; out part p is (t * tb, f) row-major at
// p * out_part_stride.  Launches on `stream` of CUDA device `device`, does
// not synchronize, and returns the cudaError_t of the launch
// (cudaGetLastError()).
extern "C" int sgcn_tile_spmm_f32(const void* tsrc, const void* tld,
                                  const void* tw, const void* table,
                                  void* out, int k, int t, int emax, int tb,
                                  int n_rows, int f,
                                  long long idx_part_stride,
                                  long long table_part_stride,
                                  long long out_part_stride, int device,
                                  void* stream) {
  if (k < 1 || k > 65535 || t < 1 || emax < 1 || tb < 1 || tb > kMaxTile ||
      n_rows < 1 || f < 1)
    return (int)cudaErrorInvalidValue;
  // this library carries its own CUDA runtime: select the tensors' device
  // in it (the caller's runtime state is not shared)
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int cols_log2 = 0;
  while ((1 << cols_log2) < f && (1 << cols_log2) < kMaxCols) ++cols_log2;
  dim3 grid((unsigned)t, (unsigned)k);
  tile_spmm_f32_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)tsrc, (const int32_t*)tld, (const float*)tw,
      (const float*)table, (float*)out, emax, tb, n_rows, f, cols_log2,
      idx_part_stride, table_part_stride, out_part_stride);
  return (int)cudaGetLastError();
}

extern "C" const char* sgcn_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
