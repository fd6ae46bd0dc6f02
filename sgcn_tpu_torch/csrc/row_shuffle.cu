// Row gathers for Hopper (sm_90a): the row shuffle K6,
// out[i, :] = x[idx[i], :], below it the stacked row pack that moves
// the halo exchange and the ragged ring (K3, K4), and last its
// destination-indexed form that writes a replica step's kept rows into
// the carried receive layout.
//
// The row shuffle, out[i, :] = x[idx[i], :].
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
#include <cuda_bf16.h>
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

// ---------------------------------------------------------------------------
// Stacked row pack: out[j, :] = cast(src[flat[j], :]).
//
// Replaces the TPU exchange of sgcn_tpu/ops/pspmm.py:110-139 (XLA's
// `jnp.take` of the send rows, `lax.all_to_all` and `jnp.take` of the halo
// rows) and of pallas_spmm.py:386-410 (the ragged ring's per-round takes
// and ppermutes, then the concat).  In torch indexing that is a two-index
// gather, a transpose copy, a second gather and, on a narrow wire, two
// casts (the ring: a gather, a roll and a cast per round, then a cat).
// The k parts lie stacked in one (k·rows, w) table, so each of those
// layouts is one gather by a flat row index that the plan computes in
// numpy (flat = part·rows + row): the a2a receive buffer
// `recv[q, p·S + t] = h[p, send_idx[p, q, t]]` in one launch, the halo
// rows of that buffer in another, the ring's round-major concat in one.
// The cast to the wire's dtype happens as the row is stored.
//
// What bounds it on the H100: bytes.  It reads each output row's source
// row once and writes the output once: the flagship a2a exchange
// (k²·S = 1,128,064 rows of 128 float32) writes 578 MB and reads at most
// the 87 MB of h, ≈ 0.2 ms at 3.35 TB/s.  torch's index kernels pay per
// element, not per byte; here each thread moves one 16-byte vector (4
// float32 or 8 bf16) wherever a row is a whole number of vectors and both
// bases are aligned, else one 4- or 2-byte word (float32 → bf16 reads 16
// bytes and stores 8).  The threads of a block walk the output in
// row-major order, so neighbouring threads read neighbouring words of one
// source row and write neighbouring words of the output: a 128-wide
// float32 row is one warp, a narrow row (the GAT scalar `u`, one word)
// shares a warp with its neighbours.  No shared memory, no atomics.  A
// source index out of range traps.

// The float → bf16 rounding torch's CUDA cast uses (c10::BFloat16's
// constructor on sm_80+ is __float2bfloat16): nearest even, the same NaN.
__device__ __forceinline__ unsigned int f32_to_bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// one unit of the stored dtype: Raw copies one word U unchanged (same
// dtype); Narrow4/Narrow1 round 4 floats (one float4) or 1 float to bf16;
// Widen4/Widen1 widen 4 bf16 (one uint2) or 1 bf16 to float, exactly
struct Narrow4 {
  using In = float4;
  using Out = uint2;
  __device__ static Out cvt(In v) {
    return make_uint2(f32_to_bf16_bits(v.x) | (f32_to_bf16_bits(v.y) << 16),
                      f32_to_bf16_bits(v.z) | (f32_to_bf16_bits(v.w) << 16));
  }
};
struct Narrow1 {
  using In = float;
  using Out = unsigned short;
  __device__ static Out cvt(In v) { return (Out)f32_to_bf16_bits(v); }
};
struct Widen4 {
  using In = uint2;
  using Out = float4;
  __device__ static Out cvt(In v) {
    return make_float4(__uint_as_float(v.x << 16),
                       __uint_as_float(v.x & 0xffff0000u),
                       __uint_as_float(v.y << 16),
                       __uint_as_float(v.y & 0xffff0000u));
  }
};
struct Widen1 {
  using In = unsigned short;
  using Out = float;
  __device__ static Out cvt(In v) { return __uint_as_float((unsigned)v << 16); }
};
template <typename U>
struct Raw {
  using In = U;
  using Out = U;
  __device__ static Out cvt(In v) { return v; }
};

bool aligned(const void* p, int bytes) {
  return (uintptr_t)p % (uintptr_t)bytes == 0;
}

// units: the number of units moved, upr units per row (< 2^31 both).
// kInto: row j goes to output row dst[j] of an existing buffer of
// n_out_rows rows (the destination-indexed pack below), else to row j.
template <typename C, bool kInto>
__global__ void __launch_bounds__(kThreads)
row_pack_kernel(const typename C::In* __restrict__ src,
                const int32_t* __restrict__ flat,
                const int32_t* __restrict__ dst,
                typename C::Out* __restrict__ out, unsigned units,
                unsigned upr, unsigned n_src_rows, unsigned n_out_rows) {
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= units) return;
  const unsigned row = i / upr;
  const unsigned col = i - row * upr;
  const int s = __ldg(flat + row);
  if ((unsigned)s >= n_src_rows) __trap();
  const typename C::Out v = C::cvt(__ldg(src + (unsigned long long)s * upr
                                         + col));
  if (kInto) {
    const int d = __ldg(dst + row);
    if ((unsigned)d >= n_out_rows) __trap();
    out[(unsigned long long)d * upr + col] = v;
  } else {
    out[i] = v;
  }
}

template <typename C>
int launch_pack(const void* src, const void* flat, const void* dst,
                void* out, long long units, long long upr, int n_src_rows,
                int n_out_rows, cudaStream_t stream) {
  if (units > 0x7fffffffLL || upr > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((units + kThreads - 1) / kThreads);
  if (dst != nullptr)
    row_pack_kernel<C, true><<<blocks, kThreads, 0, stream>>>(
        (const typename C::In*)src, (const int32_t*)flat,
        (const int32_t*)dst, (typename C::Out*)out, (unsigned)units,
        (unsigned)upr, (unsigned)n_src_rows, (unsigned)n_out_rows);
  else
    row_pack_kernel<C, false><<<blocks, kThreads, 0, stream>>>(
        (const typename C::In*)src, (const int32_t*)flat, nullptr,
        (typename C::Out*)out, (unsigned)units, (unsigned)upr,
        (unsigned)n_src_rows, 0u);
  return (int)cudaGetLastError();
}

// The pack's dtype dispatch: n rows of w elements, row j from src row
// flat[j] (dst == nullptr: to out row j; else to out row dst[j] of
// n_out rows), the widest unit the row width and both bases allow.
int pack_rows(const void* src, const void* flat, const void* dst, void* out,
              int n, int n_src, int n_out, int w, int in_type, int out_type,
              cudaStream_t st) {
  const long long rows = n;
  if (in_type == out_type) {
    // raw words: the widest of 16, 4 and 2 bytes that divides the row and
    // both bases
    const long long bytes = (long long)w * (in_type == 0 ? 4 : 2);
    if (bytes % 16 == 0 && aligned(src, 16) && aligned(out, 16))
      return launch_pack<Raw<uint4>>(src, flat, dst, out,
                                     rows * (bytes / 16), bytes / 16, n_src,
                                     n_out, st);
    if (bytes % 4 == 0 && aligned(src, 4) && aligned(out, 4))
      return launch_pack<Raw<uint32_t>>(src, flat, dst, out,
                                        rows * (bytes / 4), bytes / 4, n_src,
                                        n_out, st);
    return launch_pack<Raw<unsigned short>>(src, flat, dst, out,
                                            rows * (bytes / 2), bytes / 2,
                                            n_src, n_out, st);
  }
  if (in_type == 0) {  // float32 -> bfloat16
    if (w % 4 == 0 && aligned(src, 16) && aligned(out, 8))
      return launch_pack<Narrow4>(src, flat, dst, out, rows * (w / 4), w / 4,
                                  n_src, n_out, st);
    return launch_pack<Narrow1>(src, flat, dst, out, rows * w, w, n_src,
                                n_out, st);
  }
  if (w % 4 == 0 && aligned(src, 8) && aligned(out, 16))  // bf16 -> f32
    return launch_pack<Widen4>(src, flat, dst, out, rows * (w / 4), w / 4,
                               n_src, n_out, st);
  return launch_pack<Widen1>(src, flat, dst, out, rows * w, w, n_src, n_out,
                             st);
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

// out (n_out, w) row-major in dtype out_type = src (n_src, w) row-major in
// dtype in_type, row j taken from row flat[j] (int32) and cast: dtypes 0
// float32, 1 bfloat16; float32 -> bfloat16 rounds as torch's CUDA cast
// does, bfloat16 -> float32 widens exactly, the same dtype copies bits.
// Device pointers; launches on `stream` of CUDA device `device`, does not
// synchronize, returns the cudaError_t of the launch.
extern "C" int sgcn_row_pack(const void* src, const void* flat, void* out,
                             int n_out, int n_src, int w, int in_type,
                             int out_type, int device, void* stream) {
  if (n_out < 1 || n_src < 1 || w < 1 || in_type < 0 || in_type > 1 ||
      out_type < 0 || out_type > 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return pack_rows(src, flat, nullptr, out, n_out, n_src, n_out, w, in_type,
                   out_type, (cudaStream_t)stream);
}

// ---------------------------------------------------------------------------
// Destination-indexed row pack: out[dst[j], :] = cast(src[flat[j], :]) for
// j < n, into a buffer the caller owns; the other rows of out keep what
// they hold.
//
// Replaces the TPU exchange of a replica step: the shrunken all_to_all of
// the kept rows into the halo table and the replica slots' overwrite from
// the carry (sgcn_tpu/ops/pspmm.py:559-579, `_replica_halo`'s
// `.at[rep_slots].set`; the ring's per-round `.at[nrep_rhalo_dst].set`,
// :695-709, and the composed mode's carry scatters, :836-971).  Here the
// replica carry IS the receive layout of the exact exchange, and a replica
// step rewrites only its kept slots: each kept slot is one (flat, dst)
// pair of the plan (real slots only, no pads), so the replica slots keep
// what the last sync wrote without a copy.  The same kernel as the pack
// above, the output row taken from dst; an out-of-range source or
// destination traps.  Every destination is distinct, so the order of the
// stores does not matter and the result is bit-identical to the plain
// `index_copy_` of the gathered rows.
//
// What bounds it on the H100: bytes, counted as for the pack above.  Each
// distinct source row is read once, the two int32 index lists once, and
// each named row written once: u·w·in + 8·n + n·w·out, u the distinct
// entries of flat.  A boundary row goes to several parts, so u < n: on the
// flagship a2a (f = 128 float32) the kept slots are the kept share of the
// exact exchange's 578 MB of receive slots, read from far fewer rows of h —
// the wire rows the replicas take off are rows it does not write.
extern "C" int sgcn_row_pack_into(const void* src, const void* flat,
                                  const void* dst, void* out, int n,
                                  int n_src, int n_out, int w, int in_type,
                                  int out_type, int device, void* stream) {
  if (n < 1 || n_src < 1 || n_out < 1 || w < 1 || in_type < 0 ||
      in_type > 1 || out_type < 0 || out_type > 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return pack_rows(src, flat, dst, out, n, n_src, n_out, w, in_type,
                   out_type, (cudaStream_t)stream);
}
