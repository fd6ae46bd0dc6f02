// Destination-tiled SpMM for Hopper (sm_90a): out = Â_tiles · table.
//
// Replaces the TPU kernel sgcn_tpu/ops/pallas_spmm.py::spmm_pallas (K1),
// its per-degree-class dispatch spmm_pallas_classes (K2) and, through the
// int8-mask entry point, that kernel's use as the GAT attention pass
// gat_pallas_pass (K5).  It computes what those compute, not how: for every
// tile of `tb` destination rows, every (row, column) sum starts at 0.0f and
// adds w * table[src] over the tile's padded edge slots in STORED order.
// The table is float32 or bfloat16: spmm_pallas keeps its table in its own
// dtype and upcasts each row as it reads it (pallas_spmm.py:192), and so do
// the bf16 entry points here — each bf16 value widens exactly to float32,
// then enters the same float32 chain; the output is float32 either way.
// Pad slots (w = 0, ld = tb-1) count as in the reference — each adds 0*x,
// NaN where x is not finite — and rows with no slots come out as exact
// zeros.
//
// Numerics contract (the ragged == a2a bit-identity rests on it): every
// output element is a serial chain in stored slot order, multiply and add
// rounded separately (__fmul_rn / __fadd_rn, so nvcc cannot contract them
// into an FMA), no float atomics — two launches on the same inputs are
// bit-identical, and equal to the plain PyTorch loop in ops/tile_spmm.py.
//
// What bounds it on the H100: bytes.  A slot is 12 bytes of (src, ld, w)
// (9 with int8 masks) and 2 flops per column; each gathered table row is
// f*4 bytes (f*2 for a bf16 table) read through the 50 MB L2 from HBM (the
// TPU kernel's premise, a table resident in VMEM, does not carry over).
// The design:
//
//  * One launch per tile FAMILY (all its degree classes): the class
//    structure (first tile, first slot, emax per class) rides in a small
//    by-value table, and the kernel writes straight into the family's
//    (k, ΣT_c·tb, f) output — no per-class launches and no concatenation.
//  * Each destination row reads only its own slots.  Tiles are cut from
//    dst-sorted edge lists, so `ld` does not decrease along a tile's slots
//    and row r's slots are [lower_bound(r), lower_bound(r+1)).  A block
//    covers a run of rows of one tile: two warps find the run's first and
//    last slot by a 32-way search, then the block scans the run's slots
//    once into row pointers in shared memory.  That scan checks the premise
//    on every slot and traps on a decreasing `ld` (the plan already checks
//    it in numpy; the trap is the last resort, as for an index out of range).
//  * Lanes own columns and the sums stay in registers.  A group of G lanes
//    (a power of two, G <= 32) walks one row's slots: the group stages a
//    batch of slots' (src, w) with coalesced loads, broadcasts each with
//    __shfl_sync, and every lane gathers its own columns of that slot's
//    table row — four columns per lane in one vector load when f % 4 == 0
//    and the rows are whole vectors (float4, 16 bytes; for a bf16 table
//    4 × bf16, 8 bytes; one warp = one 128-column row), else one value per
//    lane, lane-strided.  Narrow widths pack 32/G rows into a warp; at f = 1
//    every lane runs its own row's chain.  Several slots' row loads are
//    issued before their adds.  Each output row is written once.
//  * Pads come in long runs of weight-0 slots that all read one source row
//    (the tile's pads on its last row; the edge list's own pads on the last
//    real row of the last tile), which one lane group would walk alone.  A
//    chain that starts at +0 never holds -0 (round to nearest gives -0 only
//    for -0 + -0), so adding a weight-0 product, ±0 or NaN, leaves the sum
//    as it is unless the product is NaN — the same NaN for every slot of a
//    run with one source.  So a row adds such a run's product once: the
//    serial chain's bits, NaN included.  The block finds its trailing
//    weight-0 run while it scans its slots; a run with mixed sources is
//    walked slot by slot.
//  * ≈ 170k rows per flagship pass give thousands of blocks: many waves.
//  * No wgmma and no TMA: there is nothing to multiply on the tensor cores,
//    and TMA has no per-row gather.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // threads per block
constexpr int kMaxTile = 256;     // largest tile height tb
constexpr int kMaxClasses = 32;   // degree classes in one family launch

// The family's static class structure: class c owns tiles
// [first_tile[c], first_tile[c+1]), each of emax[c] slots, starting at slot
// slot_off[c] of every part.
struct ClassTable {
  int n;
  int first_tile[kMaxClasses + 1];
  int emax[kMaxClasses];
  long long slot_off[kMaxClasses];
};

// First index i in [0, n) with a[i] >= key (n if none) of a non-decreasing
// a, by one whole warp: each step probes 32 evenly spaced points.
__device__ int warp_lower_bound(const int32_t* __restrict__ a, int n, int key,
                                int lane) {
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) >> 5;
    const int i = lo + (lane + 1) * step - 1;
    const bool below = i < hi && a[i] < key;
    const int c = __popc(__ballot_sync(0xffffffffu, below));
    const int nlo = lo + c * step;
    hi = min(hi, nlo + step - 1);  // probe c, where it exists, is >= key
    lo = min(nlo, hi);
  }
  const bool below = lo + lane < hi && a[lo + lane] < key;
  return lo + __popc(__ballot_sync(0xffffffffu, below));
}

// A bf16 value's exact float32 value (what __bfloat162float returns): its
// 16 bits are the high half of the float's.
__device__ __forceinline__ float bf16_bits_to_float(unsigned int bits) {
  return __uint_as_float(bits << 16);
}

// VEC columns of a table row, widened to float: T = float (one float4 or
// one float) or __nv_bfloat16 (one 8-byte vector of 4 × bf16, or one bf16).
template <typename T, int VEC>
__device__ __forceinline__ void load_cols(const T* p, float (&x)[VEC]) {
  if constexpr (sizeof(T) == 4) {
    if constexpr (VEC == 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p));
      x[0] = v.x;
      x[1] = v.y;
      x[2] = v.z;
      x[3] = v.w;
    } else {
      x[0] = __ldg(reinterpret_cast<const float*>(p));
    }
  } else {
    static_assert(sizeof(T) == 2, "tables are float or bf16");
    if constexpr (VEC == 4) {
      // little-endian: column c + 2j is the low half of word j
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      x[0] = bf16_bits_to_float(v.x & 0xffffu);
      x[1] = bf16_bits_to_float(v.x >> 16);
      x[2] = bf16_bits_to_float(v.y & 0xffffu);
      x[3] = bf16_bits_to_float(v.y >> 16);
    } else {
      x[0] = bf16_bits_to_float(
          __ldg(reinterpret_cast<const unsigned short*>(p)));
    }
  }
}

template <int VEC>
__device__ __forceinline__ void store_cols(float* p, const float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    p[0] = x[0];
  }
}

// W: the stored weight type, float (Â's values, K1) or int8_t (the GAT
// passes' 0/1 masks, K5), converted to float exactly as it is staged.
// T: the table type, float or __nv_bfloat16, widened to float exactly as
// it is loaded.  VEC: columns per lane load (4 or 1).  G: lanes per row.
// NV: vectors per lane, so one walk over a row's slots covers G*NV*VEC
// columns.
template <typename W, typename T, int VEC, int G, int NV>
__global__ void __launch_bounds__(kThreads)
tile_spmm_kernel(const int32_t* __restrict__ tsrc,
                 const int32_t* __restrict__ tld, const W* __restrict__ tw,
                 const T* __restrict__ table, float* __restrict__ out,
                 const ClassTable ct, int tb, int rows_per_block,
                 int chunks_per_tile, int n_rows, int f,
                 long long idx_part_stride, long long table_part_stride,
                 long long out_part_stride) {
  constexpr int kGroups = kThreads / G;            // rows walked at once
  constexpr int kBatch = G >= 8 ? G : 8;           // slots staged per batch
  constexpr int kPer = kBatch / G;                 // ... by each lane
  constexpr int kWide = 32 / (NV * VEC);
  constexpr int kAhead = kWide < 2 ? 2 : (kWide > kBatch ? kBatch : kWide);
  constexpr int kCols = G * NV * VEC;              // columns per walk

  __shared__ int s_start[kMaxTile + 1];
  __shared__ int s_bound[2];
  __shared__ int s_last_nz;   // the block's last slot of nonzero weight
  __shared__ int s_mixed;     // its trailing weight-0 run reads > 1 row

  const int part = blockIdx.y;
  const int tile = blockIdx.x / chunks_per_tile;
  const int r0 = (blockIdx.x - tile * chunks_per_tile) * rows_per_block;
  const int nrows = min(rows_per_block, tb - r0);

  int emax = 0, t0 = 0;
  long long off = 0;
#pragma unroll
  for (int c = 0; c < kMaxClasses; ++c)
    if (c < ct.n && tile >= ct.first_tile[c]) {
      emax = ct.emax[c];
      t0 = ct.first_tile[c];
      off = ct.slot_off[c];
    }
  const long long base =
      (long long)part * idx_part_stride + off + (long long)(tile - t0) * emax;
  const int32_t* src_p = tsrc + base;
  const int32_t* ld_p = tld + base;
  const W* w_p = tw + base;
  const T* tab = table + (long long)part * table_part_stride;
  float* outp = out + (long long)part * out_part_stride +
                ((long long)tile * tb + r0) * f;

  // the block's slots [lo, hi): from row r0's first to row r0+nrows's first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    s_last_nz = -1;
    s_mixed = 0;
  }
  if (warp < 2) {
    const int key = r0 + warp * nrows;
    const int at = key == 0 ? 0
                   : key >= tb ? emax
                               : warp_lower_bound(ld_p, emax, key, lane);
    if (lane == 0) s_bound[warp] = at;
  }
  __syncthreads();
  const int lo = s_bound[0], hi = s_bound[1];
  if (hi < lo) __trap();
  // row pointers: row r's slots are [s_start[r], s_start[r+1]).  Every slot
  // of [lo, hi) is checked here, and the blocks' ranges tile [0, emax), so
  // a tile whose ld decreases, or leaves [0, tb), traps rather than drop or
  // misplace edges
  int last_nz = -1;
  for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
    const int v = ld_p[i] - r0;
    const int prev = i == lo ? -1 : ld_p[i - 1] - r0;
    if (v < prev || v < 0 || v >= nrows) __trap();
    for (int r = prev + 1; r <= v; ++r) s_start[r] = i;
    if (i == hi - 1)
      for (int r = v + 1; r <= nrows; ++r) s_start[r] = hi;
    if (w_p[i] != W(0)) last_nz = i;
  }
  if (lo == hi)
    for (int r = threadIdx.x; r <= nrows; r += kThreads) s_start[r] = lo;
  if (last_nz >= 0) atomicMax(&s_last_nz, last_nz);
  __syncthreads();

  // the block's trailing weight-0 run [z, hi): one source row, or walked
  const int z = max(lo, s_last_nz + 1);
  if (z < hi) {
    const int src0 = src_p[z];
    for (int i = z + threadIdx.x; i < hi; i += kThreads)
      if (src_p[i] != src0) s_mixed = 1;
    __syncthreads();
  }
  const int run = z < hi && !s_mixed ? z : hi;

  const int li = threadIdx.x & (G - 1);
  const unsigned gmask = (0xffffffffu >> (32 - G)) << (lane & ~(G - 1));
  for (int r = threadIdx.x / G; r < nrows; r += kGroups) {
    const int s = s_start[r], end = s_start[r + 1];
    // the row's part of the run, if any, adds one product after its walk
    const bool in_run = end > max(s, run);
    const int e = in_run ? max(s, run) : end;
    float* orow = outp + (long long)r * f;
    for (int c0 = 0; c0 < f; c0 += kCols) {
      float acc[NV][VEC];
#pragma unroll
      for (int v = 0; v < NV; ++v)
#pragma unroll
        for (int q = 0; q < VEC; ++q) acc[v][q] = 0.0f;
      for (int b = s; b < e; b += kBatch) {
        const int cnt = min(kBatch, e - b);
        int my_src[kPer];
        float my_w[kPer];
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          const int j = u * G + li;
          my_src[u] = 0;
          my_w[u] = 0.0f;
          if (j < cnt) {
            my_src[u] = src_p[b + j];
            my_w[u] = static_cast<float>(w_p[b + j]);
            // a bad index is a plan bug: fail the launch loudly rather
            // than read out of bounds
            if ((unsigned)my_src[u] >= (unsigned)n_rows) __trap();
          }
        }
#pragma unroll
        for (int j0 = 0; j0 < kBatch; j0 += kAhead) {
          if (j0 >= cnt) break;  // cnt is the same for the whole group
          float x[kAhead][NV][VEC];
          float wj[kAhead];
#pragma unroll
          for (int a = 0; a < kAhead; ++a) {
            const int j = j0 + a;
            const int sj = __shfl_sync(gmask, my_src[j / G], j % G, G);
            wj[a] = __shfl_sync(gmask, my_w[j / G], j % G, G);
            const T* row = tab + (long long)sj * f + c0;
#pragma unroll
            for (int v = 0; v < NV; ++v) {
              const int col = (v * G + li) * VEC;
              if (j < cnt && c0 + col < f) {
                load_cols<T, VEC>(row + col, x[a][v]);
              } else {
#pragma unroll
                for (int q = 0; q < VEC; ++q) x[a][v][q] = 0.0f;
              }
            }
          }
#pragma unroll
          for (int a = 0; a < kAhead; ++a)
            if (j0 + a < cnt)
#pragma unroll
              for (int v = 0; v < NV; ++v)
#pragma unroll
                for (int q = 0; q < VEC; ++q)
                  acc[v][q] =
                      __fadd_rn(acc[v][q], __fmul_rn(wj[a], x[a][v][q]));
        }
      }
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int col = c0 + (v * G + li) * VEC;
        if (col >= f) continue;
        if (in_run) {
          const int sv = src_p[run];
          if ((unsigned)sv >= (unsigned)n_rows) __trap();
          float x[VEC];
          load_cols<T, VEC>(tab + (long long)sv * f + col, x);
          const float w = static_cast<float>(w_p[run]);
#pragma unroll
          for (int q = 0; q < VEC; ++q)
            acc[v][q] = __fadd_rn(acc[v][q], __fmul_rn(w, x[q]));
        }
        store_cols<VEC>(orow + col, acc[v]);
      }
    }
  }
}

struct Args {
  const int32_t* tsrc;
  const int32_t* tld;
  const void* tw;
  const void* table;
  float* out;
  ClassTable ct;
  int tb, n_rows, f;
  long long idx_part_stride, table_part_stride, out_part_stride;
};

template <typename W, typename T, int VEC, int G, int NV>
int launch(const Args& a, int k, int t_all, cudaStream_t stream) {
  constexpr int kGroups = kThreads / G;
  // at least 32 rows per block, so that its two searches and the scan are
  // shared by several rows; never more than one tile
  const int rows = min(a.tb, kGroups > 32 ? kGroups : 32);
  const int chunks = (a.tb + rows - 1) / rows;
  const long long blocks = (long long)t_all * chunks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks, (unsigned)k);
  tile_spmm_kernel<W, T, VEC, G, NV><<<grid, kThreads, 0, stream>>>(
      a.tsrc, a.tld, static_cast<const W*>(a.tw),
      static_cast<const T*>(a.table), a.out, a.ct, a.tb,
      rows, chunks, a.n_rows, a.f, a.idx_part_stride, a.table_part_stride,
      a.out_part_stride);
  return (int)cudaGetLastError();
}

template <typename W, typename T>
int launch_family(const void* tsrc, const void* tld, const void* tw,
                  const void* table, void* out, int k, int n_classes,
                  const int* first_tile, const int* emax,
                  const long long* slot_off, int tb, int n_rows, int f,
                  int vec, long long idx_part_stride,
                  long long table_part_stride, long long out_part_stride,
                  int device, void* stream) {
  if (k < 1 || k > 65535 || n_classes < 1 || n_classes > kMaxClasses ||
      tb < 1 || tb > kMaxTile || n_rows < 1 || f < 1 ||
      (vec != 1 && vec != 4))
    return (int)cudaErrorInvalidValue;
  // the classes must lie one after another: tiles and slots
  Args a{};
  a.ct.n = n_classes;
  long long slots = 0;
  if (first_tile[0] != 0) return (int)cudaErrorInvalidValue;
  for (int c = 0; c < n_classes; ++c) {
    const int tiles = first_tile[c + 1] - first_tile[c];
    if (tiles < 1 || emax[c] < 1 || slot_off[c] != slots)
      return (int)cudaErrorInvalidValue;
    a.ct.first_tile[c] = first_tile[c];
    a.ct.emax[c] = emax[c];
    a.ct.slot_off[c] = slot_off[c];
    slots += (long long)tiles * emax[c];
  }
  a.ct.first_tile[n_classes] = first_tile[n_classes];
  // vector loads need whole 4-column vectors per row: f % 4 == 0, a base
  // aligned to 4 * sizeof(T) bytes and a part stride of whole vectors
  if (vec == 4 && (f % 4 != 0 || (uintptr_t)table % (4 * sizeof(T)) != 0 ||
                   table_part_stride % 4 != 0))
    return (int)cudaErrorMisalignedAddress;
  // this library carries its own CUDA runtime: select the tensors' device
  // in it (the caller's runtime state is not shared)
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  a.tsrc = (const int32_t*)tsrc;
  a.tld = (const int32_t*)tld;
  a.tw = tw;
  a.table = table;
  a.out = (float*)out;
  a.tb = tb;
  a.n_rows = n_rows;
  a.f = f;
  a.idx_part_stride = idx_part_stride;
  a.table_part_stride = table_part_stride;
  a.out_part_stride = out_part_stride;
  const int t_all = first_tile[n_classes];
  cudaStream_t st = (cudaStream_t)stream;
  // lanes per row: enough vectors for the row, up to a warp; past 32
  // vectors a lane takes 2 or 4 (more columns walk the slots again)
  const int nvec = f / vec + (f % vec != 0);
  int g = 1;
  while (g < nvec && g < 32) g <<= 1;
  const int nv = nvec <= 32 ? 1 : nvec <= 64 ? 2 : 4;
  if (vec == 4) {
    if (nv == 1 && g <= 8) return launch<W, T, 4, 8, 1>(a, k, t_all, st);
    if (nv == 1 && g == 16) return launch<W, T, 4, 16, 1>(a, k, t_all, st);
    if (nv == 1) return launch<W, T, 4, 32, 1>(a, k, t_all, st);
    if (nv == 2) return launch<W, T, 4, 32, 2>(a, k, t_all, st);
    return launch<W, T, 4, 32, 4>(a, k, t_all, st);
  }
  switch (nv == 1 ? g : 32 * nv) {
    case 1: return launch<W, T, 1, 1, 1>(a, k, t_all, st);
    case 2: return launch<W, T, 1, 2, 1>(a, k, t_all, st);
    case 4: return launch<W, T, 1, 4, 1>(a, k, t_all, st);
    case 8: return launch<W, T, 1, 8, 1>(a, k, t_all, st);
    case 16: return launch<W, T, 1, 16, 1>(a, k, t_all, st);
    case 32: return launch<W, T, 1, 32, 1>(a, k, t_all, st);
    case 64: return launch<W, T, 1, 32, 2>(a, k, t_all, st);
    default: return launch<W, T, 1, 32, 4>(a, k, t_all, st);
  }
}

}  // namespace

// One launch over a whole tile family: k stacked parts of the flat
// (k, ΣT_c·Emax_c) slot arrays the plan ships.  Pointers tsrc/tld/tw/table/
// out are device pointers; the slot arrays of part p start at
// p * idx_part_stride; class c (of n_classes <= 32) owns tiles
// [first_tile[c], first_tile[c+1]) of emax[c] slots each, from slot
// slot_off[c] of a part (first_tile, emax, slot_off: host arrays of
// n_classes + 1, n_classes, n_classes entries).  Table part p is (n_rows, f)
// row-major at p * table_part_stride; out part p is (first_tile[n] * tb, f)
// row-major at p * out_part_stride.  vec = 4 reads 4 columns per lane in
// one load (f % 4 == 0, table and part stride aligned to 4 columns), vec = 1
// one column.
// Launches on `stream` of CUDA device `device`, does not synchronize, and
// returns the cudaError_t of the launch (cudaGetLastError()).  `tw` is
// float32 (K1: Â's values), the table float32.
extern "C" int sgcn_tile_spmm_family_f32(
    const void* tsrc, const void* tld, const void* tw, const void* table,
    void* out, int k, int n_classes, const int* first_tile, const int* emax,
    const long long* slot_off, int tb, int n_rows, int f, int vec,
    long long idx_part_stride, long long table_part_stride,
    long long out_part_stride, int device, void* stream) {
  return launch_family<float, float>(
      tsrc, tld, tw, table, out, k, n_classes, first_tile, emax, slot_off,
      tb, n_rows, f, vec, idx_part_stride, table_part_stride, out_part_stride,
      device, stream);
}

// The same launch with int8 0/1 weights (K5, the GAT attention passes:
// sgcn_tpu/ops/pallas_spmm.py::gat_pallas_pass, whose mask tiles the plan
// ships as int8).  The reference upcasts the whole mask array to f32 before
// its kernel; here each weight converts as the group stages it, so no
// (k, ΣT_c·Emax_c) f32 copy is made per pass and a slot is 9 bytes, not 12.
// Per element the arithmetic is K1's on the upcast mask, bit for bit.
extern "C" int sgcn_tile_spmm_family_mask_f32(
    const void* tsrc, const void* tld, const void* tw, const void* table,
    void* out, int k, int n_classes, const int* first_tile, const int* emax,
    const long long* slot_off, int tb, int n_rows, int f, int vec,
    long long idx_part_stride, long long table_part_stride,
    long long out_part_stride, int device, void* stream) {
  return launch_family<int8_t, float>(
      tsrc, tld, tw, table, out, k, n_classes, first_tile, emax, slot_off,
      tb, n_rows, f, vec, idx_part_stride, table_part_stride, out_part_stride,
      device, stream);
}

// The two launches above on a bfloat16 table (`table` holds __nv_bfloat16,
// the part stride counts bf16 elements): spmm_pallas's bf16 flavor, which
// the reference feeds under compute_dtype='bfloat16' (K1, K3, K4), and the
// GAT passes over bf16 attention tables (K5).  Each value is widened to
// float32 exactly as it is loaded; the chain, the pads and the float32
// output are the float table's.
extern "C" int sgcn_tile_spmm_family_bf16(
    const void* tsrc, const void* tld, const void* tw, const void* table,
    void* out, int k, int n_classes, const int* first_tile, const int* emax,
    const long long* slot_off, int tb, int n_rows, int f, int vec,
    long long idx_part_stride, long long table_part_stride,
    long long out_part_stride, int device, void* stream) {
  return launch_family<float, __nv_bfloat16>(
      tsrc, tld, tw, table, out, k, n_classes, first_tile, emax, slot_off,
      tb, n_rows, f, vec, idx_part_stride, table_part_stride, out_part_stride,
      device, stream);
}

extern "C" int sgcn_tile_spmm_family_mask_bf16(
    const void* tsrc, const void* tld, const void* tw, const void* table,
    void* out, int k, int n_classes, const int* first_tile, const int* emax,
    const long long* slot_off, int tb, int n_rows, int f, int vec,
    long long idx_part_stride, long long table_part_stride,
    long long out_part_stride, int device, void* stream) {
  return launch_family<int8_t, __nv_bfloat16>(
      tsrc, tld, tw, table, out, k, n_classes, first_tile, emax, slot_off,
      tb, n_rows, f, vec, idx_part_stride, table_part_stride, out_part_stride,
      device, stream);
}

extern "C" const char* sgcn_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
