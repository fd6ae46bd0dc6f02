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
//  * A GCN aggregation (K3, _pspmm_pallas_once, and K4, its ring flavor:
//    pallas_spmm.py:413-527) is two families and a sum: the local tiles
//    over h, the halo tiles over the exchange's receive buffer (or the
//    ring's concat), read in place, then (local + remote) rounded once to
//    h's dtype.  The fused entry runs all of it in one launch: the two
//    families share their tile classes, so a block takes the same rows of
//    the same tile in both, walks each row's local chain and halo chain
//    exactly as above, adds them in one float32 add and stores the row
//    once in h's dtype, for the b owned rows only — no two (k, T·tb, f)
//    float32 outputs, slices, add or cast in device memory.  Its bound is
//    the two families' slot and row bytes plus b·f values written.
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

// The block's rows [r0, r0 + nrows) of one tile of one family: finds
// their slots [lo, hi) by two warp searches, scans them once into row
// pointers (row r's slots are [s_start[r], s_start[r+1])) and finds the
// block's trailing weight-0 run.  Returns the run's first slot when the run
// reads one source row (every row adds its part of the run's product once),
// else hi.  Every thread of the block calls it; it synchronizes the block.
// s_start holds kMaxTile + 1 ints, s_misc 4 (bounds, last nonzero, mixed).
template <typename W>
__device__ int scan_block_slots(const int32_t* __restrict__ src_p,
                                const int32_t* __restrict__ ld_p,
                                const W* __restrict__ w_p, int emax, int tb,
                                int r0, int nrows, int* s_start, int* s_misc) {
  int* s_bound = s_misc;        // [2]
  int* s_last_nz = s_misc + 2;  // the block's last slot of nonzero weight
  int* s_mixed = s_misc + 3;    // its trailing weight-0 run reads > 1 row
  // the block's slots [lo, hi): from row r0's first to row r0+nrows's first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    *s_last_nz = -1;
    *s_mixed = 0;
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
  // row pointers.  Every slot of [lo, hi) is checked here, and the blocks'
  // ranges tile [0, emax), so a tile whose ld decreases, or leaves [0, tb),
  // traps rather than drop or misplace edges
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
  if (last_nz >= 0) atomicMax(s_last_nz, last_nz);
  __syncthreads();

  // the block's trailing weight-0 run [z, hi): one source row, or walked
  const int z = max(lo, *s_last_nz + 1);
  if (z < hi) {
    const int src0 = src_p[z];
    for (int i = z + threadIdx.x; i < hi; i += kThreads)
      if (src_p[i] != src0) *s_mixed = 1;
    __syncthreads();
  }
  return z < hi && !*s_mixed ? z : hi;
}

// One row's chain over columns [c0, c0 + G*NV*VEC) of its lane group:
// acc += w * table[src] over the slots [s, e) in stored order, then, if
// the row has a part of the block's one-source weight-0 run, that run's
// product once.  W, T, VEC, G, NV as for tile_spmm_kernel below.
template <typename W, typename T, int VEC, int G, int NV>
__device__ __forceinline__ void walk_row(
    float (&acc)[NV][VEC], const int32_t* __restrict__ src_p,
    const W* __restrict__ w_p, const T* __restrict__ tab, int n_rows, int f,
    int c0, int s, int e, bool in_run, int run, int li, unsigned gmask) {
  constexpr int kBatch = G >= 8 ? G : 8;           // slots staged per batch
  constexpr int kPer = kBatch / G;                 // ... by each lane
  constexpr int kWide = 32 / (NV * VEC);
  constexpr int kAhead = kWide < 2 ? 2 : (kWide > kBatch ? kBatch : kWide);
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
        // a bad index is a plan bug: fail the launch loudly rather than
        // read out of bounds
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
              acc[v][q] = __fadd_rn(acc[v][q], __fmul_rn(wj[a], x[a][v][q]));
    }
  }
  if (!in_run) return;
  const int sv = src_p[run];
  if ((unsigned)sv >= (unsigned)n_rows) __trap();
  const float w = static_cast<float>(w_p[run]);
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int col = c0 + (v * G + li) * VEC;
    if (col >= f) continue;
    float x[VEC];
    load_cols<T, VEC>(tab + (long long)sv * f + col, x);
#pragma unroll
    for (int q = 0; q < VEC; ++q)
      acc[v][q] = __fadd_rn(acc[v][q], __fmul_rn(w, x[q]));
  }
}

// The class of a tile in a family's class table: (emax, first tile,
// first slot).
__device__ __forceinline__ void find_class(const int* first_tile,
                                           const int* emax_of,
                                           const long long* slot_off, int n,
                                           int tile, int& emax, int& t0,
                                           long long& off) {
  emax = 0;
  t0 = 0;
  off = 0;
#pragma unroll
  for (int c = 0; c < kMaxClasses; ++c)
    if (c < n && tile >= first_tile[c]) {
      emax = emax_of[c];
      t0 = first_tile[c];
      off = slot_off[c];
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
  constexpr int kCols = G * NV * VEC;              // columns per walk

  __shared__ int s_start[kMaxTile + 1];
  __shared__ int s_misc[4];

  const int part = blockIdx.y;
  const int tile = blockIdx.x / chunks_per_tile;
  const int r0 = (blockIdx.x - tile * chunks_per_tile) * rows_per_block;
  const int nrows = min(rows_per_block, tb - r0);

  int emax, t0;
  long long off;
  find_class(ct.first_tile, ct.emax, ct.slot_off, ct.n, tile, emax, t0, off);
  const long long base =
      (long long)part * idx_part_stride + off + (long long)(tile - t0) * emax;
  const int32_t* src_p = tsrc + base;
  const W* w_p = tw + base;
  const T* tab = table + (long long)part * table_part_stride;
  float* outp = out + (long long)part * out_part_stride +
                ((long long)tile * tb + r0) * f;
  const int run = scan_block_slots<W>(src_p, tld + base, w_p, emax, tb, r0,
                                      nrows, s_start, s_misc);

  const int li = threadIdx.x & (G - 1);
  const int lane = threadIdx.x & 31;
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
      walk_row<W, T, VEC, G, NV>(acc, src_p, w_p, tab, n_rows, f, c0, s, e,
                                 in_run, run, li, gmask);
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int col = c0 + (v * G + li) * VEC;
        if (col < f) store_cols<VEC>(orow + col, acc[v]);
      }
    }
  }
}

// VEC columns rounded to bf16 as torch's CUDA cast rounds
// (c10::BFloat16's constructor on sm_80+ is __float2bfloat16: nearest
// even, the same NaN), stored as one 8-byte vector or one value.
__device__ __forceinline__ unsigned int bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

template <int VEC>
__device__ __forceinline__ void store_cols(__nv_bfloat16* p,
                                           const float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(bf16_bits(x[0]) | (bf16_bits(x[1]) << 16),
                   bf16_bits(x[2]) | (bf16_bits(x[3]) << 16));
  } else {
    *reinterpret_cast<unsigned short*>(p) = (unsigned short)bf16_bits(x[0]);
  }
}

// Both families of a GCN aggregation in one launch, with their sum: the
// local family over `ltab` (h) and the halo family over `htab` (the a2a
// receive buffer or the ring concat, read in place, on h's dtype or the
// bf16 wire) share their tile classes, so a block that covers rows of one
// tile finds that tile in both families under the same class index.  Each
// owned row (tile * tb + r < b) runs its local chain, its halo chain, each
// exactly as tile_spmm_kernel runs it, then out = local + remote in one
// float32 add (pallas_spmm.py:428), stored once in h's dtype TL.  Rows at
// or past b are neither walked nor stored.
struct FusedClasses {
  int n;
  int first_tile[kMaxClasses + 1];
  int emax[2][kMaxClasses];
  long long slot_off[2][kMaxClasses];
};

struct Family {
  const int32_t* src;
  const int32_t* ld;
  const float* w;
  const void* table;
  int n_rows;
  long long idx_part_stride, table_part_stride;
};

// Two chains' state per row takes ~110-120 registers at f = 128 when
// uncapped, room for 2 blocks an SM; capped at 85 (3 blocks, as the
// family kernel runs) the f = 128 shapes spill a few dozen bytes and keep
// half as many warps again in flight for the gathers (chip_smoke.py
// phase 0 prints each instantiation's registers and spills).
constexpr int kFusedMinBlocks = 3;

template <typename TL, typename TR, int VEC, int G, int NV>
__global__ void __launch_bounds__(kThreads, kFusedMinBlocks)
tile_spmm_fused_kernel(const Family fl, const Family fh, TL* __restrict__ out,
                       const FusedClasses ct, int tb, int b,
                       int rows_per_block, int chunks_per_tile, int f,
                       long long out_part_stride) {
  constexpr int kGroups = kThreads / G;
  constexpr int kCols = G * NV * VEC;

  __shared__ int s_start[2][kMaxTile + 1];
  __shared__ int s_misc[2][4];

  const int part = blockIdx.y;
  const int tile = blockIdx.x / chunks_per_tile;
  const int r0 = (blockIdx.x - tile * chunks_per_tile) * rows_per_block;
  // the block's owned rows; a block past b has none (uniform: return)
  const int nrows = min(min(rows_per_block, tb - r0), b - (tile * tb + r0));
  if (nrows <= 0) return;

  const int32_t* src_p[2];
  const float* w_p[2];
  int run[2];
#pragma unroll
  for (int fam = 0; fam < 2; ++fam) {
    const Family& F = fam ? fh : fl;
    int emax, t0;
    long long off;
    find_class(ct.first_tile, ct.emax[fam], ct.slot_off[fam], ct.n, tile,
               emax, t0, off);
    const long long base = (long long)part * F.idx_part_stride + off +
                           (long long)(tile - t0) * emax;
    src_p[fam] = F.src + base;
    w_p[fam] = F.w + base;
    run[fam] = scan_block_slots<float>(src_p[fam], F.ld + base, w_p[fam],
                                       emax, tb, r0, nrows, s_start[fam],
                                       s_misc[fam]);
  }
  const TL* ltab =
      static_cast<const TL*>(fl.table) + (long long)part * fl.table_part_stride;
  const TR* htab =
      static_cast<const TR*>(fh.table) + (long long)part * fh.table_part_stride;
  TL* outp = out + (long long)part * out_part_stride +
             ((long long)tile * tb + r0) * f;

  const int li = threadIdx.x & (G - 1);
  const int lane = threadIdx.x & 31;
  const unsigned gmask = (0xffffffffu >> (32 - G)) << (lane & ~(G - 1));
  for (int r = threadIdx.x / G; r < nrows; r += kGroups) {
    int s[2], e[2];
    bool in_run[2];
#pragma unroll
    for (int fam = 0; fam < 2; ++fam) {
      s[fam] = s_start[fam][r];
      const int end = s_start[fam][r + 1];
      in_run[fam] = end > max(s[fam], run[fam]);
      e[fam] = in_run[fam] ? max(s[fam], run[fam]) : end;
    }
    TL* orow = outp + (long long)r * f;
    for (int c0 = 0; c0 < f; c0 += kCols) {
      float loc[NV][VEC], rem[NV][VEC];
#pragma unroll
      for (int v = 0; v < NV; ++v)
#pragma unroll
        for (int q = 0; q < VEC; ++q) loc[v][q] = rem[v][q] = 0.0f;
      walk_row<float, TL, VEC, G, NV>(loc, src_p[0], w_p[0], ltab, fl.n_rows,
                                      f, c0, s[0], e[0], in_run[0], run[0],
                                      li, gmask);
      walk_row<float, TR, VEC, G, NV>(rem, src_p[1], w_p[1], htab, fh.n_rows,
                                      f, c0, s[1], e[1], in_run[1], run[1],
                                      li, gmask);
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int col = c0 + (v * G + li) * VEC;
        if (col >= f) continue;
#pragma unroll
        for (int q = 0; q < VEC; ++q) loc[v][q] = __fadd_rn(loc[v][q], rem[v][q]);
        store_cols<VEC>(orow + col, loc[v]);
      }
    }
  }
}

// Rows per block: at least 32, so that its two searches and the scan are
// shared by several rows; never more than one tile.
int block_rows(int tb, int groups) {
  return min(tb, groups > 32 ? groups : 32);
}

// Calls l.template run<VEC, G, NV>() for the lane shape of width f at
// vector width vec: lanes per row enough vectors for the row, up to a
// warp; past 32 vectors a lane takes 2 or 4 (more columns walk the slots
// again).
template <typename L>
int by_lane_shape(const L& l, int f, int vec) {
  const int nvec = f / vec + (f % vec != 0);
  int g = 1;
  while (g < nvec && g < 32) g <<= 1;
  const int nv = nvec <= 32 ? 1 : nvec <= 64 ? 2 : 4;
  if (vec == 4) {
    if (nv == 1 && g <= 8) return l.template run<4, 8, 1>();
    if (nv == 1 && g == 16) return l.template run<4, 16, 1>();
    if (nv == 1) return l.template run<4, 32, 1>();
    if (nv == 2) return l.template run<4, 32, 2>();
    return l.template run<4, 32, 4>();
  }
  switch (nv == 1 ? g : 32 * nv) {
    case 1: return l.template run<1, 1, 1>();
    case 2: return l.template run<1, 2, 1>();
    case 4: return l.template run<1, 4, 1>();
    case 8: return l.template run<1, 8, 1>();
    case 16: return l.template run<1, 16, 1>();
    case 32: return l.template run<1, 32, 1>();
    case 64: return l.template run<1, 32, 2>();
    default: return l.template run<1, 32, 4>();
  }
}

// Checks that n_classes classes lie one after another, tiles and slots:
// first_tile[0] == 0, every class at least one tile of at least one slot,
// slot_off the running sum.  Fills first_tile (n + 1 entries).
bool check_classes(int n_classes, const int* first_tile, const int* emax,
                   const long long* slot_off, int* first_out) {
  if (n_classes < 1 || n_classes > kMaxClasses || first_tile[0] != 0)
    return false;
  long long slots = 0;
  for (int c = 0; c < n_classes; ++c) {
    const int tiles = first_tile[c + 1] - first_tile[c];
    if (tiles < 1 || emax[c] < 1 || slot_off[c] != slots) return false;
    slots += (long long)tiles * emax[c];
  }
  for (int c = 0; c <= n_classes; ++c) first_out[c] = first_tile[c];
  return true;
}

// Vector loads need whole 4-column vectors per row: f % 4 == 0, a base
// aligned to 4 values and a part stride of whole vectors.
bool vec_ok(int f, const void* table, int itemsize, long long part_stride) {
  return f % 4 == 0 && (uintptr_t)table % (4 * itemsize) == 0 &&
         part_stride % 4 == 0;
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

template <typename W, typename T>
struct FamilyLaunch {
  const Args& a;
  int k, t_all;
  cudaStream_t stream;
  template <int VEC, int G, int NV>
  int run() const {
    const int rows = block_rows(a.tb, kThreads / G);
    const int chunks = (a.tb + rows - 1) / rows;
    const long long blocks = (long long)t_all * chunks;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned)blocks, (unsigned)k);
    tile_spmm_kernel<W, T, VEC, G, NV><<<grid, kThreads, 0, stream>>>(
        a.tsrc, a.tld, static_cast<const W*>(a.tw),
        static_cast<const T*>(a.table), a.out, a.ct, a.tb, rows, chunks,
        a.n_rows, a.f, a.idx_part_stride, a.table_part_stride,
        a.out_part_stride);
    return (int)cudaGetLastError();
  }
};

template <typename W, typename T>
int launch_family(const void* tsrc, const void* tld, const void* tw,
                  const void* table, void* out, int k, int n_classes,
                  const int* first_tile, const int* emax,
                  const long long* slot_off, int tb, int n_rows, int f,
                  int vec, long long idx_part_stride,
                  long long table_part_stride, long long out_part_stride,
                  int device, void* stream) {
  if (k < 1 || k > 65535 || tb < 1 || tb > kMaxTile || n_rows < 1 ||
      f < 1 || (vec != 1 && vec != 4))
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.ct.n = n_classes;
  if (!check_classes(n_classes, first_tile, emax, slot_off, a.ct.first_tile))
    return (int)cudaErrorInvalidValue;
  for (int c = 0; c < n_classes; ++c) {
    a.ct.emax[c] = emax[c];
    a.ct.slot_off[c] = slot_off[c];
  }
  if (vec == 4 && !vec_ok(f, table, sizeof(T), table_part_stride))
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
  return by_lane_shape(
      FamilyLaunch<W, T>{a, k, first_tile[n_classes], (cudaStream_t)stream}, f,
      vec);
}

template <typename TL, typename TR>
struct FusedLaunch {
  const Family& fl;
  const Family& fh;
  void* out;
  const FusedClasses& ct;
  int k, tb, b, f;
  long long out_part_stride;
  cudaStream_t stream;
  template <int VEC, int G, int NV>
  int run() const {
    const int rows = block_rows(tb, kThreads / G);
    const int chunks = (tb + rows - 1) / rows;
    const long long blocks = (long long)ct.first_tile[ct.n] * chunks;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned)blocks, (unsigned)k);
    tile_spmm_fused_kernel<TL, TR, VEC, G, NV><<<grid, kThreads, 0, stream>>>(
        fl, fh, static_cast<TL*>(out), ct, tb, b, rows, chunks, f,
        out_part_stride);
    return (int)cudaGetLastError();
  }
};

template <typename TL, typename TR>
int launch_fused(const void* lsrc, const void* lld, const void* lw,
                 const void* ltable, const void* hsrc, const void* hld,
                 const void* hw, const void* htable, void* out, int k,
                 int n_classes, const int* first_tile, const int* lemax,
                 const long long* lslot_off, const int* hemax,
                 const long long* hslot_off, int tb, int b, int n_lrows,
                 int n_hrows, int f, int vec, long long lidx_part_stride,
                 long long hidx_part_stride, long long ltable_part_stride,
                 long long htable_part_stride, long long out_part_stride,
                 int device, void* stream) {
  if (k < 1 || k > 65535 || tb < 1 || tb > kMaxTile || n_lrows < 1 ||
      n_hrows < 1 || f < 1 || (vec != 1 && vec != 4))
    return (int)cudaErrorInvalidValue;
  FusedClasses ct{};
  ct.n = n_classes;
  // one class structure of tiles, each family its own slots
  if (!check_classes(n_classes, first_tile, lemax, lslot_off,
                     ct.first_tile) ||
      !check_classes(n_classes, first_tile, hemax, hslot_off, ct.first_tile))
    return (int)cudaErrorInvalidValue;
  for (int c = 0; c < n_classes; ++c) {
    ct.emax[0][c] = lemax[c];
    ct.emax[1][c] = hemax[c];
    ct.slot_off[0][c] = lslot_off[c];
    ct.slot_off[1][c] = hslot_off[c];
  }
  // the owned rows lie in the tiles
  if (b < 1 || b > first_tile[n_classes] * tb)
    return (int)cudaErrorInvalidValue;
  if (vec == 4 && (!vec_ok(f, ltable, sizeof(TL), ltable_part_stride) ||
                   !vec_ok(f, htable, sizeof(TR), htable_part_stride) ||
                   !vec_ok(f, out, sizeof(TL), out_part_stride)))
    return (int)cudaErrorMisalignedAddress;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Family fl{(const int32_t*)lsrc, (const int32_t*)lld,
                  (const float*)lw,     ltable,
                  n_lrows,              lidx_part_stride,
                  ltable_part_stride};
  const Family fh{(const int32_t*)hsrc, (const int32_t*)hld,
                  (const float*)hw,     htable,
                  n_hrows,              hidx_part_stride,
                  htable_part_stride};
  return by_lane_shape(
      FusedLaunch<TL, TR>{fl, fh, out, ct, k, tb, b, f, out_part_stride,
                          (cudaStream_t)stream},
      f, vec);
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

// One GCN aggregation's tile work in one launch (K3/K4's local pass,
// remote pass and sum): the local family (lsrc/lld/lw, k parts at
// lidx_part_stride) over ltable, the halo family (hsrc/hld/hw at
// hidx_part_stride) over htable, both float32 weights, sharing one class
// structure of tiles (first_tile, n_classes + 1 entries) with each its own
// slots (lemax/lslot_off, hemax/hslot_off: host arrays).  ltable part p is
// (n_lrows, f) row-major at p * ltable_part_stride, htable part p
// (n_hrows, f) at p * htable_part_stride; out part p is (b, f) row-major at
// p * out_part_stride, b <= first_tile[n] * tb the owned rows: out =
// local + remote summed in float32 and stored once in ltable's dtype.
// Launches on `stream` of CUDA device `device`, does not synchronize, and
// returns the cudaError_t of the launch.  float32 h and remote table:
extern "C" int sgcn_tile_spmm_fused_f32(
    const void* lsrc, const void* lld, const void* lw, const void* ltable,
    const void* hsrc, const void* hld, const void* hw, const void* htable,
    void* out, int k, int n_classes, const int* first_tile, const int* lemax,
    const long long* lslot_off, const int* hemax, const long long* hslot_off,
    int tb, int b, int n_lrows, int n_hrows, int f, int vec,
    long long lidx_part_stride, long long hidx_part_stride,
    long long ltable_part_stride, long long htable_part_stride,
    long long out_part_stride, int device, void* stream) {
  return launch_fused<float, float>(
      lsrc, lld, lw, ltable, hsrc, hld, hw, htable, out, k, n_classes,
      first_tile, lemax, lslot_off, hemax, hslot_off, tb, b, n_lrows, n_hrows,
      f, vec, lidx_part_stride, hidx_part_stride, ltable_part_stride,
      htable_part_stride, out_part_stride, device, stream);
}

// ... float32 h, the remote table on the bf16 wire (halo_dtype='bfloat16':
// each bf16 value widens exactly, as the upcast table would give it),
// float32 out
extern "C" int sgcn_tile_spmm_fused_f32_bf16wire(
    const void* lsrc, const void* lld, const void* lw, const void* ltable,
    const void* hsrc, const void* hld, const void* hw, const void* htable,
    void* out, int k, int n_classes, const int* first_tile, const int* lemax,
    const long long* lslot_off, const int* hemax, const long long* hslot_off,
    int tb, int b, int n_lrows, int n_hrows, int f, int vec,
    long long lidx_part_stride, long long hidx_part_stride,
    long long ltable_part_stride, long long htable_part_stride,
    long long out_part_stride, int device, void* stream) {
  return launch_fused<float, __nv_bfloat16>(
      lsrc, lld, lw, ltable, hsrc, hld, hw, htable, out, k, n_classes,
      first_tile, lemax, lslot_off, hemax, hslot_off, tb, b, n_lrows, n_hrows,
      f, vec, lidx_part_stride, hidx_part_stride, ltable_part_stride,
      htable_part_stride, out_part_stride, device, stream);
}

// ... bf16 h and remote table (compute_dtype='bfloat16'), the sum rounded
// once to bf16 as torch's CUDA cast rounds it
extern "C" int sgcn_tile_spmm_fused_bf16(
    const void* lsrc, const void* lld, const void* lw, const void* ltable,
    const void* hsrc, const void* hld, const void* hw, const void* htable,
    void* out, int k, int n_classes, const int* first_tile, const int* lemax,
    const long long* lslot_off, const int* hemax, const long long* hslot_off,
    int tb, int b, int n_lrows, int n_hrows, int f, int vec,
    long long lidx_part_stride, long long hidx_part_stride,
    long long ltable_part_stride, long long htable_part_stride,
    long long out_part_stride, int device, void* stream) {
  return launch_fused<__nv_bfloat16, __nv_bfloat16>(
      lsrc, lld, lw, ltable, hsrc, hld, hw, htable, out, k, n_classes,
      first_tile, lemax, lslot_off, hemax, hslot_off, tb, b, n_lrows, n_hrows,
      f, vec, lidx_part_stride, hidx_part_stride, ltable_part_stride,
      htable_part_stride, out_part_stride, device, stream);
}

extern "C" const char* sgcn_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
