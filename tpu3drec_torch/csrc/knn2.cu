// Fused descriptor distance + running top-2 per row, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpu3drec/ops/pallas_match.py:fused_knn2
// (body _match_kernel), extended with an int8 element type for the main
// path's l2_int8 metric (and hamming_pm1, whose +-1 codes are int8 too). For
// each pair p and row n of A it computes
//     raw[m] = bnorm[m] - 2 * <A[p, n], B[p, m]>     (mask2[p, m] == 0: BIG)
// and keeps the two smallest (value, column) pairs, smallest first, ties to
// the lowest column (the reference's argmin-based _top2_min). The N x M
// matrix never reaches device memory.
//
// What bounds it: masked columns can only add BIG, so only the valid ones
// are work. At full occupancy (96 pairs, 2048 x 2048 columns, D = 128) that
// is 51.5 G int8 multiply-adds, bound by operations on the int8 tensor
// cores; at the smoke photos' ~8% valid columns, by the bytes of A (every
// row of A is scored). In practice the fold bounds the int8 kernel: each
// value costs one multiply-add and ~2.5 integer min/max on the CUDA cores,
// more issue slots than its share of the tensor cores' time.
//
// int8 design (knn2_i8_kernel):
//   - one C call first lists each pair's valid columns on the device
//     (knn2_list_kernel: a CTA a pair, warp ballots and a block scan, so the
//     list ascends), padded to whole tiles; each sweep stops at its count;
//   - a CTA is two warpgroups and 128 rows of one pair, two CTAs a SM. A's
//     rows stay resident in shared memory; the listed rows of B are gathered
//     with cp.async (16 B a thread, 8 per 128-byte row) into a 4-stage ring
//     of 128-column tiles, each with its listed columns and keys; the list
//     entries are read a tile ahead, so no copy waits on a load. Hopper's
//     TMA has no gather, and a compacting pass would move every valid row
//     of B once more;
//   - both operands are K-major (D contiguous), the layout the 8-bit wgmma
//     takes, in the 128-byte swizzle (chunk c of row r at chunk c ^ (r % 8));
//     D is a multiple of 128 (the wrapper pads with zero columns), so each
//     K-block is four k32 steps issued back to back;
//   - products on the tensor cores, wgmma.mma_async m64n64k32 s32.s8.s8,
//     exact int32 sums, so the result is bit-equal to the plain version;
//   - each warpgroup computes a tile as two 64-column halves in two
//     accumulators, then folds it; with two CTAs a SM, one warpgroup's
//     fold runs while another's products do (an overlap of the halves
//     inside one warpgroup measured no faster: ptxas injects a
//     warpgroup.wait before the fold reads the accumulators);
//   - the fold: when a pair's values fit (the listing kernel checks its
//     norms' range), the key norm * 128 + tile column makes value * 128 +
//     column one int, and a row's top-2 over a tile takes three min/max a
//     value; otherwise each value is inserted in ascending column order. The
//     quad of lanes sharing a row merges (value, column) lexicographically
//     at the end. No atomics on values: the result does not depend on
//     scheduling.
// The float32 path (l2) stays on the CUDA cores (fmaf: TF32 or bf16 would
// change its answers) and sweeps the same column list.
//
// Bars: chip_smoke.py holds the int8 kernel bit for bit against the plain
// version (indices and raw values on every row, two launches identical) at
// the pair step's input, at full occupancy and on edge inputs (scattered
// masks, ties, no or one valid column, ragged N and M, D 64 to 1024, norms
// too wide for the packed keys); the float32 kernel within rtol/atol 1e-4.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int LIST_NT = 1024;      // threads of the listing kernel (32 warps)

// ---- int8 tensor-core kernel
constexpr int NT = 256;            // two warpgroups of 64 rows each
constexpr int ROWS = 128;          // rows of A per CTA
constexpr int BN = 128;            // listed columns per tile, two wgmma halves
constexpr int KBYTES = 128;        // depth bytes per K-block: one swizzled row
constexpr int STAGES = 4;          // ring of (tile, K-block) units
constexpr int A_BLOCK = ROWS * KBYTES;     // 16 KB
constexpr int B_STAGE = BN * KBYTES;       // 16 KB
constexpr int LOAD_ROWS = NT / 8;          // B rows one pass of 16-byte copies covers
constexpr int ROW_PASSES = BN / LOAD_ROWS;

// ---- float32 CUDA-core kernel
constexpr int F_BN = 64;           // rows of A per CTA
constexpr int F_BM = 64;           // listed columns per tile
constexpr int F_KW = 32;           // floats of depth per shared-memory chunk
constexpr int F_NT = 256;

template <typename T>
struct Top2 {
  T b, s;
  int bi, si;
};

// (v, i) < (w, j) lexicographically
template <typename T>
__device__ __forceinline__ bool lex_lt(T v, int i, T w, int j) {
  return v < w || (v == w && i < j);
}

template <typename T>
__device__ __forceinline__ Top2<T> merge(const Top2<T>& x, const Top2<T>& y) {
  Top2<T> r;
  if (lex_lt(y.b, y.bi, x.b, x.bi)) {
    r.b = y.b; r.bi = y.bi;
    if (lex_lt(y.s, y.si, x.b, x.bi)) { r.s = y.s; r.si = y.si; }
    else { r.s = x.b; r.si = x.bi; }
  } else {
    r.b = x.b; r.bi = x.bi;
    if (lex_lt(y.b, y.bi, x.s, x.si)) { r.s = y.b; r.si = y.bi; }
    else { r.s = x.s; r.si = x.si; }
  }
  return r;
}

// Insert (v, col) into a top-2 whose columns so far are all below col: a
// strict < keeps the lower column on a tie.
template <typename T>
__device__ __forceinline__ void insert(Top2<T>& t, T v, int col) {
  if (v < t.s) {
    if (v < t.b) { t.s = t.b; t.si = t.bi; t.b = v; t.bi = col; }
    else { t.s = v; t.si = col; }
  }
}

// Merge the top-2 of the lanes `lane ^ off` for off in [lo, hi] (powers of 2).
template <typename T>
__device__ __forceinline__ Top2<T> merge_lanes(Top2<T> t, int lo, int hi) {
  for (int off = lo; off <= hi; off <<= 1) {
    Top2<T> o;
    o.b = __shfl_xor_sync(FULL, t.b, off);
    o.s = __shfl_xor_sync(FULL, t.s, off);
    o.bi = __shfl_xor_sync(FULL, t.bi, off);
    o.si = __shfl_xor_sync(FULL, t.si, off);
    t = merge(t, o);
  }
  return t;
}

// One CTA a pair. Lists the valid columns of mask2[pair] in ascending order
// into cols[pair * Mp ...] and their number into count[pair]; positions from
// the count to Mp (M rounded up to whole tiles) get column 0. With bnorm
// (int8), keys[pair * Mp + pos] is the column's norm, and packed[pair] says
// whether every value bnorm - 2 a.b of the pair, times 128, plus the
// column's place in its tile, fits an int32 below INT_MAX: then keys hold
// bnorm * 128 + (pos % BN), so that one int orders (value, column). Unused
// positions get the key INT_MAX.
__global__ void __launch_bounds__(LIST_NT)
knn2_list_kernel(const uint8_t* __restrict__ mask2, const int* __restrict__ bnorm,
                 int M, int Mp, int D, int* __restrict__ cols, int* __restrict__ keys,
                 int* __restrict__ count, int* __restrict__ packed) {
  __shared__ int warp_off[LIST_NT / 32];
  __shared__ int warp_hi[LIST_NT / 32];
  __shared__ int total;
  __shared__ bool pk_s;
  const int pair = blockIdx.x;
  const uint8_t* mk = mask2 + (size_t)pair * M;
  const int* bn = bnorm ? bnorm + (size_t)pair * M : nullptr;
  int* out = cols + (size_t)pair * Mp;
  int* ko = keys ? keys + (size_t)pair * Mp : nullptr;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  bool pk = false;
  if (bn) {
    // the norms' range over the valid columns; |a.b| <= D * 128 * 128
    int lo = INT_MAX, hi = INT_MIN;
    for (int m = threadIdx.x; m < M; m += LIST_NT)
      if (mk[m]) { lo = min(lo, bn[m]); hi = max(hi, bn[m]); }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo = min(lo, __shfl_xor_sync(FULL, lo, off));
      hi = max(hi, __shfl_xor_sync(FULL, hi, off));
    }
    if (lane == 0) { warp_off[warp] = lo; warp_hi[warp] = hi; }
    __syncthreads();
    if (warp == 0) {
      lo = warp_off[lane];
      hi = warp_hi[lane];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        lo = min(lo, __shfl_xor_sync(FULL, lo, off));
        hi = max(hi, __shfl_xor_sync(FULL, hi, off));
      }
      const long long span = 2LL * D * 128 * 128;
      if (lane == 0)
        pk_s = (long long)lo - span >= -(1LL << 24) && (long long)hi + span <= (1LL << 24) - 2;
    }
    __syncthreads();
    pk = pk_s;
  }

  int base = 0;
  for (int m0 = 0; m0 < M; m0 += LIST_NT) {
    const int m = m0 + threadIdx.x;
    const bool valid = m < M && mk[m] != 0;
    const unsigned bal = __ballot_sync(FULL, valid);
    if (lane == 0) warp_off[warp] = __popc(bal);
    __syncthreads();
    if (warp == 0) {
      const int n = warp_off[lane];
      int incl = n;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl += t;
      }
      warp_off[lane] = incl - n;
      if (lane == 31) total = incl;
    }
    __syncthreads();
    if (valid) {
      const int pos = base + warp_off[warp] + __popc(bal & ((1u << lane) - 1u));
      out[pos] = m;
      if (ko) ko[pos] = pk ? bn[m] * 128 + (pos & (BN - 1)) : bn[m];
    }
    base += total;
    __syncthreads();   // warp_off and total are rewritten by the next round
  }
  for (int pos = base + threadIdx.x; pos < Mp; pos += LIST_NT) {
    out[pos] = 0;
    if (ko) ko[pos] = INT_MAX;
  }
  if (threadIdx.x == 0) {
    count[pair] = base;
    if (packed) packed[pair] = pk;
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; full == false writes 16 zero bytes instead
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(full ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// 128-byte swizzle: the 16-byte chunk c of a 128-byte row r sits at c ^ (r % 8)
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * KBYTES + ((c ^ (r & 7)) << 4));
}

// wgmma descriptor of a K-major tile of 128-byte swizzled rows: 8-row atoms
// of 1,024 bytes (SBO), the tile 1,024-byte aligned.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16)
         | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// d (64 rows x 64 columns, int32, the warpgroup's fragment) += a . b over
// 32 bytes of depth; scale_d == 0 overwrites d instead.
__device__ __forceinline__ void wgmma_m64n64k32(int (&d)[32], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]),
        "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
        "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]),
        "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The products of one K-block (128 bytes of depth, four k32 steps) for a
// half tile: 64 rows of A (descriptor da) by 64 listed columns (db).
__device__ __forceinline__ void mma_block(int (&d)[32], uint64_t da, uint64_t db,
                                          bool first) {
#pragma unroll
  for (int k = 0; k < 4; ++k)   // + 32 bytes: 2 in the descriptors' 16-byte units
    wgmma_m64n64k32(d, da + 2 * k, db + 2 * k, !(first && k == 0));
}

// A thread's fragment of an m64n64 accumulator: for i < 8, d[4i + 2h + j] is
// row (lane / 4) + 8h of its warp's 16 and column 8i + 2(lane % 4) + j of
// the half tile. cs, ks: the half tile's 64 listed columns and keys (list
// positions past the count hold zero rows of B and the key INT_MAX, so they
// give INT_MAX and never enter a top-2).

// Keys are norms: each value goes into the running top-2 in ascending
// column order.
__device__ __forceinline__ void fold(const int (&d)[32], const int* cs,
                                     const int* ks, int q, Top2<int> (&top)[2]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int2 c2 = *reinterpret_cast<const int2*>(cs + 8 * i + 2 * q);
    const int2 k2 = *reinterpret_cast<const int2*>(ks + 8 * i + 2 * q);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      insert(top[h], k2.x - 2 * d[4 * i + 2 * h], c2.x);
      insert(top[h], k2.y - 2 * d[4 * i + 2 * h + 1], c2.y);
    }
  }
}

// Keys are norm * 128 + tile column: key - 256 d = value * 128 + tile column
// orders (value, column) in one int, so a row's top-2 over the tile, lo <
// hi, takes three min/max a value.
__device__ __forceinline__ void fold_packed(const int (&d)[32], const int* ks, int q,
                                            int (&lo)[2], int (&hi)[2]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int2 k2 = *reinterpret_cast<const int2*>(ks + 8 * i + 2 * q);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = k2.x - 256 * d[4 * i + 2 * h];
      const int y = k2.y - 256 * d[4 * i + 2 * h + 1];
      hi[h] = min(hi[h], max(lo[h], x));
      lo[h] = min(lo[h], x);
      hi[h] = min(hi[h], max(lo[h], y));
      lo[h] = min(lo[h], y);
    }
  }
}

// The tile's packed top-2 per row into the running top-2; cs: the tile's
// 128 listed columns, all above the running top-2's, so a strict < keeps
// ties on the earlier column.
__device__ __forceinline__ void merge_packed(int (&lo)[2], int (&hi)[2], const int* cs,
                                             Top2<int> (&top)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (lo[h] != INT_MAX) insert(top[h], lo[h] >> 7, cs[lo[h] & (BN - 1)]);
    if (hi[h] != INT_MAX) insert(top[h], hi[h] >> 7, cs[hi[h] & (BN - 1)]);
    lo[h] = hi[h] = INT_MAX;
  }
}

// Grid: one CTA per (pair, block of ROWS rows), pair-major. KB: 128-byte
// blocks of depth (D = 128 KB). cols, keys, count, packed: the listing
// kernel's output, Mp list positions per pair. Dynamic shared memory: see
// i8_smem_bytes.
//
// A unit (tile, K-block) is one stage of the ring. Each warpgroup computes
// a unit as two 64-column halves, an m64n64 accumulator each, waits for
// both and folds the tile after its last K-block; the products of one
// warpgroup run while another of the four on its SM (two CTAs of two)
// folds. Barrier u waits for unit u's copies, then copies unit
// u + STAGES - 1 into the stage of unit u - 1, whose products and fold
// are done.
template <int KB>
__global__ void __launch_bounds__(NT, 2)
knn2_i8_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
               const int* __restrict__ cols, const int* __restrict__ keys,
               const int* __restrict__ count, const int* __restrict__ packed,
               int N, int M, int Mp, int row_blocks,
               int* __restrict__ idx_out, int* __restrict__ val_out) {
  constexpr int D = KB * KBYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = smem_u32(smem_raw);
  const uint32_t a_s = (raw_addr + 1023u) & ~1023u;   // swizzle atoms: 1 KB aligned
  const uint32_t b_s = a_s + KB * A_BLOCK;
  const uint32_t cols_a = b_s + STAGES * B_STAGE;
  const uint32_t keys_a = cols_a + STAGES * BN * 4;
  const int* cols_s = reinterpret_cast<const int*>(smem_raw + (cols_a - raw_addr));
  const int* keys_s = reinterpret_cast<const int*>(smem_raw + (keys_a - raw_addr));

  const int pair = blockIdx.x / row_blocks;
  const int row0 = (blockIdx.x - pair * row_blocks) * ROWS;
  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, q = lane & 3;
  const int8_t* a = A + (size_t)pair * N * D;
  const int8_t* b = B + (size_t)pair * M * D;
  const int* lst = cols + (size_t)pair * Mp;
  const int* kl = keys + (size_t)pair * Mp;
  const int nvalid = count[pair];
  const bool pk = packed[pair] != 0;

  // A's rows, resident for the sweep (rows past N are zeros); issued before
  // the count arrives
#pragma unroll
  for (int k = 0; k < ROWS * D / 16 / NT; ++k) {
    const int t = tid + NT * k;
    const int r = t / (D / 16), c = t % (D / 16);
    const bool in = row0 + r < N;
    cp_async16(a_s + (c >> 3) * A_BLOCK + swz(r, c & 7),
               in ? (const void*)(a + (size_t)(row0 + r) * D + c * 16) : (const void*)A, in);
  }
  // Unit u = (tile u / KB, K-block u % KB) goes to stage u % STAGES. This
  // thread copies 16-byte chunk lc of tile rows lr + LOAD_ROWS k; their
  // listed columns are read a unit ahead, so no copy waits on a load.
  const int lr = tid >> 3, lc = tid & 7;
  auto fetch = [&](int u, int (&cl)[ROW_PASSES]) {
    const int tile = u / KB;
#pragma unroll
    for (int k = 0; k < ROW_PASSES; ++k) cl[k] = lst[tile * BN + lr + LOAD_ROWS * k];
  };
  auto load_unit = [&](int u, const int (&cl)[ROW_PASSES]) {
    const int tile = u / KB, kb = u % KB, st = u % STAGES;
#pragma unroll
    for (int k = 0; k < ROW_PASSES; ++k) {
      const int r = lr + LOAD_ROWS * k;
      // past the count: zeros (the list holds column 0 there, a valid row)
      cp_async16(b_s + st * B_STAGE + swz(r, lc), b + (size_t)cl[k] * D + kb * KBYTES + lc * 16,
                 tile * BN + r < nvalid);
    }
    if (kb == KB - 1 && tid < 2 * (BN / 4)) {   // the tile's columns and keys
      const int part = tid / (BN / 4), c4 = (tid % (BN / 4)) * 4;
      cp_async16((part ? keys_a : cols_a) + (st * BN + c4) * 4,
                 (part ? kl : lst) + tile * BN + c4, true);
    }
  };
  // lookahead: LEAD units are in flight while one is computed. The first
  // units' list entries are read before the count arrives (the list is
  // padded to Mp positions).
  constexpr int LEAD = STAGES - 1;
  int pre[LEAD][ROW_PASSES];
#pragma unroll
  for (int s = 0; s < LEAD; ++s)
    if (s / KB * BN < Mp) fetch(s, pre[s]);
  const int units = (nvalid + BN - 1) / BN * KB;

  Top2<int> top[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) { top[h].b = top[h].s = INT_MAX; top[h].bi = top[h].si = 0; }

  if (units > 0) {
#pragma unroll
    for (int s = 0; s < LEAD; ++s) {
      if (s < units) load_unit(s, pre[s]);
      cp_async_commit();
    }
    int nxt[ROW_PASSES];
    if (LEAD < units) fetch(LEAD, nxt);
    // unit u's copies done and visible to the tensor cores; the next copies
    auto barrier = [&](int u) {
      cp_async_wait<LEAD - 1>();
      // this thread's cp.async writes, visible to the tensor cores' reads
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      if (u + LEAD < units) {
        load_unit(u + LEAD, nxt);
        if (u + LEAD + 1 < units) fetch(u + LEAD + 1, nxt);
      }
      cp_async_commit();
    };

    const uint32_t a_wg = a_s + wg * 64 * KBYTES;
    int acc0[32], acc1[32];
    int lo[2] = {INT_MAX, INT_MAX}, hi[2] = {INT_MAX, INT_MAX};
    auto fold_half = [&](const int (&d)[32], int st, int half) {
      const int* cs = cols_s + st * BN;
      const int* ks = keys_s + st * BN + 64 * half;
      if (pk) {
        fold_packed(d, ks, q, lo, hi);
        if (half) merge_packed(lo, hi, cs, top);
      } else {
        fold(d, cs + 64 * half, ks, q, top);
      }
    };
    auto issue = [&](int (&d)[32], int u, int half) {
      wgmma_fence();
      mma_block(d, desc_sw128(a_wg + (u % KB) * A_BLOCK),
                desc_sw128(b_s + (u % STAGES) * B_STAGE + half * 64 * KBYTES),
                u % KB == 0);
      wgmma_commit();
    };

    for (int u = 0; u < units; ++u) {
      barrier(u);
      issue(acc0, u, 0);
      issue(acc1, u, 1);
      wgmma_wait<0>();
      if (u % KB == KB - 1) {
        fold_half(acc0, u % STAGES, 0);
        fold_half(acc1, u % STAGES, 1);
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");   // A's copies too, if no unit ran

  const int r_loc = wg * 64 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const Top2<int> t = merge_lanes(top[h], 1, 2);
    const int row = row0 + r_loc + 8 * h;
    if (q == 0 && row < N) {
      const size_t o = ((size_t)pair * N + row) * 2;
      idx_out[o] = t.bi;
      idx_out[o + 1] = t.si;
      val_out[o] = t.b;
      val_out[o + 1] = t.s;
    }
  }
}

int i8_smem_bytes(int D) {
  const int KB = D / KBYTES;
  return KB * A_BLOCK + STAGES * B_STAGE + 2 * STAGES * BN * (int)sizeof(int) + 1024;
}

// Float32 on the CUDA cores over the same list: grid (row block of 64,
// pair); 256 threads hold a 64x64 tile as 4x4 per thread, rows ty + 16 r
// and tile columns tx + 16 c; A and B stream through shared memory in
// chunks of 32 floats, padded to 33 so that neither the stores nor the
// per-thread reads conflict on banks.
__global__ void __launch_bounds__(F_NT)
knn2_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                const float* __restrict__ bnorm, const int* __restrict__ list,
                const int* __restrict__ count, int N, int M, int Mp, int D,
                int* __restrict__ idx_out, float* __restrict__ val_out) {
  __shared__ float As[F_BN][F_KW + 1];
  __shared__ float Bs[F_BM][F_KW + 1];
  __shared__ int cols[F_BM];

  const int pair = blockIdx.y;
  const int row0 = blockIdx.x * F_BN;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const float* a = A + (size_t)pair * N * D;
  const float* b = B + (size_t)pair * M * D;
  const float* bn = bnorm + (size_t)pair * M;
  const int* lst = list + (size_t)pair * Mp;
  const int nvalid = count[pair];

  Top2<float> top[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) { top[r].b = top[r].s = 3.4e38f; top[r].bi = top[r].si = 0; }

  for (int m0 = 0; m0 < nvalid; m0 += F_BM) {
    if (tid < F_BM) cols[tid] = m0 + tid < nvalid ? lst[m0 + tid] : -1;
    __syncthreads();
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

    for (int k0 = 0; k0 < D; k0 += F_KW) {
      for (int t = tid; t < F_BN * F_KW; t += F_NT) {
        const int r = t / F_KW, kk = t % F_KW;
        const int gr = row0 + r, gk = k0 + kk;
        As[r][kk] = (gr < N && gk < D) ? a[(size_t)gr * D + gk] : 0.f;
        const int col = cols[r];
        Bs[r][kk] = (col >= 0 && gk < D) ? b[(size_t)col * D + gk] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < F_KW; ++kk) {
        float av[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) av[r] = As[ty + 16 * r][kk];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = Bs[tx + 16 * c][kk];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
      }
      __syncthreads();
    }

    // this tile's columns, ascending per thread, into the top-2
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = cols[tx + 16 * c];
      if (col < 0) continue;
      const float nrm = bn[col];
#pragma unroll
      for (int r = 0; r < 4; ++r) insert(top[r], nrm - 2.f * acc[r][c], col);
    }
    __syncthreads();   // cols is rewritten by the next tile
  }

  // merge across the 16 threads (tx) that share each row
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const Top2<float> t = merge_lanes(top[r], 1, 8);
    const int row = row0 + ty + 16 * r;
    if (tx == 0 && row < N) {
      const size_t o = ((size_t)pair * N + row) * 2;
      idx_out[o] = t.bi;
      idx_out[o + 1] = t.si;
      val_out[o] = t.b;
      val_out[o + 1] = t.s;
    }
  }
}

// Scratch layout, in int32: cols (B x Mp), keys (B x Mp), count (B),
// packed (B); Mp is M rounded up to whole tiles.
int list_stride(int M) { return (M + BN - 1) / BN * BN; }

int list_columns(const void* mask2, const int* bnorm, int B, int M, int D,
                 int* work, cudaStream_t st) {
  const size_t Mp = list_stride(M);
  knn2_list_kernel<<<B, LIST_NT, 0, st>>>(
      (const uint8_t*)mask2, bnorm, M, (int)Mp, D, work,
      bnorm ? work + B * Mp : nullptr, work + 2 * B * Mp,
      bnorm ? work + 2 * B * Mp + B : nullptr);
  return (int)cudaGetLastError();
}

template <int KB>
int i8_main(const void* a, const void* b, const int* w, int B, int N, int M,
            size_t Mp, int row_blocks, void* idx, void* val, cudaStream_t st) {
  const int smem = i8_smem_bytes(KB * KBYTES);
  static int smem_set = 0;   // per instantiation
  if (smem > smem_set) {
    const cudaError_t ce = cudaFuncSetAttribute(
        knn2_i8_kernel<KB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (ce != cudaSuccess) {
      cudaGetLastError();   // not left behind for the next launch to report
      return (int)ce;
    }
    smem_set = smem;
  }
  knn2_i8_kernel<KB><<<row_blocks * B, NT, smem, st>>>(
      (const int8_t*)a, (const int8_t*)b, w, w + B * Mp, w + 2 * B * Mp,
      w + 2 * B * Mp + B, N, M, (int)Mp, row_blocks, (int*)idx, (int*)val);
  return (int)cudaGetLastError();
}

}  // namespace

// int32 scratch that knn2_i8_launch and knn2_f32_launch need for B pairs of
// M columns.
extern "C" long long knn2_work_ints(int B, int M) {
  return 2LL * B * list_stride(M) + 2LL * B;
}

// a: (B, N, D) int8 and b: (B, M, D) int8, D a multiple of 128 up to 1024,
// rows 16-byte aligned; bnorm: (B, M) int32; mask2: (B, M) uint8 (0 or 1);
// work: knn2_work_ints(B, M) int32 of scratch; idx: (B, N, 2) int32; val:
// (B, N, 2) int32. Enqueues the listing kernel and the main kernel on
// `stream`; returns the first CUDA error (0 on success).
extern "C" int knn2_i8_launch(const void* a, const void* b, const void* bnorm,
                              const void* mask2, int B, int N, int M, int D,
                              void* work, void* idx, void* val, void* stream) {
  if (D <= 0 || D % KBYTES != 0 || D > 1024) return (int)cudaErrorInvalidValue;
  if (B <= 0 || N <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  int e = list_columns(mask2, (const int*)bnorm, B, M, D, (int*)work, st);
  if (e != 0) return e;
  const int row_blocks = (N + ROWS - 1) / ROWS;
  if ((long long)row_blocks * B > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  const size_t Mp = list_stride(M);
  const int* w = (const int*)work;
  switch (D / KBYTES) {
    case 1: return i8_main<1>(a, b, w, B, N, M, Mp, row_blocks, idx, val, st);
    case 2: return i8_main<2>(a, b, w, B, N, M, Mp, row_blocks, idx, val, st);
    case 3: return i8_main<3>(a, b, w, B, N, M, Mp, row_blocks, idx, val, st);
    case 4: return i8_main<4>(a, b, w, B, N, M, Mp, row_blocks, idx, val, st);
    case 5: return i8_main<5>(a, b, w, B, N, M, Mp, row_blocks, idx, val, st);
    case 6: return i8_main<6>(a, b, w, B, N, M, Mp, row_blocks, idx, val, st);
    case 7: return i8_main<7>(a, b, w, B, N, M, Mp, row_blocks, idx, val, st);
    default: return i8_main<8>(a, b, w, B, N, M, Mp, row_blocks, idx, val, st);
  }
}

// As knn2_i8_launch with float32 a, b (any D), bnorm and val.
extern "C" int knn2_f32_launch(const void* a, const void* b, const void* bnorm,
                               const void* mask2, int B, int N, int M, int D,
                               void* work, void* idx, void* val, void* stream) {
  if (D <= 0) return (int)cudaErrorInvalidValue;
  if (B <= 0 || N <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  int e = list_columns(mask2, nullptr, B, M, D, (int*)work, st);
  if (e != 0) return e;
  dim3 grid((N + F_BN - 1) / F_BN, B);
  knn2_f32_kernel<<<grid, F_NT, 0, st>>>(
      (const float*)a, (const float*)b, (const float*)bnorm, (const int*)work,
      (const int*)work + 2 * B * (size_t)list_stride(M), N, M, list_stride(M), D,
      (int*)idx, (float*)val);
  return (int)cudaGetLastError();
}
