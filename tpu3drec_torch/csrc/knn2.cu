// Fused descriptor distance + running top-2 per row, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpu3drec/ops/pallas_match.py:fused_knn2
// (body _match_kernel), extended with an int8 element type for the main
// path's l2_int8 metric. For each pair p and row n of A it computes
//     raw[m] = bnorm[m] - 2 * <A[p, n], B[p, m]>     (mask2[p, m] == 0: BIG)
// and keeps the two smallest (value, column) pairs, smallest first, ties to
// the lowest column (the reference's argmin-based _top2_min). The N x M
// matrix never reaches device memory.
//
// What bounds it: operations. At the main-path shape (96 pairs, 2048 x 2048,
// D = 128) it is 103 G int8 multiply-adds against 2 x 96 x 2048 x 128 B =
// 50 MB of input. This first version runs them on the CUDA cores with
// __dp4a (4 int8 products per instruction, exact int32 sums) or fmaf for
// float32; tensor-core IMMA/wgmma is later work. The design:
//   - grid (row block of 64, pair); 256 threads hold a 64x64 output tile as
//     4x4 per thread, rows ty + 16 r and columns tx + 16 c;
//   - A and B tiles stream through shared memory in chunks of 32 words
//     (128 int8 or 32 floats per row), padded to 33 words per row so that
//     neither the stores nor the per-thread reads conflict on banks;
//   - each thread folds its tile column values into a running top-2 per row
//     in registers, in increasing column order; at the end the 16 threads
//     sharing a row merge their top-2 with warp shuffles, comparing
//     (value, column) lexicographically, so the result does not depend on
//     the order of the merge.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int BN = 64;       // rows of A per CTA
constexpr int BM = 64;       // columns (rows of B) per tile
constexpr int KW = 32;       // 32-bit words of depth per shared-memory chunk
constexpr int NT = 256;

template <bool INT8> struct Elem;
template <> struct Elem<true> {
  using acc_t = int;
  static __device__ __forceinline__ int big() { return INT_MAX; }
  static __device__ __forceinline__ int mac(uint32_t a, uint32_t b, int acc) {
    return __dp4a((int)a, (int)b, acc);
  }
};
template <> struct Elem<false> {
  using acc_t = float;
  static __device__ __forceinline__ float big() { return 3.4e38f; }
  static __device__ __forceinline__ float mac(uint32_t a, uint32_t b, float acc) {
    return fmaf(__uint_as_float(a), __uint_as_float(b), acc);
  }
};

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

template <bool INT8>
__global__ void __launch_bounds__(NT)
knn2_kernel(const uint32_t* __restrict__ A, const uint32_t* __restrict__ B,
            const typename Elem<INT8>::acc_t* __restrict__ bnorm,
            const uint8_t* __restrict__ mask2, int N, int M, int Dw,
            int* __restrict__ idx_out,
            typename Elem<INT8>::acc_t* __restrict__ val_out) {
  using E = Elem<INT8>;
  using T = typename E::acc_t;
  __shared__ uint32_t As[BN][KW + 1];
  __shared__ uint32_t Bs[BM][KW + 1];

  const int pair = blockIdx.y;
  const int row0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const uint32_t* a = A + (size_t)pair * N * Dw;
  const uint32_t* b = B + (size_t)pair * M * Dw;
  const T* bn = bnorm + (size_t)pair * M;
  const uint8_t* mk = mask2 + (size_t)pair * M;

  Top2<T> top[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) { top[r].b = top[r].s = E::big(); top[r].bi = top[r].si = 0; }

  for (int m0 = 0; m0 < M; m0 += BM) {
    T acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = T(0);

    for (int k0 = 0; k0 < Dw; k0 += KW) {
      for (int t = tid; t < BN * KW; t += NT) {
        const int r = t / KW, kk = t % KW;
        const int gr = row0 + r, gk = k0 + kk;
        As[r][kk] = (gr < N && gk < Dw) ? a[(size_t)gr * Dw + gk] : 0u;
        const int gm = m0 + r;
        Bs[r][kk] = (gm < M && gk < Dw) ? b[(size_t)gm * Dw + gk] : 0u;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < KW; ++kk) {
        uint32_t av[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) av[r] = As[ty + 16 * r][kk];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = Bs[tx + 16 * c][kk];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = E::mac(av[r], bv[c], acc[r][c]);
      }
      __syncthreads();
    }

    // fold this tile's columns (increasing order per thread) into the top-2
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = m0 + tx + 16 * c;
      if (col >= M || !mk[col]) continue;
      const T nrm = bn[col];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const T v = nrm - T(2) * acc[r][c];
        if (v < top[r].b) {
          top[r].s = top[r].b; top[r].si = top[r].bi;
          top[r].b = v; top[r].bi = col;
        } else if (v < top[r].s) {
          top[r].s = v; top[r].si = col;
        }
      }
    }
  }

  // merge across the 16 threads (tx) that share each row
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    Top2<T> t = top[r];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      Top2<T> o;
      o.b = __shfl_xor_sync(0xffffffffu, t.b, off);
      o.s = __shfl_xor_sync(0xffffffffu, t.s, off);
      o.bi = __shfl_xor_sync(0xffffffffu, t.bi, off);
      o.si = __shfl_xor_sync(0xffffffffu, t.si, off);
      t = merge(t, o);
    }
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

template <bool INT8>
int launch(const void* a, const void* b, const void* bnorm, const void* mask2,
           int B, int N, int M, int Dw, void* idx, void* val, void* stream) {
  using T = typename Elem<INT8>::acc_t;
  if (B > 0 && N > 0) {
    dim3 grid((N + BN - 1) / BN, B);
    knn2_kernel<INT8><<<grid, NT, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (const T*)bnorm,
        (const uint8_t*)mask2, N, M, Dw, (int*)idx, (T*)val);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// a: (B, N, D) int8 and b: (B, M, D) int8 with D = 4 * Dw; bnorm: (B, M)
// int32; mask2: (B, M) uint8; idx: (B, N, 2) int32; val: (B, N, 2) int32.
// Returns cudaGetLastError() after the launch.
extern "C" int knn2_i8_launch(const void* a, const void* b, const void* bnorm,
                              const void* mask2, int B, int N, int M, int Dw,
                              void* idx, void* val, void* stream) {
  return launch<true>(a, b, bnorm, mask2, B, N, M, Dw, idx, val, stream);
}

// As knn2_i8_launch with float32 a, b (D = Dw), bnorm and val.
extern "C" int knn2_f32_launch(const void* a, const void* b, const void* bnorm,
                               const void* mask2, int B, int N, int M, int Dw,
                               void* idx, void* val, void* stream) {
  return launch<false>(a, b, bnorm, mask2, B, N, M, Dw, idx, val, stream);
}
