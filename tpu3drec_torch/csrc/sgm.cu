// Semi-global cost aggregation, 4 directions, on the native (B, D, H, W)
// layout: the `sgm` kernel.
//
// Replaces the TPU kernel `tpu3drec/ops/pallas_sgm.py:_sgm_axis_pallas`
// (grid body `_sgm_kernel`, step `_dp_step`), which
// `sgm_aggregate_batch_pallas` calls once per axis. For every stream of
// costs c[x] along an axis the DP is
//
//     out[0] = c[0]
//     out[x] = (c[x] + best) - m,   m = min_d prev,
//     best   = min(min(prev, up + P1), min(dn + P1, m + P2)),
//     up[d]  = prev[d-1] (up[0] = prev[0]),  dn[d] = prev[d+1] (dn[D-1] = prev[D-1])
//
// run forward and backward along W (h) and along H (v); the result is
// (fwd_h + bwd_h) + (fwd_v + bwd_v). The float operations are the
// reference's, in its order, so the result equals the plain version bit
// for bit (float addition commutes, so which axis sum is added to which
// does not matter; the grouping does, and is kept).
//
// What bounds it: bytes. The function reads the volumes once and writes
// the result once at ~39 flops per element. No layout copy is made: both
// phases read (B, D, H, W) as it lies and write the result in place. One
// call enqueues two kernels in stream order:
//   - Phase V (along H, kernel sgm_v_kernel). A CTA of 16 warps owns 32
//     adjacent columns of one volume: lane = column, so every load and
//     store moves one 128-byte row segment; part k of the CTA holds
//     disparities [k NPT, k NPT + NPT) in registers. Per step the parts
//     swap their minima and edge disparities through shared memory (one
//     barrier, double-buffered). A per-warp cp.async ring keeps several
//     steps of loads in flight. Forward writes fwd_v into `out`; backward
//     reads it back and writes fwd_v + bwd_v.
//   - Phase H (along W, kernel sgm_h_kernel). Each warp of a two-warp CTA
//     owns a row (b, h); lane l holds disparities [l NPL, l NPL + NPL)
//     (min by one `redux.sync`). It stages [D, 16-column] chunks of the row
//     through shared memory with cp.async, one chunk ahead. Forward
//     writes fwd_h to `scratch`; backward reads the costs, fwd_h and
//     `out` (the V sum) and writes (fwd_h + bwd_h) + out.
// Volume passes: V reads the costs twice, writes twice and reads fwd_v
// once; H reads the costs twice, writes scratch once, reads it once and
// reads and writes `out` once: 11 passes against the bound's 2. A forward
// result does not fit on chip (a column or row of 64 disparities is 123 KB
// or 164 KB), so the extra passes stay. The native layout is contiguous
// only along W, so every access is a 64- or 128-byte fragment of a
// different DRAM row; the cp.async requests carry an L2::128B prefetch
// hint so that H's next chunk is fetched with the current one.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_NPL = 4;    // D <= 32 * MAX_NPL
constexpr int NT = 512;       // phase V: threads per CTA
constexpr int NW = NT / 32;   // phase V: warps per CTA
constexpr int V_COLS = 32;    // phase V: columns per CTA
constexpr int V_PARTS = NW * 32 / V_COLS;   // phase V: disparity parts
constexpr int V_RING_BYTES = 96 * 1024;   // phase V: cp.async ring per CTA
constexpr int H_WARPS = 2;    // phase H: warps per CTA, a row each
constexpr int WC = 16;        // phase H: columns per staged chunk
constexpr int H_SLOTS = 2;    // phase H: chunks staged per warp (ring)
constexpr int LD = WC + 1;    // padded chunk row: conflict-free both ways

// float -> int key whose signed order is the float order (finite or inf)
__device__ __forceinline__ int f2key(float f) {
  int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float key2f(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global.L2::128B [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float dp_best(float prev, float up, float dn,
                                         float m, float p1, float p2) {
  return fminf(fminf(prev, up + p1), fminf(dn + p1, m + p2));
}

// ---------------------------------------------------------------- phase V

// A CTA owns V_COLS adjacent columns of one volume: lane % V_COLS is the
// column, so every load and store instruction moves 32 / V_COLS row
// segments of 4 V_COLS bytes. Part p = k (32 / V_COLS) + lane / V_COLS of
// the CTA holds disparities [p NPT, p NPT + NPT) of its column.
template <int NPL>
struct VShape {
  static constexpr int NPT = 32 * NPL / V_PARTS;    // D <= V_PARTS * NPT
  static constexpr int STAGE = 2 * NPT * 32;        // floats: costs, fwd_v
  static constexpr int RING = V_RING_BYTES / (NW * STAGE * 4);
  static constexpr int STAGES = RING < 2 ? 2 : (RING > 16 ? 16 : RING);
};

// Per-step exchange between the parts of a column, double-buffered by
// step parity so that one barrier per step suffices.
struct VExchange {
  float lo[2][V_PARTS][V_COLS];   // each part's smallest disparity's value
  float hi[2][V_PARTS][V_COLS];   // and its largest's
  float mn[2][V_PARTS][V_COLS];   // and its min over its disparities
};

template <int NPL>
__device__ void v_columns(const float* __restrict__ vol, float* __restrict__ out,
                          int b, int g, int D, int H, int W, float p1, float p2,
                          float* sm, VExchange& ex) {
  constexpr int NPT = VShape<NPL>::NPT;
  constexpr int STAGE = VShape<NPL>::STAGE;
  constexpr int STAGES = VShape<NPL>::STAGES;
  const float INF = __int_as_float(0x7f800000);
  const int lane = threadIdx.x & 31, k = threadIdx.x >> 5;
  const int col = lane % V_COLS;
  const int part = k * (32 / V_COLS) + lane / V_COLS;
  const int d0 = part * NPT;
  const int w = g * V_COLS + col;
  const bool col_ok = w < W;
  const size_t plane = (size_t)H * W;
  const float* vb = vol + (size_t)b * D * plane + w;
  float* ob = out + (size_t)b * D * plane + w;
  float* ring = sm + k * STAGES * STAGE;

  for (int pass = 0; pass < 2; ++pass) {
    const bool bwd = pass == 1;
    // step i of this pass reads row h(i) into ring slot i % STAGES
    auto request = [&](int i) {
      if (col_ok && i < H) {
        const int h = bwd ? H - 1 - i : i;
        float* st = ring + (i % STAGES) * STAGE;
#pragma unroll
        for (int j = 0; j < NPT; ++j) {
          const int d = d0 + j;
          if (d < D) {
            const size_t off = (size_t)d * plane + (size_t)h * W;
            cp_async4(st + j * 32 + lane, vb + off);
            if (bwd) cp_async4(st + (NPT + j) * 32 + lane, ob + off);
          }
        }
      }
      cp_async_commit();
    };
    for (int i = 0; i < STAGES - 1; ++i) request(i);
    float prev[NPT];
    for (int i = 0; i < H; ++i) {
      request(i + STAGES - 1);
      cp_async_wait<STAGES - 1>();
      const float* st = ring + (i % STAGES) * STAGE;
      const int h = bwd ? H - 1 - i : i;
      if (i == 0) {
#pragma unroll
        for (int j = 0; j < NPT; ++j)
          prev[j] = d0 + j < D ? st[j * 32 + lane] : INF;
      } else {
        const int par = i & 1;
        float lm = prev[0];
#pragma unroll
        for (int j = 1; j < NPT; ++j) lm = fminf(lm, prev[j]);
        ex.mn[par][part][col] = lm;
        ex.lo[par][part][col] = prev[0];
        ex.hi[par][part][col] = prev[NPT - 1];
        __syncthreads();
        float m = ex.mn[par][0][col];
#pragma unroll
        for (int q = 1; q < V_PARTS; ++q) m = fminf(m, ex.mn[par][q][col]);
        const float up_in = part > 0 ? ex.hi[par][part - 1][col] : prev[0];
        const float dn_in =
            part < V_PARTS - 1 ? ex.lo[par][part + 1][col] : prev[NPT - 1];
        // in place, ascending d: `left` keeps the old prev[j - 1]
        float left = d0 == 0 ? prev[0] : up_in;
#pragma unroll
        for (int j = 0; j < NPT; ++j) {
          const int d = d0 + j;
          const float old = prev[j];
          float dn = j < NPT - 1 ? prev[j + 1] : dn_in;
          if (d == D - 1) dn = old;
          const float o =
              (st[j * 32 + lane] + dp_best(old, left, dn, m, p1, p2)) - m;
          prev[j] = d < D ? o : INF;
          left = old;
        }
      }
      if (col_ok) {
#pragma unroll
        for (int j = 0; j < NPT; ++j) {
          const int d = d0 + j;
          if (d < D) {
            const float v = bwd ? st[(NPT + j) * 32 + lane] + prev[j] : prev[j];
            ob[(size_t)d * plane + (size_t)h * W] = v;
          }
        }
      }
    }
    cp_async_wait<0>();
    __threadfence_block();   // the backward pass reads back fwd_v
    __syncthreads();         // the exchange buffers are reused
  }
}

// ---------------------------------------------------------------- phase H

// Phase H stages, per warp, a ring of H_SLOTS slots of three [D, WC]
// chunks (costs, fwd_h, out).
__host__ __device__ constexpr int h_chunk_floats(int D) { return D * LD; }

// One DP step along W: lane l holds disparities [l NPL, l NPL + NPL), so
// d - 1 and d + 1 are in registers but at the block edges (one shuffle
// each), and the min over D is a register min and one `redux.sync`.
template <int NPL>
__device__ __forceinline__ void h_step(float (&prev)[NPL], const float (&c)[NPL],
                                       int lane, int D, float p1, float p2) {
  const float INF = __int_as_float(0x7f800000);
  float lm = prev[0];
#pragma unroll
  for (int j = 1; j < NPL; ++j) lm = fminf(lm, prev[j]);
  const float m = key2f(__reduce_min_sync(FULL, f2key(lm)));
  const float up_in = __shfl_up_sync(FULL, prev[NPL - 1], 1);
  const float dn_in = __shfl_down_sync(FULL, prev[0], 1);
  // in place, ascending d: `left` keeps the old prev[j - 1]
  float left = lane == 0 ? prev[0] : up_in;
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    const int d = lane * NPL + j;
    const float old = prev[j];
    float dn = j < NPL - 1 ? prev[j + 1] : dn_in;
    if (d == D - 1) dn = old;
    const float o = (c[j] + dp_best(old, left, dn, m, p1, p2)) - m;
    prev[j] = d < D ? o : INF;
    left = old;
  }
}

// Row h of volume b, forward (into scratch) then backward (into out).
template <int NPL>
__device__ void h_row(const float* __restrict__ vol, float* __restrict__ scratch,
                      float* __restrict__ out, int b, int h, int D, int H,
                      int W, float p1, float p2, float* sm) {
  const float INF = __int_as_float(0x7f800000);
  const int lane = threadIdx.x & 31;
  const size_t plane = (size_t)H * W;
  const size_t row = (size_t)b * D * plane + (size_t)h * W;
  const int buf = h_chunk_floats(D);
  const int nch = (W + WC - 1) / WC;
  auto chunk = [&](int n, int kind) {
    return sm + ((n % H_SLOTS) * 3 + kind) * buf;
  };

  for (int pass = 0; pass < 2; ++pass) {
    const bool bwd = pass == 1;
    auto request = [&](int n) {      // the n-th chunk this pass visits
      if (n < nch) {
        const int w0 = (bwd ? nch - 1 - n : n) * WC;
        float* c0 = chunk(n, 0);
        float* c1 = chunk(n, 1);
        float* c2 = chunk(n, 2);
        for (int e = lane; e < D * WC; e += 32) {
          const int d = e / WC, t = e % WC;
          if (w0 + t < W) {
            const size_t off = row + (size_t)d * plane + w0 + t;
            cp_async4(c0 + d * LD + t, vol + off);
            if (bwd) {
              cp_async4(c1 + d * LD + t, scratch + off);
              cp_async4(c2 + d * LD + t, out + off);
            }
          }
        }
      }
      cp_async_commit();
    };
    for (int n = 0; n < H_SLOTS - 1; ++n) request(n);
    float prev[NPL];
    for (int n = 0; n < nch; ++n) {
      request(n + H_SLOTS - 1);
      cp_async_wait<H_SLOTS - 1>();
      __syncwarp();
      const int w0 = (bwd ? nch - 1 - n : n) * WC;
      const int nw = min(WC, W - w0);
      float* cc = chunk(n, 0);
      const float* cf = chunk(n, 1);
      float* co = chunk(n, 2);
      for (int s = 0; s < nw; ++s) {
        const int t = bwd ? nw - 1 - s : s;
        float c[NPL];
#pragma unroll
        for (int j = 0; j < NPL; ++j) {
          const int d = lane * NPL + j;
          c[j] = d < D ? cc[d * LD + t] : INF;
        }
        if (n == 0 && s == 0) {
#pragma unroll
          for (int j = 0; j < NPL; ++j) prev[j] = c[j];
        } else {
          h_step<NPL>(prev, c, lane, D, p1, p2);
        }
#pragma unroll
        for (int j = 0; j < NPL; ++j) {
          const int d = lane * NPL + j;
          if (d < D) {
            if (bwd)
              co[d * LD + t] = (cf[d * LD + t] + prev[j]) + co[d * LD + t];
            else
              cc[d * LD + t] = prev[j];
          }
        }
      }
      __syncwarp();
      const float* src = bwd ? co : cc;
      float* dst = (bwd ? out : scratch) + row + w0;
      for (int e = lane; e < D * WC; e += 32) {
        const int d = e / WC, t = e % WC;
        if (t < nw) dst[(size_t)d * plane + t] = src[d * LD + t];
      }
      __syncwarp();   // the slot is refilled next
    }
    cp_async_wait<0>();
    __threadfence_block();   // the backward pass reads back fwd_h
    __syncwarp();
  }
}

// ----------------------------------------------------------- the kernels

template <int NPL>
__global__ void __launch_bounds__(NT)
sgm_v_kernel(const float* __restrict__ vol, float* __restrict__ out, int B,
             int D, int H, int W, float p1, float p2) {
  extern __shared__ __align__(16) float sm[];
  __shared__ VExchange ex;
  const int ng = (W + V_COLS - 1) / V_COLS;
  for (int it = blockIdx.x; it < B * ng; it += gridDim.x)
    v_columns<NPL>(vol, out, it / ng, it % ng, D, H, W, p1, p2, sm, ex);
}

template <int NPL>
__global__ void __launch_bounds__(32 * H_WARPS)
sgm_h_kernel(const float* __restrict__ vol, float* __restrict__ out,
             float* __restrict__ scratch, int B, int D, int H, int W,
             float p1, float p2) {
  extern __shared__ __align__(16) float sm[];
  const int k = threadIdx.x >> 5;
  float* mine = sm + k * H_SLOTS * 3 * h_chunk_floats(D);
  for (int it = blockIdx.x * H_WARPS + k; it < B * H; it += gridDim.x * H_WARPS)
    h_row<NPL>(vol, scratch, out, it / H, it % H, D, H, W, p1, p2, mine);
}

// A grid of as many CTAs as fit on the card at once, `smem` bytes each.
template <typename K>
cudaError_t resident_grid(K kern, int threads, size_t smem, int* grid) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                      smem);
  if (e == cudaSuccess && per_sm < 1) e = cudaErrorInvalidConfiguration;
  *grid = sms * per_sm;
  return e;
}

template <int NPL>
int launch(const float* vol, float* out, float* scratch, int B, int D, int H,
           int W, float p1, float p2, cudaStream_t stream) {
  int grid = 0;
  size_t smem = (size_t)NW * VShape<NPL>::STAGES * VShape<NPL>::STAGE * 4;
  cudaError_t e = resident_grid(sgm_v_kernel<NPL>, NT, smem, &grid);
  if (e != cudaSuccess) return (int)e;
  sgm_v_kernel<NPL><<<grid, NT, smem, stream>>>(vol, out, B, D, H, W, p1, p2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  smem = (size_t)H_WARPS * H_SLOTS * 3 * h_chunk_floats(D) * 4;
  e = resident_grid(sgm_h_kernel<NPL>, 32 * H_WARPS, smem, &grid);
  if (e != cudaSuccess) return (int)e;
  sgm_h_kernel<NPL><<<grid, 32 * H_WARPS, smem, stream>>>(
      vol, out, scratch, B, D, H, W, p1, p2);
  return (int)cudaGetLastError();
}

}  // namespace

// Aggregate (B, D, H, W) float32 volumes `vol` into `out` (same shape) with
// `scratch` (same shape, contents ignored) for the horizontal forward
// result: the V kernel, then in stream order the H kernel. P1 and P2 are
// p1x100 / 100 and p2x100 / 100 rounded to float, as the reference's.
// Returns the first CUDA launch error (0 on success).
extern "C" int sgm_launch(const float* vol, float* out, float* scratch, int B,
                          int D, int H, int W, int p1x100, int p2x100,
                          cudaStream_t stream) {
  if (D < 1 || D > 32 * MAX_NPL) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return 0;
  const float p1 = (float)(p1x100 / 100.0);
  const float p2 = (float)(p2x100 / 100.0);
  switch ((D + 31) / 32) {
    case 1: return launch<1>(vol, out, scratch, B, D, H, W, p1, p2, stream);
    case 2: return launch<2>(vol, out, scratch, B, D, H, W, p1, p2, stream);
    case 3: return launch<3>(vol, out, scratch, B, D, H, W, p1, p2, stream);
    default: return launch<4>(vol, out, scratch, B, D, H, W, p1, p2, stream);
  }
}
