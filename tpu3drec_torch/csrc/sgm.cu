// Semi-global cost aggregation along one axis, both directions: the `sgm`
// kernel.
//
// Replaces the TPU kernel `tpu3drec/ops/pallas_sgm.py:_sgm_axis_pallas`
// (grid body `_sgm_kernel`, step `_dp_step`), which
// `sgm_aggregate_batch_pallas` calls once per axis. Input is a cost volume
// laid out (X, S, D): X steps along the scan axis, S independent streams,
// D disparities contiguous. For every stream the kernel runs the DP
//
//     out[0] = c[0]
//     out[x] = (c[x] + best) - m,   m = min_d prev,
//     best   = min(min(prev, up + P1), min(dn + P1, m + P2)),
//     up[d]  = prev[d-1] (up[0] = prev[0]),  dn[d] = prev[d+1] (dn[D-1] = prev[D-1])
//
// forward (x = 0..X-1) and then backward (x = X-1..0), and writes
// forward + backward. The float operations are the reference's, in its
// order, so the result equals the plain version bit for bit.
//
// Design. One warp per stream: lane l holds disparities [l*NPL, l*NPL+NPL)
// in registers (NPL = ceil(D/32), D <= 128). The min over D is a local
// min and one warp `redux.sync` on order-preserving integer keys; d-1 and
// d+1 cross lanes with one `shfl.up` and one `shfl.down`. The backward
// pass reads back the forward result the same lanes wrote, so the sum
// needs no second buffer and no atomics. Both axes of a volume batch go
// in one launch: warps [0, S_a) scan axis a, warps [S_a, S_a + S_b) axis b.
// The TPU kernel's concatenation of the reversed volume and its row
// chunking (VMEM limits) have no counterpart: the backward stream reads
// by index.
//
// Bound on the card: the function reads the volume once and writes it
// once, ~4 flops per element per direction, so it is bound by bytes. This
// kernel moves more than that: per axis it reads the volume twice and the
// forward result once and writes twice (5 volume passes), and each stream
// is a serial chain of 2X steps whose loads are issued one step ahead.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_NPL = 4;  // D <= 32 * MAX_NPL

// float -> int key whose signed order is the float order (finite inputs)
__device__ __forceinline__ int f2key(float f) {
  int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float key2f(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

template <int NPL>
__device__ __forceinline__ void load_col(const float* __restrict__ p, int d0,
                                         int D, float (&v)[NPL]) {
#pragma unroll
  for (int j = 0; j < NPL; ++j) v[j] = (d0 + j < D) ? __ldg(p + d0 + j) : 0.f;
}

// One direction of one stream. BACKWARD adds into what the forward pass
// wrote at the same addresses.
template <int NPL, bool BACKWARD>
__device__ __forceinline__ void dp_stream(const float* __restrict__ vs,
                                          float* __restrict__ os, int X,
                                          size_t step, int D, int lane,
                                          float p1, float p2) {
  const int d0 = lane * NPL;
  float prev[NPL], c[NPL], nxt[NPL], o[NPL];
  int x = BACKWARD ? X - 1 : 0;
  load_col<NPL>(vs + (size_t)x * step, d0, D, c);
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    const bool on = d0 + j < D;
    prev[j] = on ? c[j] : __int_as_float(0x7f800000);  // +inf off the end
    if (on) {
      float* q = os + (size_t)x * step + d0 + j;
      *q = BACKWARD ? *q + c[j] : c[j];
    }
  }
  if (X > 1) load_col<NPL>(vs + (size_t)(BACKWARD ? X - 2 : 1) * step, d0, D, nxt);
  for (int i = 1; i < X; ++i) {
    x = BACKWARD ? X - 1 - i : i;
#pragma unroll
    for (int j = 0; j < NPL; ++j) c[j] = nxt[j];
    if (i + 1 < X)
      load_col<NPL>(vs + (size_t)(BACKWARD ? X - 2 - i : i + 1) * step, d0, D,
                    nxt);
    float* orow = os + (size_t)x * step + d0;
    if (BACKWARD) {
#pragma unroll
      for (int j = 0; j < NPL; ++j) o[j] = (d0 + j < D) ? orow[j] : 0.f;
    }
    // m = min over all D of prev
    float lm = prev[0];
#pragma unroll
    for (int j = 1; j < NPL; ++j) lm = fminf(lm, prev[j]);
    const float m = key2f(__reduce_min_sync(FULL, f2key(lm)));
    const float up_in = __shfl_up_sync(FULL, prev[NPL - 1], 1);
    const float dn_in = __shfl_down_sync(FULL, prev[0], 1);
    float out[NPL];
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      const int d = d0 + j;
      const float up = j > 0 ? prev[j - 1] : (d == 0 ? prev[0] : up_in);
      float dn = j < NPL - 1 ? prev[j + 1] : dn_in;
      if (d == D - 1) dn = prev[j];
      const float best = fminf(fminf(prev[j], up + p1), fminf(dn + p1, m + p2));
      out[j] = (c[j] + best) - m;
    }
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      if (d0 + j < D) {
        prev[j] = out[j];
        orow[j] = BACKWARD ? o[j] + out[j] : out[j];
      }
    }
  }
}

template <int NPL>
__global__ void sgm_axes_kernel(const float* __restrict__ va,
                                float* __restrict__ oa, int Xa, int Sa,
                                const float* __restrict__ vb,
                                float* __restrict__ ob, int Xb, int Sb, int D,
                                float p1, float p2) {
  const int warp = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  const float* v;
  float* o;
  int X, S, s;
  if (warp < Sa) {
    v = va; o = oa; X = Xa; S = Sa; s = warp;
  } else if (warp < Sa + Sb) {
    v = vb; o = ob; X = Xb; S = Sb; s = warp - Sa;
  } else {
    return;  // whole warps only: blockDim is a multiple of 32
  }
  const size_t step = (size_t)S * D;
  const float* vs = v + (size_t)s * D;
  float* os = o + (size_t)s * D;
  dp_stream<NPL, false>(vs, os, X, step, D, lane, p1, p2);
  dp_stream<NPL, true>(vs, os, X, step, D, lane, p1, p2);
}

}  // namespace

// Aggregate volume a (Xa, Sa, D) into oa and volume b (Xb, Sb, D) into ob,
// each output = forward + backward DP along its axis 0. P1 and P2 are
// p1x100 / 100 and p2x100 / 100 rounded to float, as the reference's.
// Returns the CUDA launch error (0 on success).
extern "C" int sgm_axes_launch(const float* va, float* oa, int Xa, int Sa,
                               const float* vb, float* ob, int Xb, int Sb,
                               int D, int p1x100, int p2x100,
                               cudaStream_t stream) {
  if (D < 1 || D > 32 * MAX_NPL) return (int)cudaErrorInvalidValue;
  const float p1 = (float)(p1x100 / 100.0);
  const float p2 = (float)(p2x100 / 100.0);
  const int threads = 256;
  const long long warps = (long long)Sa + Sb;
  if (warps == 0) return 0;
  const unsigned blocks = (unsigned)((warps * 32 + threads - 1) / threads);
  const int npl = (D + 31) / 32;
  switch (npl) {
    case 1:
      sgm_axes_kernel<1><<<blocks, threads, 0, stream>>>(va, oa, Xa, Sa, vb, ob,
                                                         Xb, Sb, D, p1, p2);
      break;
    case 2:
      sgm_axes_kernel<2><<<blocks, threads, 0, stream>>>(va, oa, Xa, Sa, vb, ob,
                                                         Xb, Sb, D, p1, p2);
      break;
    case 3:
      sgm_axes_kernel<3><<<blocks, threads, 0, stream>>>(va, oa, Xa, Sa, vb, ob,
                                                         Xb, Sb, D, p1, p2);
      break;
    default:
      sgm_axes_kernel<4><<<blocks, threads, 0, stream>>>(va, oa, Xa, Sa, vb, ob,
                                                         Xb, Sb, D, p1, p2);
      break;
  }
  return (int)cudaGetLastError();
}
