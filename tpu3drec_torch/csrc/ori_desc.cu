// SIFT orientation + descriptor per keypoint slot, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpu3drec/ops/pallas_sample.py:ori_desc_windows
// (body _ori_desc_kernel). It computes the function that the reference's
// oracle_ori_desc defines, with the kernel's own quantisation: for each slot,
// a 36-bin orientation histogram over a 56-row band around the keypoint
// (Gaussian weights, two [1 4 6 4 1]/16 smoothings, first argmax, parabolic
// peak), then the rotated 4x4x8 descriptor computed densely over an 88x128
// window (orientation tents, 4x4 box cells, trilinear spatial bins). The raw
// (16, 8) histogram is written out; normalisation runs in PyTorch.
//
// What bounds it: arithmetic, not bytes. A valid slot reads 2 x 96 x 128 bf16
// (48 KB, mostly from L2: windows of neighbouring keypoints overlap) and does
// an atan2, a sqrt and two exp per window pixel plus 8 tent products. The
// design keeps every intermediate on chip:
//   - one CTA (256 threads) per slot; an invalid slot writes zeros and exits
//     before touching shared memory;
//   - the 96x128 window of both channels is loaded once, coalesced, into
//     shared memory as bf16, with pixels outside the octave image stored as
//     zero (this is the reference's `inside` mask);
//   - the histogram is accumulated per thread (one shared-memory column each)
//     and reduced across threads in a fixed order: no float atomics, the same
//     bits on every run;
//   - one thread owns one 4x4 cell of the 22x32 coarse grid and sums its 8
//     orientation tents; cells whose every pixel is outside the descriptor
//     support are skipped (they contribute exact zeros);
//   - then one thread per (spatial bin, orientation, half of the cells) sums
//     the trilinear weights, and the two halves are added in a fixed order.
// Native atan2f replaces the reference's polynomial (which exists only
// because Mosaic has no atan); its error is far below the parity bars.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int WIN_H = 96;
constexpr int CORE_H = 88;
constexpr int CORE_W = 128;
constexpr int ORI_H = 56;
constexpr int CELL = 4;
constexpr int CH = CORE_H / CELL;   // 22
constexpr int CW = CORE_W / CELL;   // 32
constexpr int NCELL = CH * CW;      // 704
constexpr int ORI_BINS = 36;
constexpr int DESC_D = 4;
constexpr int DESC_B = 8;
constexpr int NOUT = DESC_D * DESC_D * DESC_B;  // 128
constexpr int NT = 256;
constexpr float ORI_RADIUS = 4.5f;
constexpr float PI_F = 3.14159265358979323846f;
constexpr float TWO_PI_F = 6.28318530717958647692f;

constexpr int WIN_ELEMS = WIN_H * CORE_W;
constexpr int WIN_BYTES = 2 * WIN_ELEMS * 2;                  // dx + dy, bf16
constexpr int HIST_BYTES = ORI_BINS * NT * 4;                 // per-thread columns
constexpr int DESC_BYTES = (NCELL * DESC_B + 2 * NCELL) * 4;  // coarse + bins
constexpr int UNION_BYTES = HIST_BYTES > DESC_BYTES ? HIST_BYTES : DESC_BYTES;
constexpr int SMEM_BYTES = WIN_BYTES + UNION_BYTES;

__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

__device__ __forceinline__ int floor_mod(int a, int b) {
  int r = a % b;
  return r < 0 ? r + b : r;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// jnp.remainder for a positive float modulus: fmod shifted into [0, m)
__device__ __forceinline__ float fmod_floor(float x, float m) {
  float r = fmodf(x, m);
  return (r != 0.f && r < 0.f) ? r + m : r;
}

__global__ void __launch_bounds__(NT)
ori_desc_kernel(const __nv_bfloat16* __restrict__ dxs,
                const __nv_bfloat16* __restrict__ dys,
                const int4* __restrict__ meta, int h, int w, int hp, int fb,
                float* __restrict__ angle_out, float* __restrict__ raw_out) {
  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const int4 mt = meta[k];   // xq, yq, sclq, layer
  float* raw = raw_out + (size_t)k * NOUT;
  if (mt.w < 0) {
    if (tid < NOUT) raw[tid] = 0.f;
    if (tid == 0) angle_out[k] = 0.f;
    return;
  }

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* win_dx = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* win_dy = win_dx + WIN_ELEMS;
  float* hist_part = reinterpret_cast<float*>(smem + WIN_BYTES);
  float* coarse = hist_part;                 // reused after the histogram
  float* rbin_s = coarse + NCELL * DESC_B;
  float* cbin_s = rbin_s + NCELL;
  __shared__ float hist[ORI_BINS];
  __shared__ float s_angle;
  __shared__ float partial[NT];

  // ---- keypoint geometry (the reference's fixed-point arithmetic)
  const float inv_q = 1.0f / (float)(1 << fb);
  const float x = (float)mt.x * inv_q;
  const float y = (float)mt.y * inv_q;
  const float scl = (float)mt.z * (1.0f / 1024.0f);
  const int half = 1 << (fb - 1);
  const int rxi = (mt.x + half) >> fb;
  const int ryi = (mt.y + half) >> fb;
  const int y0 = clampi(floor_div(ryi - 44, 8) * 8, 0, hp - WIN_H);
  const int yoff = ryi - y0;
  const int row0 = clampi(floor_div(yoff - 40, 8) * 8, 0, WIN_H - CORE_H);
  const int row0b = clampi(floor_div(yoff - ORI_H / 2, 8) * 8, 0, WIN_H - ORI_H);
  const int xs0 = rxi - 64;

  // ---- window load: rows [y0, y0+96), cols [xs0, xs0+128); zero outside
  const size_t plane = (size_t)h * w;
  const __nv_bfloat16* gdx = dxs + (size_t)mt.w * plane;
  const __nv_bfloat16* gdy = dys + (size_t)mt.w * plane;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int p = tid; p < WIN_ELEMS; p += NT) {
    const int r = y0 + p / CORE_W;
    const int c = xs0 + p % CORE_W;
    const bool in = (r >= 0) && (r < h) && (c >= 0) && (c < w);
    const size_t off = in ? (size_t)r * w + c : 0;
    win_dx[p] = in ? gdx[off] : zero;
    win_dy[p] = in ? gdy[off] : zero;
  }
  for (int b = 0; b < ORI_BINS; ++b) hist_part[b * NT + tid] = 0.f;
  __syncthreads();

  // ---- orientation histogram over the band rows [row0b, row0b + 56)
  const float inv_scl = 1.0f / scl;
  for (int p = tid; p < ORI_H * CORE_W; p += NT) {
    const int i = p / CORE_W;
    const int j = p % CORE_W;
    const float ub = ((float)(rxi + (j - 64)) - x) * inv_scl;
    const float vb = ((float)(y0 + row0b + i) - y) * inv_scl;
    if (!(fabsf(ub) <= ORI_RADIUS && fabsf(vb) <= ORI_RADIUS)) continue;
    const int wi = (row0b + i) * CORE_W + j;
    const float gx = __bfloat162float(win_dx[wi]);
    const float gy = __bfloat162float(win_dy[wi]);
    const float mag = sqrtf(gx * gx + gy * gy);
    const float theta = atan2f(gy, gx);
    const float wgt = expf(-(ub * ub + vb * vb) / 4.5f);
    const float binf = (theta / TWO_PI_F + 0.5f) * (float)ORI_BINS;
    const float b0f = floorf(binf);
    const int b0 = floor_mod((int)b0f, ORI_BINS);
    const float frac = binf - b0f;
    const float w_all = mag * wgt;
    hist_part[b0 * NT + tid] += w_all * (1.f - frac);
    hist_part[((b0 + 1) % ORI_BINS) * NT + tid] += w_all * frac;
  }
  __syncthreads();

  // fixed-order reduction: warp wid owns bins wid, wid+8, ...
  const int lane = tid & 31;
  const int wid = tid >> 5;
  for (int b = wid; b < ORI_BINS; b += NT / 32) {
    float s = 0.f;
    for (int t = lane; t < NT; t += 32) s += hist_part[b * NT + t];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) hist[b] = s;
  }
  __syncthreads();

  if (tid == 0) {
    float h1[ORI_BINS], h2[ORI_BINS];
    for (int j = 0; j < ORI_BINS; ++j)
      h1[j] = (6.f * hist[j] + 4.f * (hist[(j + 35) % 36] + hist[(j + 1) % 36])
               + hist[(j + 34) % 36] + hist[(j + 2) % 36]) / 16.f;
    for (int j = 0; j < ORI_BINS; ++j)
      h2[j] = (6.f * h1[j] + 4.f * (h1[(j + 35) % 36] + h1[(j + 1) % 36])
               + h1[(j + 34) % 36] + h1[(j + 2) % 36]) / 16.f;
    int pk = 0;
    float best = h2[0];
    for (int j = 1; j < ORI_BINS; ++j)
      if (h2[j] > best) { best = h2[j]; pk = j; }
    const float hl = h2[(pk + 35) % 36], hc = h2[pk], hr = h2[(pk + 1) % 36];
    const float denom = hl - 2.f * hc + hr;
    const float dbin = fabsf(denom) > 1e-12f ? 0.5f * (hl - hr) / denom : 0.f;
    s_angle = (fmod_floor((float)pk + dbin, (float)ORI_BINS) / (float)ORI_BINS
               - 0.5f) * 2.f * PI_F;
  }
  __syncthreads();
  const float angle = s_angle;

  // ---- descriptor: one thread per 4x4 cell of the 88x128 core
  const float ca = cosf(angle), sa = sinf(angle);
  const float inv_hw = 1.0f / (3.0f * scl);
  // a pixel lies within 1.5*sqrt(2) px of its cell centre, so a cell whose
  // centre is this far outside the support |u|,|v| < 2.5 has no pixel in it
  const float margin = 2.1214f * inv_hw + 1e-3f;
  const int ybase = y0 + row0;
  for (int c = tid; c < NCELL; c += NT) {
    const int ci = c / CW, cj = c % CW;
    const float rx_c = ((float)xs0 + (float)(CELL * cj) + 1.5f) - x;
    const float ry_c = ((float)ybase + (float)(CELL * ci) + 1.5f) - y;
    const float ud_c = (ca * rx_c + sa * ry_c) * inv_hw;
    const float vd_c = (-sa * rx_c + ca * ry_c) * inv_hw;
    rbin_s[c] = vd_c + 1.5f;
    cbin_s[c] = ud_c + 1.5f;
    float acc[DESC_B];
#pragma unroll
    for (int o = 0; o < DESC_B; ++o) acc[o] = 0.f;
    if (fabsf(ud_c) < 2.5f + margin && fabsf(vd_c) < 2.5f + margin) {
      for (int ii = 0; ii < CELL; ++ii) {
        const int wr = row0 + CELL * ci + ii;
        const float ry = (float)(y0 + wr) - y;
        for (int jj = 0; jj < CELL; ++jj) {
          const int wc = CELL * cj + jj;
          const float rx = (float)(rxi + (wc - 64)) - x;
          const float ud = (ca * rx + sa * ry) * inv_hw;
          const float vd = (-sa * rx + ca * ry) * inv_hw;
          if (!((vd + 1.5f > -1.f) && (vd + 1.5f < 4.f) &&
                (ud + 1.5f > -1.f) && (ud + 1.5f < 4.f)))
            continue;
          const float gx = __bfloat162float(win_dx[wr * CORE_W + wc]);
          const float gy = __bfloat162float(win_dy[wr * CORE_W + wc]);
          const float mag = sqrtf(gx * gx + gy * gy);
          const float theta = atan2f(gy, gx);
          const float wd = expf(-(ud * ud + vd * vd) / 8.f);
          const float obin = fmod_floor((theta - angle) / TWO_PI_F, 1.f) * (float)DESC_B;
          const float magw = mag * wd;
#pragma unroll
          for (int o = 0; o < DESC_B; ++o) {
            const float d = fabsf(obin - (float)o);
            acc[o] += magw * fmaxf(0.f, 1.f - fminf(d, (float)DESC_B - d));
          }
        }
      }
    }
#pragma unroll
    for (int o = 0; o < DESC_B; ++o) coarse[c * DESC_B + o] = acc[o];
  }
  __syncthreads();

  // ---- trilinear spatial binning: output (r*4 + c, o), two halves of cells
  {
    const int out = tid & (NOUT - 1);
    const int hlf = tid / NOUT;
    const int o = out % DESC_B;
    const int rc = out / DESC_B;
    const float rr = (float)(rc / DESC_D);
    const float cc = (float)(rc % DESC_D);
    float s = 0.f;
    const int c_lo = hlf * (NCELL / 2), c_hi = c_lo + NCELL / 2;
    for (int cell = c_lo; cell < c_hi; ++cell) {
      const float tr = fmaxf(0.f, 1.f - fabsf(rbin_s[cell] - rr));
      const float tc = fmaxf(0.f, 1.f - fabsf(cbin_s[cell] - cc));
      s += tr * tc * coarse[cell * DESC_B + o];
    }
    partial[tid] = s;
  }
  __syncthreads();
  if (tid < NOUT) raw[tid] = partial[tid] + partial[tid + NOUT];
  if (tid == 0) angle_out[k] = angle;
}

}  // namespace

// Launch on `stream`. dxs, dys: (L, h, w) bf16; meta: (K, 4) int32
// [xq, yq, sclq, layer] (layer -1 = invalid slot); angle: (K,) f32;
// raw: (K, 16, 8) f32. Returns cudaGetLastError() after the launch.
extern "C" int ori_desc_launch(const void* dxs, const void* dys,
                               const void* meta, int K, int h, int w, int hp,
                               int fb, void* angle, void* raw, void* stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        ori_desc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  if (K > 0) {
    ori_desc_kernel<<<K, NT, SMEM_BYTES, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)dxs, (const __nv_bfloat16*)dys,
        (const int4*)meta, h, w, hp, fb, (float*)angle, (float*)raw);
  }
  return (int)cudaGetLastError();
}
