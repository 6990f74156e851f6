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
// What bounds it: arithmetic, not bytes. Per support pixel it does an
// atan2, a sqrt, a Gaussian weight per pass and the orientation tents; the
// bytes (each support pixel's two bf16 gradients, mostly from L2) are
// small beside that. So the design spends instructions only where a pixel
// can carry weight, and keeps the SM full while doing it:
//   - Only valid slots are visited, with no host sync and no work before
//     the call. One C call enqueues a memset of two counters, a listing
//     kernel (a thread a slot: each warp ballots its valid slots, appends
//     them to a list in device memory with one atomic, and zeroes its
//     invalid slots' outputs, a float4 a lane), and the main kernel: a
//     persistent grid of as many CTAs as fit on the card, taking list
//     entries one at a time from a device counter. Which CTA takes a slot
//     does not change its result, so the list's order does not matter.
//   - Only each slot's support is loaded. Each slot's box is the one that
//     ops/pallas_sample.py:support_boxes defines (the band box and the
//     rotation-invariant descriptor box, clipped to the window and the
//     image), computed here with the same uncontracted float32 operations;
//     the launch can write the boxes out so that a check holds them against
//     that function. Inside the box, only pixels within the support disc
//     (r_fctr * scl + slack px) are loaded and computed; no pass reads the
//     rest with a non-zero weight. Loads are coalesced along rows, 8 bytes
//     (4 bf16) a thread where the row stride and base allow it.
//   - Each pixel's magnitude and angle are computed once, into shared
//     memory as f32, and read by both passes; only the Gaussian weights,
//     which differ between the passes, are computed in each. A box larger
//     than the cache (only for scales beyond the detector's range) takes
//     the same code with the pixel computed from global memory instead.
//   - The descriptor visits only the 4x4 cells whose centre lies within the
//     support's margin (a per-slot list, compacted with a ballot in cell
//     order); skipped cells and pixels add exact zeros in the plain version.
//   - Shared memory is the 51,200 B cache plus ~2.4 KB, so 4 CTAs of 256
//     threads fit on an SM.
//   - Deterministic sums, no float atomics: 4 warps keep per-thread 36-bin
//     histograms in registers, reduced by a fixed xor butterfly per warp
//     and then over warps in order; 36 threads smooth, one warp takes the
//     first argmax. Four lanes compute one 4x4 cell (one row each) and add
//     by a fixed butterfly; each lane then adds its two orientations of
//     the cell, times the 16 trilinear weights, into registers in cell
//     order; lanes and warps are added by fixed butterflies and in order.
// Intrinsics: __expf for both Gaussian weights and __fdividef in atan2,
// which is a polynomial (fast_atan2, 3e-7 rad; the reference also uses a
// polynomial, because Mosaic has no atan). sqrtf, cosf and sinf are the
// precise library versions.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int ORI_H = 56;
constexpr int CELL = 4;
constexpr int CH = 88 / CELL;       // 22 cell rows in the core
constexpr int CW = 128 / CELL;      // 32 cell columns
constexpr int ORI_BINS = 36;
constexpr int DESC_D = 4;
constexpr int DESC_B = 8;
constexpr int NOUT = DESC_D * DESC_D * DESC_B;  // 128
constexpr int NT = 256;
constexpr int NWARP = NT / 32;
constexpr int MIN_CTAS = 4;
constexpr int BAND_WARPS = 4;   // warps that build the orientation histogram
constexpr unsigned FULL = 0xffffffffu;
constexpr float ORI_RADIUS = 4.5f;
constexpr float PI_F = 3.14159265358979323846f;
constexpr float INV_TWO_PI_F = 0.159154943091895335769f;

constexpr int CACHE_PX = 6400;                   // 80 x 80 pixels
constexpr int SMEM_BYTES = CACHE_PX * 2 * 4;     // magnitude + angle, f32
static_assert(NWARP * NOUT <= 2 * CACHE_PX, "output partials fit the cache");

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

// atan2 from the degree-16 Hastings polynomial for atan on [0, 1]
// (relative error 2e-8; 3e-7 rad after float32 rounding, checked against
// numpy's arctan2): a division and nine FMAs instead of atan2f.
__device__ __forceinline__ float fast_atan2(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float mx = fmaxf(ax, ay), mn = fminf(ax, ay);
  const float a = mx > 0.f ? __fdividef(mn, mx) : 0.f;
  const float s = a * a;
  float p = 0.0028662257f;
  p = p * s - 0.0161657367f;
  p = p * s + 0.0429096138f;
  p = p * s - 0.0752896400f;
  p = p * s + 0.1065626393f;
  p = p * s - 0.1420889944f;
  p = p * s + 0.1999355085f;
  p = p * s - 0.3333314528f;
  p = p * s + 1.0f;
  float r = a * p;
  if (ay > ax) r = 1.57079632679489661923f - r;
  if (x < 0.f) r = PI_F - r;
  return copysignf(r, y);
}

__device__ __forceinline__ void mag_theta(float gx, float gy, float& mag,
                                          float& theta) {
  mag = sqrtf(gx * gx + gy * gy);
  theta = fast_atan2(gy, gx);
}

// One slot's geometry (the reference's fixed-point arithmetic) and its
// support box, computed as ops/pallas_sample.py:support_boxes computes it
// (the same float32 operations, uncontracted, so the same integers).
struct Slot {
  float x, y, scl;
  int ys0, ysb, xs0;        // core / band first rows, window first column
  int r0, r1, c0, c1;       // support box, half-open, image coordinates
  int br0, br1, bc0, bc1;   // its orientation-band part
  const __nv_bfloat16* gdx;
  const __nv_bfloat16* gdy;
};

// [ceil(c - r), floor(c + r)] as a half-open span, clipped to [lo, hi)
__device__ __forceinline__ void span(float c, float r, int lo, int hi, int& a,
                                     int& b) {
  a = max((int)ceilf(__fsub_rn(c, r)), lo);
  b = min((int)floorf(__fadd_rn(c, r)) + 1, hi);
}

__device__ __forceinline__ Slot make_slot(int4 mt, const __nv_bfloat16* dxs,
                                          const __nv_bfloat16* dys, int h,
                                          int w, int hp, int fb, float r_fctr,
                                          float slack) {
  Slot s;
  const float inv_q = 1.0f / (float)(1 << fb);
  s.x = (float)mt.x * inv_q;
  s.y = (float)mt.y * inv_q;
  s.scl = (float)mt.z * (1.0f / 1024.0f);
  const int half = 1 << (fb - 1);
  const int rxi = (mt.x + half) >> fb;
  const int ryi = (mt.y + half) >> fb;
  const int y0 = clampi(floor_div(ryi - 44, 8) * 8, 0, hp - 96);
  const int yoff = ryi - y0;
  s.ys0 = y0 + clampi(floor_div(yoff - 40, 8) * 8, 0, 96 - 88);
  s.ysb = y0 + clampi(floor_div(yoff - ORI_H / 2, 8) * 8, 0, 96 - ORI_H);
  s.xs0 = rxi - 64;
  const float rb = __fadd_rn(__fmul_rn(ORI_RADIUS, s.scl), slack);
  const float rd = __fadd_rn(__fmul_rn(r_fctr, s.scl), slack);
  const int col_lo = max(s.xs0, 0), col_hi = min(s.xs0 + 128, w);
  int dr0, dr1, dc0, dc1;
  span(s.y, rb, max(s.ysb, 0), min(s.ysb + ORI_H, h), s.br0, s.br1);
  span(s.x, rb, col_lo, col_hi, s.bc0, s.bc1);
  span(s.y, rd, max(s.ys0, 0), min(s.ys0 + 88, h), dr0, dr1);
  span(s.x, rd, col_lo, col_hi, dc0, dc1);
  const bool band = s.br1 > s.br0 && s.bc1 > s.bc0;
  const bool desc = dr1 > dr0 && dc1 > dc0;
  if (!band) s.br0 = s.br1 = s.bc0 = s.bc1 = 0;
  if (band && desc) {
    s.r0 = min(s.br0, dr0); s.r1 = max(s.br1, dr1);
    s.c0 = min(s.bc0, dc0); s.c1 = max(s.bc1, dc1);
  } else if (band) {
    s.r0 = s.br0; s.r1 = s.br1; s.c0 = s.bc0; s.c1 = s.bc1;
  } else if (desc) {
    s.r0 = dr0; s.r1 = dr1; s.c0 = dc0; s.c1 = dc1;
  } else {
    s.r0 = s.r1 = s.c0 = s.c1 = 0;
  }
  const size_t plane = (size_t)h * w;
  s.gdx = dxs + (size_t)mt.w * plane;
  s.gdy = dys + (size_t)mt.w * plane;
  return s;
}

// Magnitude and angle of pixel (r, c) of the slot's box: from the shared
// cache, or computed from global memory when the box did not fit.
template <bool CACHED>
struct Pixels {
  const float* mag;
  const float* theta;
  int r0, c0, bw, w;
  const __nv_bfloat16* gdx;
  const __nv_bfloat16* gdy;
  __device__ __forceinline__ void get(int r, int c, float& m, float& t) const {
    if (CACHED) {
      const int i = (r - r0) * bw + (c - c0);
      m = mag[i];
      t = theta[i];
    } else {
      const size_t off = (size_t)r * w + c;
      mag_theta(__bfloat162float(gdx[off]), __bfloat162float(gdy[off]), m, t);
    }
  }
};

__device__ __forceinline__ float bf16_lo(unsigned v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned v) {
  return __uint_as_float(v & 0xffff0000u);
}

// Fill the cache with the box's magnitudes and angles, row-major over the
// box, for the pixels inside the support disc (no pass reads the others).
// Threads take aligned column quads.
__device__ void fill_cache(const Slot& s, float* cmag, float* cth, int w,
                           float rd2, bool vec) {
  const int bw = s.c1 - s.c0, bh = s.r1 - s.r0;
  const int q0 = s.c0 >> 2, nq = ((s.c1 + 3) >> 2) - q0;
  for (int p = threadIdx.x; p < bh * nq; p += NT) {
    const int r = s.r0 + p / nq;
    const int cq = (q0 + p % nq) * 4;
    const float ry = (float)r - s.y;
    const float ry2 = ry * ry;
    bool need[4];
    bool any = false;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = cq + j;
      const float rx = (float)c - s.x;
      need[j] = c >= s.c0 && c < s.c1 && rx * rx + ry2 <= rd2;
      any |= need[j];
    }
    float gx[4] = {0.f, 0.f, 0.f, 0.f}, gy[4] = {0.f, 0.f, 0.f, 0.f};
    if (any) {
      const size_t off = (size_t)r * w + cq;
      if (vec) {
        const uint2 a = __ldg(reinterpret_cast<const uint2*>(s.gdx + off));
        const uint2 b = __ldg(reinterpret_cast<const uint2*>(s.gdy + off));
        gx[0] = bf16_lo(a.x); gx[1] = bf16_hi(a.x);
        gx[2] = bf16_lo(a.y); gx[3] = bf16_hi(a.y);
        gy[0] = bf16_lo(b.x); gy[1] = bf16_hi(b.x);
        gy[2] = bf16_lo(b.y); gy[3] = bf16_hi(b.y);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (need[j]) {
            gx[j] = __bfloat162float(s.gdx[off + j]);
            gy[j] = __bfloat162float(s.gdy[off + j]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!need[j]) continue;
      float m, t;
      mag_theta(gx[j], gy[j], m, t);
      const int i = (r - s.r0) * bw + (cq + j - s.c0);
      cmag[i] = m;
      cth[i] = t;
    }
  }
}

__device__ __forceinline__ float smooth(const float* hh, int j) {
  return (6.f * hh[j] + 4.f * (hh[(j + 35) % 36] + hh[(j + 1) % 36])
          + hh[(j + 34) % 36] + hh[(j + 2) % 36]) / 16.f;
}

// Orientation histogram over the band part of the box, then the smoothed
// peak. Returns the slot's angle (the same value in every thread).
// hist: 3 x 36 floats of shared memory.
template <bool CACHED>
__device__ float band_angle(const Slot& s, const Pixels<CACHED>& px,
                            float* hist_part, float* hist, float* s_angle) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bw = s.bc1 - s.bc0;
  const int nb = (s.br1 - s.br0) * bw;
  const float inv_scl = 1.0f / s.scl;
  if (warp < BAND_WARPS) {
    float hb[ORI_BINS];
#pragma unroll
    for (int j = 0; j < ORI_BINS; ++j) hb[j] = 0.f;
    for (int p = tid; p < nb; p += 32 * BAND_WARPS) {
      const int r = s.br0 + p / bw;
      const int c = s.bc0 + p % bw;
      const float ub = ((float)c - s.x) * inv_scl;
      const float vb = ((float)r - s.y) * inv_scl;
      if (!(fabsf(ub) <= ORI_RADIUS && fabsf(vb) <= ORI_RADIUS)) continue;
      float mag, theta;
      px.get(r, c, mag, theta);
      const float wgt = __expf(-(ub * ub + vb * vb) * (1.0f / 4.5f));
      const float binf = (theta * INV_TWO_PI_F + 0.5f) * (float)ORI_BINS;
      const float b0f = floorf(binf);
      const int b0 = floor_mod((int)b0f, ORI_BINS);
      const int b1 = b0 + 1 == ORI_BINS ? 0 : b0 + 1;
      const float frac = binf - b0f;
      const float w_all = mag * wgt;
      const float lo = w_all * (1.f - frac), hi = w_all * frac;
#pragma unroll
      for (int j = 0; j < ORI_BINS; ++j) {
        if (j == b0) hb[j] += lo;
        if (j == b1) hb[j] += hi;
      }
    }
#pragma unroll
    for (int j = 0; j < ORI_BINS; ++j) {
      float v = hb[j];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
      if (lane == 0) hist_part[warp * ORI_BINS + j] = v;
    }
  }
  __syncthreads();
  // the warps in order, two smoothings, the first argmax, the parabola
  if (tid < ORI_BINS) {
    float v = 0.f;
    for (int wi = 0; wi < BAND_WARPS; ++wi) v += hist_part[wi * ORI_BINS + tid];
    hist[tid] = v;
  }
  __syncthreads();
  if (tid < ORI_BINS) hist[ORI_BINS + tid] = smooth(hist, tid);
  __syncthreads();
  if (tid < ORI_BINS) hist[2 * ORI_BINS + tid] = smooth(hist + ORI_BINS, tid);
  __syncthreads();
  if (warp == 0) {
    const float* h2 = hist + 2 * ORI_BINS;
    float best = h2[lane];
    int pk = lane;
    if (lane + 32 < ORI_BINS && h2[lane + 32] > best) {
      best = h2[lane + 32];
      pk = lane + 32;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(FULL, best, o);
      const int op = __shfl_xor_sync(FULL, pk, o);
      if (ob > best || (ob == best && op < pk)) { best = ob; pk = op; }
    }
    if (lane == 0) {
      const float hl = h2[(pk + 35) % 36], hc = h2[pk], hr = h2[(pk + 1) % 36];
      const float denom = hl - 2.f * hc + hr;
      const float dbin = fabsf(denom) > 1e-12f ? 0.5f * (hl - hr) / denom : 0.f;
      *s_angle = (fmod_floor((float)pk + dbin, (float)ORI_BINS) / (float)ORI_BINS
                  - 0.5f) * 2.f * PI_F;
    }
  }
  __syncthreads();
  return *s_angle;
}

// The rotated descriptor over the core cells that meet the box; writes
// the slot's raw (16, 8) histogram. out_part may alias the cache: it is
// written only after every warp is done reading the cache.
template <bool CACHED>
__device__ void descriptor(const Slot& s, const Pixels<CACHED>& px,
                           float angle, float* out_part, short* cells,
                           int* warp_cnt, float* raw) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, sub = lane & 3;
  const float ca = cosf(angle), sa = sinf(angle);
  const float inv_hw = 1.0f / (3.0f * s.scl);
  // a pixel lies within 1.5*sqrt(2) px of its cell centre, so a cell whose
  // centre is this far outside the support |u|,|v| < 2.5 has no pixel in it
  const float margin = 2.1214f * inv_hw + 1e-3f;
  const int ci_lo = max(0, floor_div(s.r0 - s.ys0, CELL));
  const int ci_hi = min(CH - 1, floor_div(s.r1 - 1 - s.ys0, CELL));
  const int cj_lo = max(0, floor_div(s.c0 - s.xs0, CELL));
  const int cj_hi = min(CW - 1, floor_div(s.c1 - 1 - s.xs0, CELL));
  const int ncj = cj_hi - cj_lo + 1;
  const int nbox = (s.r1 > s.r0 && s.c1 > s.c0 && ci_hi >= ci_lo && ncj > 0)
                       ? (ci_hi - ci_lo + 1) * ncj : 0;
  // list, in ascending order, the cells of the box whose centre lies
  // within the support's margin: the others hold no support pixel and add
  // exact zeros
  int ncells = 0;
  for (int r0 = 0; r0 < nbox; r0 += NT) {
    const int t = r0 + tid;
    bool keep = false;
    if (t < nbox) {
      const int ci = ci_lo + t / ncj, cj = cj_lo + t % ncj;
      const float rx_c = ((float)s.xs0 + (float)(CELL * cj) + 1.5f) - s.x;
      const float ry_c = ((float)s.ys0 + (float)(CELL * ci) + 1.5f) - s.y;
      const float ud_c = (ca * rx_c + sa * ry_c) * inv_hw;
      const float vd_c = (-sa * rx_c + ca * ry_c) * inv_hw;
      keep = fabsf(ud_c) < 2.5f + margin && fabsf(vd_c) < 2.5f + margin;
    }
    const unsigned bal = __ballot_sync(FULL, keep);
    if (lane == 0) warp_cnt[warp] = __popc(bal);
    __syncthreads();
    int off = ncells, tot = ncells;
    for (int wi = 0; wi < NWARP; ++wi) {
      off += wi < warp ? warp_cnt[wi] : 0;
      tot += warp_cnt[wi];
    }
    if (keep) cells[off + __popc(bal & ((1u << lane) - 1u))] = (short)t;
    ncells = tot;
    __syncthreads();
  }
  // this lane's share of the 4x4 spatial bins x its two orientations
  // (2 sub, 2 sub + 1), summed over its group's cells in order
  float part[DESC_D * DESC_D][2];
#pragma unroll
  for (int q = 0; q < DESC_D * DESC_D; ++q) part[q][0] = part[q][1] = 0.f;

  for (int base = warp * 8; base < ncells; base += NWARP * 8) {
    float acc[DESC_B];
#pragma unroll
    for (int o = 0; o < DESC_B; ++o) acc[o] = 0.f;
    float rbin = -8.f, cbin = -8.f;          // no spatial bin: no cell
    if (base + g < ncells) {
      const int t = cells[base + g];
      const int ci = ci_lo + t / ncj, cj = cj_lo + t % ncj;
      const float rx_c = ((float)s.xs0 + (float)(CELL * cj) + 1.5f) - s.x;
      const float ry_c = ((float)s.ys0 + (float)(CELL * ci) + 1.5f) - s.y;
      const float ud_c = (ca * rx_c + sa * ry_c) * inv_hw;
      const float vd_c = (-sa * rx_c + ca * ry_c) * inv_hw;
      rbin = vd_c + 1.5f;
      cbin = ud_c + 1.5f;
      const int r = s.ys0 + CELL * ci + sub;
      if (r >= s.r0 && r < s.r1) {
        const float ry = (float)r - s.y;
#pragma unroll
        for (int jj = 0; jj < CELL; ++jj) {
          const int c = s.xs0 + CELL * cj + jj;
          if (c < s.c0 || c >= s.c1) continue;
          const float rx = (float)c - s.x;
          const float ud = (ca * rx + sa * ry) * inv_hw;
          const float vd = (-sa * rx + ca * ry) * inv_hw;
          if (!((vd + 1.5f > -1.f) && (vd + 1.5f < 4.f) &&
                (ud + 1.5f > -1.f) && (ud + 1.5f < 4.f)))
            continue;
          float mag, theta;
          px.get(r, c, mag, theta);
          const float wd = __expf(-(ud * ud + vd * vd) * 0.125f);
          float ob = (theta - angle) * INV_TWO_PI_F;
          ob = (ob - floorf(ob)) * (float)DESC_B;   // in [0, 8]
          const float of = floorf(ob);
          const float f = ob - of;
          int o0 = (int)of;
          if (o0 >= DESC_B) o0 -= DESC_B;
          const int o1 = o0 + 1 == DESC_B ? 0 : o0 + 1;
          const float magw = mag * wd;
          const float a0 = magw * (1.f - f), a1 = magw * f;
#pragma unroll
          for (int o = 0; o < DESC_B; ++o) {
            if (o == o0) acc[o] += a0;
            if (o == o1) acc[o] += a1;
          }
        }
      }
    }
    // the cell's four rows, added by a fixed butterfly
#pragma unroll
    for (int o = 0; o < DESC_B; ++o) {
      acc[o] += __shfl_xor_sync(FULL, acc[o], 1);
      acc[o] += __shfl_xor_sync(FULL, acc[o], 2);
    }
    // this lane's two orientations of the cell, then its trilinear bins
    float v0 = acc[0], v1 = acc[1];
#pragma unroll
    for (int q = 1; q < 4; ++q) {
      if (sub == q) { v0 = acc[2 * q]; v1 = acc[2 * q + 1]; }
    }
    float tr[DESC_D], tc[DESC_D];
#pragma unroll
    for (int m = 0; m < DESC_D; ++m) {
      tr[m] = fmaxf(0.f, 1.f - fabsf(rbin - (float)m));
      tc[m] = fmaxf(0.f, 1.f - fabsf(cbin - (float)m));
    }
#pragma unroll
    for (int m = 0; m < DESC_D; ++m) {
#pragma unroll
      for (int n = 0; n < DESC_D; ++n) {
        const float wt = tr[m] * tc[n];
        part[m * DESC_D + n][0] += wt * v0;
        part[m * DESC_D + n][1] += wt * v1;
      }
    }
  }
  // the warp's 8 groups, by a fixed butterfly; then the warps in order
#pragma unroll
  for (int q = 0; q < DESC_D * DESC_D; ++q) {
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      part[q][0] += __shfl_xor_sync(FULL, part[q][0], o);
      part[q][1] += __shfl_xor_sync(FULL, part[q][1], o);
    }
  }
  __syncthreads();   // every warp is done with the cache
  if (g == 0) {
#pragma unroll
    for (int q = 0; q < DESC_D * DESC_D; ++q) {
      out_part[warp * NOUT + q * DESC_B + 2 * sub] = part[q][0];
      out_part[warp * NOUT + q * DESC_B + 2 * sub + 1] = part[q][1];
    }
  }
  __syncthreads();
  if (tid < NOUT) {
    float v = 0.f;
    for (int wi = 0; wi < NWARP; ++wi) v += out_part[wi * NOUT + tid];
    raw[tid] = v;
  }
}

template <bool CACHED>
__device__ __forceinline__ float one_slot(const Slot& s, float* smem, int w,
                                          float* hist_part, float* hist,
                                          float* s_angle, short* cells,
                                          int* warp_cnt, float* raw) {
  const Pixels<CACHED> px{smem, smem + CACHE_PX, s.r0, s.c0, s.c1 - s.c0, w,
                          s.gdx, s.gdy};
  const float angle = band_angle<CACHED>(s, px, hist_part, hist, s_angle);
  descriptor<CACHED>(s, px, angle, smem, cells, warp_cnt, raw);
  return angle;
}

// work[0]: the number of valid slots, work[1]: the main kernel's next list
// entry (both zeroed before this kernel), work[2 ..]: the list. A thread a
// slot; each warp appends its valid slots with one atomic and zeroes the
// outputs of its invalid ones.
__global__ void __launch_bounds__(NT)
list_slots_kernel(const int4* __restrict__ meta, int K, int* __restrict__ work,
                  float* __restrict__ angle_out, float* __restrict__ raw_out) {
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * NT + threadIdx.x;
  const bool in = k < K;
  const bool valid = in && meta[k].w >= 0;
  const unsigned vb = __ballot_sync(FULL, valid);
  const unsigned ib = __ballot_sync(FULL, in && !valid);
  int base = 0;
  if (lane == 0 && vb != 0u) base = atomicAdd(work, __popc(vb));
  base = __shfl_sync(FULL, base, 0);
  if (valid) work[2 + base + __popc(vb & ((1u << lane) - 1u))] = k;
  if (in && !valid) angle_out[k] = 0.f;
  const size_t k0 = (size_t)(k - lane);
  for (unsigned m = ib; m != 0u; m &= m - 1u) {
    float4* row = reinterpret_cast<float4*>(raw_out + (k0 + __ffs(m) - 1) * NOUT);
    row[lane] = make_float4(0.f, 0.f, 0.f, 0.f);   // NOUT = 32 float4
  }
}

__global__ void __launch_bounds__(NT, MIN_CTAS)
ori_desc_kernel(const __nv_bfloat16* __restrict__ dxs,
                const __nv_bfloat16* __restrict__ dys,
                const int4* __restrict__ meta, int* __restrict__ work, int h,
                int w, int hp, int fb, float r_fctr, float slack, bool vec,
                float* __restrict__ angle_out, float* __restrict__ raw_out,
                int4* __restrict__ boxes_out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float hist_part[BAND_WARPS * ORI_BINS];
  __shared__ float hist[3 * ORI_BINS];
  __shared__ float s_angle;
  __shared__ int s_slot;
  __shared__ short cells[CH * CW];
  __shared__ int warp_cnt[NWARP];
  const int n = work[0];
  for (;;) {
    if (threadIdx.x == 0) {
      const int i = atomicAdd(work + 1, 1);
      s_slot = i < n ? work[2 + i] : -1;
    }
    __syncthreads();
    const int k = s_slot;
    if (k < 0) break;
    const Slot s = make_slot(meta[k], dxs, dys, h, w, hp, fb, r_fctr, slack);
    float* raw = raw_out + (size_t)k * NOUT;
    const int npx = (s.r1 - s.r0) * (s.c1 - s.c0);
    float angle;
    if (npx <= CACHE_PX) {
      const float rd = __fadd_rn(__fmul_rn(r_fctr, s.scl), slack);
      fill_cache(s, smem, smem + CACHE_PX, w, rd * rd, vec);
      __syncthreads();
      angle = one_slot<true>(s, smem, w, hist_part, hist, &s_angle, cells,
                              warp_cnt, raw);
    } else {
      angle = one_slot<false>(s, smem, w, hist_part, hist, &s_angle, cells,
                               warp_cnt, raw);
    }
    if (threadIdx.x == 0) {
      angle_out[k] = angle;
      if (boxes_out) boxes_out[k] = make_int4(s.r0, s.r1, s.c0, s.c1);
    }
    __syncthreads();   // the next slot reuses the cache and s_slot
  }
}

}  // namespace

// Launch on `stream`. dxs, dys: (L, h, w) bf16; meta: (K, 4) int32
// [xq, yq, sclq, layer] (layer -1 = invalid slot), 16-byte aligned; work:
// K + 2 int32 of scratch, which receives the valid-slot count, a counter
// and the list of valid slots (in no fixed order); angle (K,) and raw
// (K, 16, 8) f32, raw 16-byte aligned, every slot written (zeros for the
// invalid ones). r_fctr, slack: the support disc radius r_fctr * scl +
// slack. boxes_out: null, or (K, 4) int32 that receives each valid slot's
// support box, for checks. Returns the first CUDA error of the memset and
// the two launches (0 on success).
extern "C" int ori_desc_launch(const void* dxs, const void* dys,
                               const void* meta, void* work, int K, int h,
                               int w, int hp, int fb, float r_fctr,
                               float slack, void* angle, void* raw,
                               void* boxes_out, void* stream) {
  static int grid = 0;
  if (grid == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        ori_desc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ori_desc_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    int dev = 0, sms = 0, per_sm = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ori_desc_kernel,
                                                        NT, SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    grid = sms * per_sm;
  }
  if (K <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(work, 0, 2 * sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  list_slots_kernel<<<(K + NT - 1) / NT, NT, 0, st>>>(
      (const int4*)meta, K, (int*)work, (float*)angle, (float*)raw);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const bool vec = (w % 4 == 0) && ((uintptr_t)dxs % 8 == 0) &&
                   ((uintptr_t)dys % 8 == 0);
  const int blocks = K < grid ? K : grid;
  ori_desc_kernel<<<blocks, NT, SMEM_BYTES, st>>>(
      (const __nv_bfloat16*)dxs, (const __nv_bfloat16*)dys, (const int4*)meta,
      (int*)work, h, w, hp, fb, r_fctr, slack, vec, (float*)angle, (float*)raw,
      (int4*)boxes_out);
  return (int)cudaGetLastError();
}
