// ALIKED-n16's head in one pass over the map: the `aliked_head` kernel.
//
// Replaces no TPU kernel. The reference leaves the head to XLA
// (`tpu3drec/models/aliked_n16.py`: per level a 1x1 conv, SELU and an
// align-corners bilinear resize, the concatenation, the score head, the
// L2 normalisation). The port's plain form
// (`tpu3drec_torch/models/aliked_n16.py:ALIKEDN16Net.head_plain`) writes
// each level's upsampled quarter into the map with two float32 matrix
// products by dense interpolation matrices, then reads the map again for
// the score layer and twice more to normalise it. For the backbone's four
// levels x1 (B, 16, H, W), x2 (B, 32, H/2, W/2), x3 (B, 64, H/8, W/8) and
// x4 (B, 128, H/32, W/32), NCHW, and per output pixel, this launch computes
//
//     f[0:32]    = selu(conv1 x1[b, :, Y, X])
//     f[32 l:..] = sum over the two row taps i and the two column taps j
//                  of w_i w_j selu(conv_l x_l[b, :, i, j]),  l = 1, 2, 3
//     s8[b, k, Y, X] = selu(sum_c score1[k, c] f[c])                 (8)
//     feat[b, Y, X, :] = f / max(|f|, 1e-12)                        (128)
//
// and writes s8 (NCHW, what `score2` reads) and feat (channels-last, what
// SDDH and DKD read) once each: no upsampled quarter or unnormalised map
// reaches device memory.
//
// Precision: float32 FFMA throughout, no tensor cores (the model states
// ALIKED in full float32, and the work is small). The interpolation sums
// the same two float32 terms a row of `_interp_matrix` has, rows first and
// then columns as `_upsample_ac` does, the first tap's product and then
// the second's by one fused multiply-add; the taps and weights come from a
// table of (i0, i1, w0, w1) a row and a column, the matrices' two entries
// exactly. SELU is PyTorch's formula. The division by the norm is
// correctly rounded: q = f r with r the rounded reciprocal, then one Newton
// step on the residual. The 1x1 sums, the score sum and the squared norm
// run in channel order, so they may differ from cuDNN's and cuBLAS's order
// by an ulp or two.
//
// What bounds it: bytes. At 64 images of 768x1024 it reads x1 once (3.22
// GB), x2 (1.61 GB), x3 and x4 (0.2 GB), and writes the map (25.77 GB) and
// s8 (1.61 GB): 32.4 GB, 9.7 ms at 3.35 TB/s; ~2,000 float32
// multiply-adds a pixel are ~3 ms at 67 TFLOP/s. The design keeps every
// full-resolution value to one read or one write, and the map's writes to
// whole lines.
//
// Design: four kernels in one launch.
// - `levels_kernel`, once a level, computes the level's 1x1 conv and SELU
//   into a channels-last (B, h, w, 32) buffer (1.7 GB at the shape above,
//   read back mostly from L2): a persistent CTA stages the weights once,
//   then 64 pixels' inputs at a time; a thread computes 8 outputs of a
//   pixel, and the CTA writes its 64 x 32 outputs as whole lines.
// - `head_kernel`: each warp works alone, on 32 pixels of one output row
//   at a time (neighbouring warps on neighbouring segments). It
//   interpolates each level's two rows to its row at the columns the
//   segment taps (at most 18 at 1/2) into its own shared memory, a lane a
//   channel, so each load is a whole line of the buffer. Then a lane owns
//   a pixel: x1's 16 channels (a warp reads 128 contiguous bytes a
//   channel), conv1 and SELU (kept in registers), and the three column
//   interpolations, summed into score1 and the squared norm four channels
//   at a time and dropped; once the norm is known, a second pass
//   recomputes the levels' channels (the same operations, so the same
//   bits), divides, and passes each quarter of the warp's 32 pixels
//   through the warp's stage, so that each 16-byte store instruction writes
//   four pixels' 128 contiguous bytes (whole lines, streaming past L2).
//   Rows of 32 channels sit 36 floats apart in shared memory, so the float4
//   reads of 8 lanes at 8 different columns fall in 8 different bank
//   quads. conv1's and score1's weights (6 KB) live in shared memory for
//   the kernel's life.
//
// On an NVIDIA H100 80GB HBM3 at 700 W the launch takes ~21 ms at the shape
// above (the levels 2.0 ms), 2.2x its bound; the time goes to the
// per-pixel instruction stream (score1 and conv1 are 1,536 multiply-adds a
// pixel, their weights read from shared memory), not to the bytes.
// Measured and left out: the pixel's 128 channels held in registers
// instead of the second pass (168 registers, spills, 43 ms); 8 x 32 tiles
// with the level rows staged for the whole CTA between barriers (22-26 ms);
// two pixels a lane, sharing each weight read (34-37 ms: the registers cut
// the warps an SM holds); the weights in constant memory (43 ms: 6 KB
// overflow the constant cache); stores straight from registers, 16 bytes a
// lane 512 bytes apart (35 ms); the next segment's x1 loaded ahead (no
// gain).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int Q = 32;        // channels a level gives the map
constexpr int DIM = 4 * Q;   // the map's channels
constexpr int NS = 8;        // score1's outputs
constexpr int RS = Q + 4;    // floats between two pixels' channels in smem
constexpr int CIN1 = 16, CIN2 = 32, CIN3 = 64, CIN4 = 128;

// the packed weights, each (out, in) row-major: conv1 and score1 (the
// first SW floats, which `head_kernel` keeps in shared memory), then
// conv2, conv3 and conv4
constexpr int W_CONV1 = 0;
constexpr int W_SCORE = W_CONV1 + Q * CIN1;
constexpr int W_CONV2 = W_SCORE + NS * DIM;
constexpr int W_CONV3 = W_CONV2 + Q * CIN2;
constexpr int W_CONV4 = W_CONV3 + Q * CIN3;
constexpr int SW = W_CONV2;

// PyTorch's SELU in float32: x * scale above 0, expm1(x) * (alpha scale)
// at or below. Both sides are computed and one is selected, so no branch
// keeps the compiler from interleaving neighbouring SELUs and sums (a warp
// takes both sides anyway where its lanes' signs differ).
__device__ __forceinline__ float selu(float x) {
  const float scale = 1.0507009873554804934193349852946f;
  const float alpha = 1.6732632423543772848170429916717f;
  const float neg = expm1f(fminf(x, 0.f)) * (alpha * scale);
  return x > 0.f ? x * scale : neg;
}

// ---- levels_kernel: selu(conv_l x_l), channels-last

constexpr int LNT = 256;             // threads a CTA
constexpr int LPX = 64;              // pixels a tile
constexpr int LGROUPS = LNT / LPX;   // output groups a pixel
constexpr int LOG = Q / LGROUPS;     // outputs a thread

template <int CIN>
constexpr size_t levels_smem() {
  return (size_t)(CIN * Q + CIN * LPX + LPX * RS) * 4;
}

// y (B h w, 32) = selu(w x) at every pixel of a level x (B, CIN, h w): a
// persistent CTA stages the weights once, then per tile of 64 pixels
// their inputs; a thread computes LOG outputs of one pixel, and the CTA
// writes the tile's 64 x 32 outputs as whole lines
template <int CIN>
__global__ void __launch_bounds__(LNT) levels_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    float* __restrict__ y, int npx, int hw, int ntiles) {
  extern __shared__ __align__(16) float lsmem[];
  float* ws = lsmem;             // (CIN, 32): the weights transposed
  float* xs = ws + CIN * Q;      // (CIN, LPX)
  float* ys = xs + CIN * LPX;    // (LPX, RS)
  for (int e = threadIdx.x; e < CIN * Q; e += LNT)
    ws[e] = __ldg(w + (e % Q) * CIN + e / Q);
  // a thread's pixel in every tile, and its output group: a warp's lanes
  // are 32 pixels of one group, so their weights' reads are the same
  const int k = threadIdx.x % LPX, g = threadIdx.x / LPX;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int q = t * LPX + k, b = q / hw;
    const float* xq = x + ((size_t)b * CIN * hw + (q - b * hw));
    __syncthreads();  // the previous tile's xs and ys are read
    if (q < npx)
      for (int c = g; c < CIN; c += LGROUPS)
        xs[c * LPX + k] = __ldg(xq + (size_t)c * hw);
    __syncthreads();
    float acc[LOG];
#pragma unroll
    for (int o = 0; o < LOG; ++o) acc[o] = 0.f;
#pragma unroll 4
    for (int c = 0; c < CIN; ++c) {
      const float xv = xs[c * LPX + k];
#pragma unroll
      for (int o = 0; o < LOG; o += 4) {
        const float4 wv =
            *reinterpret_cast<const float4*>(ws + c * Q + g * LOG + o);
        acc[o] = fmaf(wv.x, xv, acc[o]);
        acc[o + 1] = fmaf(wv.y, xv, acc[o + 1]);
        acc[o + 2] = fmaf(wv.z, xv, acc[o + 2]);
        acc[o + 3] = fmaf(wv.w, xv, acc[o + 3]);
      }
    }
#pragma unroll
    for (int o = 0; o < LOG; o += 4)
      *reinterpret_cast<float4*>(ys + k * RS + g * LOG + o) =
          make_float4(selu(acc[o]), selu(acc[o + 1]), selu(acc[o + 2]),
                      selu(acc[o + 3]));
    __syncthreads();
    for (int e = threadIdx.x; e < LPX * Q / 4; e += LNT) {
      const int k2 = e / (Q / 4), c4 = (e % (Q / 4)) * 4;
      const int q2 = t * LPX + k2;
      if (q2 < npx)
        *reinterpret_cast<float4*>(y + (size_t)q2 * Q + c4) =
            *reinterpret_cast<const float4*>(ys + k2 * RS + c4);
    }
  }
}

// ---- head_kernel: the map, score1 and the norm

constexpr int NT = 128;  // threads a CTA
constexpr int NWARPS = NT / 32;
constexpr int SEG = 32;  // pixels of one output row a warp takes at a time

// a level at 1/S of the output: the low-resolution columns a segment of 32
// output columns taps, at most (the tap positions are below 1/S of the
// output's, so 32 columns span under 31 / S of them, and each end adds one)
template <int S>
struct Level {
  static constexpr int C = (SEG - 1) / S + 3;
};

// floats of a warp's shared memory: its segment row of each level, at the
// columns it taps, and its store stage
constexpr int ROWS2 = 0;
constexpr int ROWS3 = ROWS2 + Level<2>::C * RS;
constexpr int ROWS4 = ROWS3 + Level<8>::C * RS;
constexpr int STAGE = ROWS4 + Level<32>::C * RS;
constexpr int WARP_FLOATS = STAGE + SEG * RS;
constexpr size_t SMEM = (size_t)(SW + NWARPS * WARP_FLOATS) * 4;
static_assert(SW % 4 == 0 && ROWS3 % 4 == 0 && ROWS4 % 4 == 0 &&
                  STAGE % 4 == 0 && WARP_FLOATS % 4 == 0,
              "every region starts on 16 bytes");

struct Params {
  const float* x1;
  const float* w;     // packed weights
  const float* y[3];  // levels_kernel's output
  const int4* taps;   // rows of levels 2, 3, 4 (H each), then columns (W each)
  float* feat;        // (B, H, W, 128)
  float* s8;          // (B, 8, H, W)
  int H, W;
  int segs_x, nsegs;
};

// a level's values interpolated to output row y at the columns [c0, c0 +
// nc) that the segment taps, into rows (C, RS): w0 y[i0] + w1 y[i1], the
// first product then the second by a fused multiply-add; lane = channel,
// so each load is a whole line
template <int S>
__device__ __forceinline__ void level_row(const float* __restrict__ lv,
                                          int4 tp, int b, int h, int w,
                                          int c0, int nc, float* rows,
                                          int lane) {
  const float* a0 = lv + (((size_t)b * h + tp.x) * w + c0) * Q + lane;
  const float* a1 = lv + (((size_t)b * h + tp.y) * w + c0) * Q + lane;
  const float w0 = __int_as_float(tp.z), w1 = __int_as_float(tp.w);
#pragma unroll
  for (int col = 0; col < Level<S>::C; ++col)
    if (col < nc)
      rows[col * RS + lane] =
          fmaf(w1, __ldg(a1 + col * Q), w0 * __ldg(a0 + col * Q));
}

// a lane's column taps into its warp's interpolated rows
struct ColTap {
  const float* a0;
  const float* a1;
  float w0, w1;
};

__device__ __forceinline__ ColTap col_tap(const int4* __restrict__ ct, int x,
                                          int c0, const float* rows) {
  const int4 tp = __ldg(ct + x);
  return ColTap{rows + (tp.x - c0) * RS, rows + (tp.y - c0) * RS,
                __int_as_float(tp.z), __int_as_float(tp.w)};
}

// channels c .. c + 3 of a level at the lane's pixel
__device__ __forceinline__ float4 level_at(const ColTap& t, int c) {
  const float4 p0 = *reinterpret_cast<const float4*>(t.a0 + c);
  const float4 p1 = *reinterpret_cast<const float4*>(t.a1 + c);
  return make_float4(fmaf(t.w1, p1.x, t.w0 * p0.x),
                     fmaf(t.w1, p1.y, t.w0 * p0.y),
                     fmaf(t.w1, p1.z, t.w0 * p0.z),
                     fmaf(t.w1, p1.w, t.w0 * p0.w));
}

// score1 and the squared norm take map channels c .. c + 3
__device__ __forceinline__ void accumulate(const float* sw, int c, float4 u,
                                           float (&s)[NS], float (&ss)[4]) {
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    const float4 wv =
        *reinterpret_cast<const float4*>(sw + W_SCORE + k * DIM + c);
    s[k] = fmaf(wv.x, u.x, s[k]);
    s[k] = fmaf(wv.y, u.y, s[k]);
    s[k] = fmaf(wv.z, u.z, s[k]);
    s[k] = fmaf(wv.w, u.w, s[k]);
  }
  ss[0] = fmaf(u.x, u.x, ss[0]);
  ss[1] = fmaf(u.y, u.y, ss[1]);
  ss[2] = fmaf(u.z, u.z, ss[2]);
  ss[3] = fmaf(u.w, u.w, ss[3]);
}

// u / n, correctly rounded, with r the rounded reciprocal of n
__device__ __forceinline__ float div_rn(float u, float n, float r) {
  const float q = u * r;
  return fmaf(fmaf(-q, n, u), r, q);
}

__device__ __forceinline__ float4 normalised(float4 u, float n, float r) {
  return make_float4(div_rn(u.x, n, r), div_rn(u.y, n, r), div_rn(u.z, n, r),
                     div_rn(u.w, n, r));
}

// the warp's 32 pixels' channels j Q .. j Q + 31 (this lane's in stage's
// row `lane`) to the map: 8 lanes write one pixel's 128 bytes
__device__ __forceinline__ void store_quarter(const float* stage, float* row,
                                              int j, int lane) {
  __syncwarp();
#pragma unroll
  for (int it = 0; it < 8; ++it) {
    const int px = it * 4 + (lane >> 3), c4 = (lane & 7) * 4;
    __stcs(reinterpret_cast<float4*>(row + (size_t)px * DIM + j * Q + c4),
           *reinterpret_cast<const float4*>(stage + px * RS + c4));
  }
  __syncwarp();
}

__global__ void __launch_bounds__(NT, 3) head_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  float* sw = smem;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* mem = smem + SW + warp * WARP_FLOATS;
  float* rows2 = mem + ROWS2;
  float* rows3 = mem + ROWS3;
  float* rows4 = mem + ROWS4;
  float* stage = mem + STAGE;

  for (int i = threadIdx.x; i < SW / 4; i += NT)
    reinterpret_cast<float4*>(sw)[i] =
        __ldg(reinterpret_cast<const float4*>(p.w) + i);
  __syncthreads();

  const int h2 = p.H / 2, w2 = p.W / 2, h3 = p.H / 8, w3 = p.W / 8;
  const int h4 = p.H / 32, w4 = p.W / 32;
  const int4* rt2 = p.taps;
  const int4* rt3 = rt2 + p.H;
  const int4* rt4 = rt3 + p.H;
  const int4* ct2 = rt4 + p.H;
  const int4* ct3 = ct2 + p.W;
  const int4* ct4 = ct3 + p.W;
  const size_t plane = (size_t)p.H * p.W;

  // warps work alone, each on one segment of 32 pixels of an output row at
  // a time; neighbouring warps take neighbouring segments, columns first
  for (int seg = blockIdx.x * NWARPS + warp; seg < p.nsegs;
       seg += gridDim.x * NWARPS) {
    const int rest = seg / p.segs_x;
    const int x0 = (seg - rest * p.segs_x) * SEG, y = rest % p.H;
    const int b = rest / p.H, x = x0 + lane;

    float xin[CIN1];
    const float* px1 = p.x1 + ((size_t)b * CIN1 * p.H + y) * p.W + x;
#pragma unroll
    for (int c = 0; c < CIN1; ++c) xin[c] = __ldg(px1 + c * plane);

    // each level's row y at the columns the segment taps: the first
    // column's first tap to the last one's second
    const int c02 = __ldg(ct2 + x0).x, c03 = __ldg(ct3 + x0).x;
    const int c04 = __ldg(ct4 + x0).x;
    level_row<2>(p.y[0], __ldg(rt2 + y), b, h2, w2, c02,
                 __ldg(ct2 + x0 + SEG - 1).y - c02 + 1, rows2, lane);
    level_row<8>(p.y[1], __ldg(rt3 + y), b, h3, w3, c03,
                 __ldg(ct3 + x0 + SEG - 1).y - c03 + 1, rows3, lane);
    level_row<32>(p.y[2], __ldg(rt4 + y), b, h4, w4, c04,
                  __ldg(ct4 + x0 + SEG - 1).y - c04 + 1, rows4, lane);
    __syncwarp();

    // the lane's pixel: conv1 and SELU, kept for the second pass
    float v[Q];
#pragma unroll
    for (int o = 0; o < Q; ++o) {
      const float* wo = sw + W_CONV1 + o * CIN1;
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < CIN1; c += 4) {
        const float4 wv = *reinterpret_cast<const float4*>(wo + c);
        acc = fmaf(wv.x, xin[c], acc);
        acc = fmaf(wv.y, xin[c + 1], acc);
        acc = fmaf(wv.z, xin[c + 2], acc);
        acc = fmaf(wv.w, xin[c + 3], acc);
      }
      v[o] = selu(acc);
    }
    const ColTap t2 = col_tap(ct2, x, c02, rows2);
    const ColTap t3 = col_tap(ct3, x, c03, rows3);
    const ColTap t4 = col_tap(ct4, x, c04, rows4);

    // pass 1: score1 on the unnormalised map, and its squared norm
    float s[NS], ss[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < NS; ++k) s[k] = 0.f;
#pragma unroll
    for (int c = 0; c < Q; c += 4)
      accumulate(sw, c, make_float4(v[c], v[c + 1], v[c + 2], v[c + 3]), s,
                 ss);
#pragma unroll
    for (int c = 0; c < Q; c += 4)
      accumulate(sw, Q + c, level_at(t2, c), s, ss);
#pragma unroll
    for (int c = 0; c < Q; c += 4)
      accumulate(sw, 2 * Q + c, level_at(t3, c), s, ss);
#pragma unroll
    for (int c = 0; c < Q; c += 4)
      accumulate(sw, 3 * Q + c, level_at(t4, c), s, ss);
    float* ps8 = p.s8 + ((size_t)b * NS * p.H + y) * p.W + x;
#pragma unroll
    for (int k = 0; k < NS; ++k) ps8[k * plane] = selu(s[k]);

    // pass 2: the map divided by its norm, a quarter at a time; the last
    // quarter's trailing __syncwarp ends the segment's reads of rows*
    const float n = fmaxf(sqrtf((ss[0] + ss[1]) + (ss[2] + ss[3])), 1e-12f);
    const float r = __frcp_rn(n);
    float* row = p.feat + (((size_t)b * p.H + y) * p.W + x0) * DIM;
    float* mine = stage + lane * RS;
#pragma unroll
    for (int c = 0; c < Q; c += 4)
      *reinterpret_cast<float4*>(mine + c) = normalised(
          make_float4(v[c], v[c + 1], v[c + 2], v[c + 3]), n, r);
    store_quarter(stage, row, 0, lane);
#pragma unroll
    for (int c = 0; c < Q; c += 4)
      *reinterpret_cast<float4*>(mine + c) = normalised(level_at(t2, c), n, r);
    store_quarter(stage, row, 1, lane);
#pragma unroll
    for (int c = 0; c < Q; c += 4)
      *reinterpret_cast<float4*>(mine + c) = normalised(level_at(t3, c), n, r);
    store_quarter(stage, row, 2, lane);
#pragma unroll
    for (int c = 0; c < Q; c += 4)
      *reinterpret_cast<float4*>(mine + c) = normalised(level_at(t4, c), n, r);
    store_quarter(stage, row, 3, lane);
  }
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 132;
  return n;
}

// one level's levels_kernel, as many CTAs as the card holds at once
template <int CIN>
cudaError_t run_levels(const float* x, const float* w, float* y, int npx,
                       int hw, int tiles,
                       cudaStream_t stream) {
  constexpr size_t smem = levels_smem<CIN>();
  cudaError_t e = cudaFuncSetAttribute(
      levels_kernel<CIN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, levels_kernel<CIN>, LNT, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int cap = per_sm * sm_count();
  levels_kernel<CIN><<<tiles < cap ? tiles : cap, LNT, smem, stream>>>(
      x, w, y, npx, hw, tiles);
  return cudaGetLastError();
}

}  // namespace

// x1 (B, 16, H, W), x2 (B, 32, H/2, W/2), x3 (B, 64, H/8, W/8) and x4 (B,
// 128, H/32, W/32) float32, NCHW contiguous; w the packed weights (conv1
// (32, 16), score1 (8, 128), conv2 (32, 32), conv3 (32, 64), conv4 (32,
// 128), 8,704 floats); taps int32 (3 H + 3 W, 4): for levels 2, 3, 4 each
// output row's (i0, i1, w0, w1), the weights' float32 bits, then each
// output column's; levels, scratch of B 32 (H/2 W/2 + H/8 W/8 + H/32 W/32)
// floats; feat (B, H, W, 128) and s8 (B, 8, H, W) float32, contiguous. H
// and W are multiples of 32; w, taps, levels and feat start on 16 bytes.
// Four kernels on `stream`; returns the first CUDA error (0 on success).
extern "C" int aliked_head_launch(const float* x1, const float* x2,
                                  const float* x3, const float* x4,
                                  const float* w, const int* taps,
                                  float* levels, float* feat, float* s8,
                                  int B, int H, int W, cudaStream_t stream) {
  if (B < 0 || H < 0 || W < 0 || H % 32 || W % 32)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)w | (uintptr_t)taps | (uintptr_t)levels |
       (uintptr_t)feat) % 16)
    return (int)cudaErrorInvalidValue;
  const long long nsegs = (long long)B * H * (W / SEG);
  if (nsegs > 0x7fffffffLL - NT) return (int)cudaErrorInvalidValue;
  if (nsegs == 0) return 0;

  const float* xs[3] = {x2, x3, x4};
  const float* ys[3];
  float* y = levels;
  cudaError_t e = cudaSuccess;
  for (int l = 0; l < 3; ++l) {
    const int scale = l == 0 ? 2 : l == 1 ? 8 : 32;
    const int hw = (H / scale) * (W / scale);
    const long long npx = (long long)B * hw;
    if (npx > 0x7fffffffLL - LPX) return (int)cudaErrorInvalidValue;
    const int n = (int)npx, tiles = (n + LPX - 1) / LPX;
    if (tiles > 0) {
      e = l == 0   ? run_levels<CIN2>(xs[l], w + W_CONV2, y, n, hw, tiles,
                                      stream)
          : l == 1 ? run_levels<CIN3>(xs[l], w + W_CONV3, y, n, hw, tiles,
                                      stream)
                   : run_levels<CIN4>(xs[l], w + W_CONV4, y, n, hw, tiles,
                                      stream);
      if (e != cudaSuccess) return (int)e;
    }
    ys[l] = y;
    y += npx * Q;
  }

  Params p{};
  p.x1 = x1;
  p.w = w;
  for (int l = 0; l < 3; ++l) p.y[l] = ys[l];
  p.taps = reinterpret_cast<const int4*>(taps);
  p.feat = feat;
  p.s8 = s8;
  p.H = H;
  p.W = W;
  p.segs_x = W / SEG;
  p.nsegs = (int)nsegs;
  e = cudaFuncSetAttribute(head_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)SMEM);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, head_kernel, NT,
                                                    SMEM);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int cap = per_sm * sm_count();
  const int ctas = (p.nsegs + NWARPS - 1) / NWARPS;
  head_kernel<<<ctas < cap ? ctas : cap, NT, SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}
