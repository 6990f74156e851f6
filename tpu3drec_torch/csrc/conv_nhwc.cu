// Channels-last convolution with bias, ReLU and the 2x2 max pool in its
// epilogue: the `conv_nhwc` kernel.
//
// Replaces no TPU kernel. The reference runs SuperPoint's twelve
// convolutions as XLA convolutions (`tpu3drec/models/superpoint.py`),
// which the TPU's compiler fuses with their bias, ReLU and pools; the
// port's plain form (`tpu3drec_torch/ops/conv.py:conv2d_nhwc_plain`) is
// `F.conv2d`, a ReLU and `max_pool2d` in NCHW, whose bias add, ReLU, pool
// and layout copies each pass over the output again. For x (B, H, W, Cin),
// weights w (Cout, kh, kw, Cin), kh = kw = k in {1, 3}, "same" padding
// (k / 2 zeros), and a bias (Cout), this kernel writes
//
//     y[b, i, j, o] = relu?( bias[o] + sum_{dy, dx, c} x[b, i + dy - k/2,
//                            j + dx - k/2, c] w[o, dy, dx, c] )
//
// or, with `pool`, the maximum of that over each 2x2 window (output
// H / 2 x W / 2, a last odd row or column left out, as `max_pool2d` does),
// and nothing else: no unactivated, unpooled or NCHW map reaches device
// memory. The maximum is taken before the bias and the ReLU, which is the
// same in float32: both are monotonic, and the bias is the same for the
// four pixels.
//
// Precision: TF32 operands (rounded to nearest, ties away, as
// `cvt.rna.tf32.f32` rounds) with float32 accumulators, what cuDNN does for
// the plain form under `allow_tf32`; the bias add and the ReLU are float32.
// Full float32 (`full_f32`, for callers with TF32 off) splits each operand
// x into hi = tf32(x) and lo = tf32(x - hi) and takes hi.hi' + hi.lo' +
// lo.hi' on the tensor cores (3xTF32); each 8-channel step's three products
// start from zero and join the sum by a float32 add, as the tensor cores'
// accumulation truncates.
//
// What bounds it: operations, except for one input channel. SuperPoint at
// 768x1024 is 66.69 GMAC an image, 8.54 TFLOP for the deep cell's 64
// images: 17.3 ms at 494.7 TFLOP/s TF32. Its first layer (1 -> 64
// channels) is 0.45 GMAC an image and writes 201 MB: bound by bytes.
//
// Design (implicit GEMM on `mma.sync.m16n8k8` TF32; rows are pixels,
// columns output channels, depth the taps times the input channels). A
// CTA of eight warps owns a tile of 2 MT rows x 64 columns of output
// pixels (before the pool) and 64 output channels. Per stage it stages 16
// input channels of the tile's input patch, with its k / 2 halo, and the
// 64 x k x k x 16 weights they meet, through a two-stage `cp.async` ring
// (zero-filled outside the image and past Cin and Cout), so a pixel is
// read from memory once for all k x k taps. Each warp owns MT rows x 16
// columns x 64 channels (MT x 8 accumulator tiles in registers) and, per
// tap, reads its A fragments at the tap's offset in the patch. The sum
// over channels is order-free, which the fragment layout uses, as in
// `masked_attention.cu`: a thread's two k-steps of a 16-channel stage read
// the four consecutive floats 4 t .. 4 t + 3 of a pixel (one 16-byte load;
// pixels 16 floats apart, so a phase of 8 lanes reads 128 contiguous
// bytes: no conflicts), and its B fragments the same four channels of an
// output channel's weights. The epilogue takes the 2x2 maximum in
// registers (the two rows of a window are two of the warp's accumulator
// tiles, the two columns a lane and the lane 4 apart), adds the bias,
// applies the ReLU and writes each output once. CTAs are persistent (one
// an SM): each walks tiles gridDim.x apart, decoding a tile once, and the
// ring runs on across a tile's end, so the next tile's first stage loads
// while this one finishes. A tile's output-channel blocks are neighbours
// in that order, so they share the patch in L2. Full float32 takes MT = 2
// (its split fragments take the registers); TF32 MT = 4.
//
// One input channel, 3x3 without the pool (SuperPoint's first layer, the
// only such layer), takes its own kernel: a thread computes 4 output
// channels of 4 output pixels at a time with float32 FMAs on operands
// rounded as the tensor cores would round them (products of TF32 values
// are exact in float32), its weights in registers and the input windows
// unrolled, and writes each pixel's 4 as one 16-byte store, so a warp
// writes 512 contiguous bytes.
//
// On an NVIDIA H100 80GB HBM3 at 700 W, SuperPoint's twelve layers on 64
// images of 768x1024 take ~55 ms (~155 TFLOP/s; the 3x3 layers 150-196,
// conv1b 19.3-19.9 ms at ~190, 59% of `mma.sync` TF32's ~320; conv1a
// 6.0 ms against its 3.9 ms write). Measured and left out, all giving the
// same bits: wgmma m64n64k8 with A from registers and B by descriptor
// (5-8% faster on the 3x3 layers, about 2.5 ms of the 64 images, for a
// second compute path, a permuted weight layout and the wgmma fences),
// wgmma with both operands by descriptor and the patch rounded in shared
// memory (5-10% slower), three stages (0.5-4% slower), a 4 MT x 32 tile
// and four stages for the 1x1 layers (each within 2%), and 1, 2 or 8
// pixels a thread in the first layer's kernel (16-39% slower).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 8;
constexpr int NT = NWARPS * 32;
constexpr int WARPS_W = 4;                 // warps across a tile's columns
constexpr int WARPS_H = NWARPS / WARPS_W;  // and down its rows
constexpr int TW = 16 * WARPS_W;           // output columns a tile
constexpr int BN = 64;                     // output channels a tile
constexpr int KC = 16;                     // input channels a stage
constexpr int STAGES = 2;  // of the cp.async ring

struct Params {
  const float* x;
  const float* w;
  const float* bias;
  float* y;
  int H, W, Cin, Cout;
  int Ho, Wo;  // output size (pooled or not)
  int relu, pool;
  int tiles_x, tiles_y, nblocks, chunks;
  int ntiles;  // tiles_x tiles_y nblocks B, below 2^31
};

template <int KS, int MT>
struct Shape {
  static constexpr int P = KS / 2;
  static constexpr int TAPS = KS * KS;
  static constexpr int TH = WARPS_H * MT;  // output rows a tile
  static constexpr int PH = TH + 2 * P, PW = TW + 2 * P;
  static constexpr int PATCH = PH * PW * KC;  // floats
  static constexpr int WTS = TAPS * BN * KC;  // floats
  static constexpr int STAGE = PATCH + WTS;
  static constexpr size_t SMEM = (size_t)STAGES * STAGE * 4;
  static_assert(MT % 2 == 0, "a pool window's two rows are a warp's");
};

// x rounded to TF32 (to nearest, ties away from zero) as the tensor cores
// read it: they drop the low 13 bits, so adding half of that step first
// rounds a finite x as `cvt.rna.tf32.f32` does
__device__ __forceinline__ uint32_t tf32(float x) {
  return __float_as_uint(x) + 0x1000u;
}

// x rounded to TF32 as a float (the low 13 bits cleared)
__device__ __forceinline__ float tf32_hi(float x) {
  return __uint_as_float(tf32(x) & 0xFFFFE000u);
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

struct Tile {
  int b, y0, x0, n0;  // image, first row and column (before the pool),
                      // first output channel
};

__device__ __forceinline__ Tile tile_at(const Params& p, int q, int th) {
  Tile t;
  const int nb = q % p.nblocks, r = q / p.nblocks;
  const int tx = r % p.tiles_x, r2 = r / p.tiles_x;
  t.b = r2 / p.tiles_y;
  t.y0 = (r2 % p.tiles_y) * th;
  t.x0 = tx * TW;
  t.n0 = nb * BN;
  return t;
}

// a walk over this CTA's tiles (blockIdx.x, + gridDim.x, ...) a chunk at a
// time: the tile is decoded once, when the walk enters it
struct Cursor {
  int q, chunk;
  Tile tile;
  __device__ __forceinline__ void start(const Params& p, int th) {
    q = blockIdx.x;
    chunk = 0;
    tile = tile_at(p, q, th);
  }
  __device__ __forceinline__ void next(const Params& p, int th) {
    if (++chunk == p.chunks) {
      chunk = 0;
      q += gridDim.x;
      if (q < p.ntiles) tile = tile_at(p, q, th);
    }
  }
};

// stage `chunk` of tile t: the patch's 16 channels from c0 = 16 chunk,
// pixel-major (16 floats a pixel), and the weights [tap][channel][16]
template <int KS, int MT>
__device__ __forceinline__ void load_stage(const Params& p, const Tile& t,
                                           int chunk, float* stage) {
  using S = Shape<KS, MT>;
  float* patch = stage;
  float* wts = stage + S::PATCH;
  const int c0 = chunk * KC;
  for (int i = threadIdx.x; i < S::PH * S::PW * 4; i += NT) {
    const int pix = i >> 2, j = i & 3;
    const int py = pix / S::PW, px = pix - py * S::PW;
    const int iy = t.y0 - S::P + py, ix = t.x0 - S::P + px;
    const int ch = c0 + 4 * j;
    const bool ok = iy >= 0 && iy < p.H && ix >= 0 && ix < p.W && ch < p.Cin;
    const float* src =
        ok ? p.x + (((long long)t.b * p.H + iy) * p.W + ix) * p.Cin + ch : p.x;
    cp_async16(patch + pix * KC + 4 * j, src, ok);
  }
  for (int i = threadIdx.x; i < S::TAPS * BN * 4; i += NT) {
    const int j = i & 3, r = i >> 2;
    const int co = r % BN, tap = r / BN;
    const int oc = t.n0 + co, ch = c0 + 4 * j;
    const bool ok = oc < p.Cout && ch < p.Cin;
    const float* src =
        ok ? p.w + ((long long)oc * S::TAPS + tap) * p.Cin + ch : p.w;
    cp_async16(wts + (tap * BN + co) * KC + 4 * j, src, ok);
  }
}

// one stage's products into acc: every tap, two k-steps of 8 channels
template <int KS, int MT, bool F32>
__device__ __forceinline__ void compute_stage(const float* stage,
                                              float (&acc)[MT][8][4], int row0,
                                              int col0, int g, int t) {
  using S = Shape<KS, MT>;
  const float* patch = stage;
  const float* wts = stage + S::PATCH;
#pragma unroll
  for (int tap = 0; tap < S::TAPS; ++tap) {
    const int dy = tap / KS, dx = tap % KS;
    // A: rows g and g + 8 of m-tile mt are the pixels (row0 + mt, col0 +
    // g) and (row0 + mt, col0 + g + 8), read at the tap's offset
    float4 xa[MT], xb[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float* a =
          patch + ((row0 + mt + dy) * S::PW + col0 + dx + g) * KC + 4 * t;
      xa[mt] = *reinterpret_cast<const float4*>(a);
      xb[mt] = *reinterpret_cast<const float4*>(a + 8 * KC);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float4 wv = *reinterpret_cast<const float4*>(
          wts + (tap * BN + 8 * n + g) * KC + 4 * t);
      // k-step 0 takes channels 4 t (k index t) and 4 t + 1 (t + 4);
      // k-step 1 channels 4 t + 2 and 4 t + 3
      const float bw[2][2] = {{wv.x, wv.y}, {wv.z, wv.w}};
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        if constexpr (F32) {
          const float h0 = tf32_hi(bw[ks][0]), h1 = tf32_hi(bw[ks][1]);
          const uint32_t bh0 = __float_as_uint(h0), bh1 = __float_as_uint(h1);
          const uint32_t bl0 = tf32(bw[ks][0] - h0);
          const uint32_t bl1 = tf32(bw[ks][1] - h1);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const float av[4] = {ks ? xa[mt].z : xa[mt].x,
                                 ks ? xb[mt].z : xb[mt].x,
                                 ks ? xa[mt].w : xa[mt].y,
                                 ks ? xb[mt].w : xb[mt].y};
            uint32_t ah[4], al[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float hi = tf32_hi(av[e]);
              ah[e] = __float_as_uint(hi);
              al[e] = tf32(av[e] - hi);
            }
            float c[4] = {0.f, 0.f, 0.f, 0.f};
            mma_tf32(c, al, bh0, bh1);
            mma_tf32(c, ah, bl0, bl1);
            mma_tf32(c, ah, bh0, bh1);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][n][e] += c[e];
          }
        } else {
          const uint32_t b0 = tf32(bw[ks][0]), b1 = tf32(bw[ks][1]);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const uint32_t a[4] = {tf32(ks ? xa[mt].z : xa[mt].x),
                                   tf32(ks ? xb[mt].z : xb[mt].x),
                                   tf32(ks ? xa[mt].w : xa[mt].y),
                                   tf32(ks ? xb[mt].w : xb[mt].y)};
            mma_tf32(acc[mt][n], a, b0, b1);
          }
        }
      }
    }
  }
}

// bias, ReLU and the store of two neighbouring channels o, o + 1 of one
// output pixel
__device__ __forceinline__ void store2(const Params& p, long long pix, int o,
                                       float v0, float v1, float2 bias,
                                       bool vec2) {
  if (o >= p.Cout) return;
  float* dst = p.y + pix * p.Cout + o;
  v0 += bias.x;
  v1 += bias.y;
  if (p.relu) {
    v0 = fmaxf(v0, 0.f);
    v1 = fmaxf(v1, 0.f);
  }
  if (o + 1 < p.Cout) {
    if (vec2) {
      *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
      return;
    }
    dst[1] = v1;
  }
  dst[0] = v0;
}

// the accumulator tile's outputs: thread (g, t) holds rows g, g + 8 (e 0,
// 1 and 2, 3) and channels 2 t, 2 t + 1 of each 8-channel tile n
template <int MT>
__device__ __forceinline__ void epilogue(const Params& p, const Tile& tl,
                                         float (&acc)[MT][8][4], int row0,
                                         int col0, int g, int t) {
  const bool vec2 = (p.Cout & 1) == 0;
  float2 bias[8];  // channels 2 t, 2 t + 1 of each 8-channel tile
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int o = tl.n0 + 8 * n + 2 * t;
    bias[n] = make_float2(o < p.Cout ? __ldg(p.bias + o) : 0.f,
                          o + 1 < p.Cout ? __ldg(p.bias + o + 1) : 0.f);
  }
  if (p.pool) {
    // a window's rows: m-tiles 2 i and 2 i + 1; its columns: pixel g and
    // g ^ 1, the lane 4 apart. After the exchange every lane holds its
    // pair's maximum; even g writes the row-g window, odd g the row g + 8
    const int half = g & 1;
    const int ox = (tl.x0 + col0 + (g & ~1) + 8 * half) >> 1;
#pragma unroll
    for (int i = 0; i < MT / 2; ++i) {
      const int oy = (tl.y0 + row0 + 2 * i) >> 1;
      const bool in = oy < p.Ho && ox < p.Wo;
      const long long pix = ((long long)tl.b * p.Ho + oy) * p.Wo + ox;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[e] = fmaxf(acc[2 * i][n][e], acc[2 * i + 1][n][e]);
          v[e] = fmaxf(v[e], __shfl_xor_sync(0xffffffffu, v[e], 4));
        }
        if (in)
          store2(p, pix, tl.n0 + 8 * n + 2 * t, half ? v[2] : v[0],
                 half ? v[3] : v[1], bias[n], vec2);
      }
    }
  } else {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int oy = tl.y0 + row0 + mt;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ox = tl.x0 + col0 + g + 8 * half;
        if (oy >= p.Ho || ox >= p.Wo) continue;
        const long long pix = ((long long)tl.b * p.Ho + oy) * p.Wo + ox;
#pragma unroll
        for (int n = 0; n < 8; ++n)
          store2(p, pix, tl.n0 + 8 * n + 2 * t, acc[mt][n][2 * half],
                 acc[mt][n][2 * half + 1], bias[n], vec2);
      }
    }
  }
}

template <int KS, int MT, bool F32>
__global__ void __launch_bounds__(NT, 1) conv_nhwc_kernel(const Params p) {
  using S = Shape<KS, MT>;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (warp / WARPS_W) * MT, col0 = (warp % WARPS_W) * 16;

  // this CTA's tiles are blockIdx.x, + gridDim.x, ...; its stages run on
  // across them, `chunks` a tile: `ld` walks STAGES - 1 stages ahead of
  // `cur`
  if ((int)blockIdx.x >= p.ntiles) return;
  const int total = ((p.ntiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1) *
                    p.chunks;
  Cursor ld, cur;
  ld.start(p, S::TH);
  cur = ld;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) {
      load_stage<KS, MT>(p, ld.tile, ld.chunk, smem + s * S::STAGE);
      ld.next(p, S::TH);
    }
    cp_async_commit();
  }

  float acc[MT][8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;

  int slot = 0;  // the ring's stage s % STAGES
  for (int s = 0; s < total; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    // the buffer this refills was read in step s - 1, which every thread
    // has finished: they all passed the barrier above
    if (s + STAGES - 1 < total) {
      const int fill = slot == 0 ? STAGES - 1 : slot - 1;
      load_stage<KS, MT>(p, ld.tile, ld.chunk, smem + fill * S::STAGE);
      ld.next(p, S::TH);
    }
    cp_async_commit();
    compute_stage<KS, MT, F32>(smem + slot * S::STAGE, acc, row0, col0, g, t);
    slot = slot + 1 == STAGES ? 0 : slot + 1;
    if (cur.chunk + 1 == p.chunks) {
      epilogue<MT>(p, cur.tile, acc, row0, col0, g, t);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
    }
    cur.next(p, S::TH);
  }
  cp_async_wait<0>();
}

// one input channel, 3x3, no pool (SuperPoint's first layer): a CTA owns
// one output row; a thread owns 4 output channels (their weights and bias
// in registers) of every (256 / (Cout / 4))-th output pixel of it, so a
// warp writes whole pixels, contiguous
constexpr int C1_NT = 256;
constexpr int C1_PIX = 4;

__global__ void __launch_bounds__(C1_NT) conv_c1_kernel(const Params p,
                                                        int round_tf32) {
  const int groups = p.Cout >> 2, per = C1_NT / groups;
  const int grp = threadIdx.x % groups, pix0 = threadIdx.x / groups;
  if (pix0 >= per) return;
  float w[9][4];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = __ldg(p.w + (4 * grp + e) * 9 + tap);
      w[tap][e] = round_tf32 ? tf32_hi(v) : v;
    }
  const float4 bias = *reinterpret_cast<const float4*>(p.bias + 4 * grp);
  // the output's rows and columns from Ho, Wo (here H, W): with the input
  // bounds in fields of their own the kernel ran 7% faster on an H100
  const int b = blockIdx.x / p.Ho, oy = blockIdx.x % p.Ho;
  const float* xb = p.x + (long long)b * p.H * p.W;
  float* yrow = p.y + (long long)blockIdx.x * p.Wo * p.Cout + 4 * grp;
  // C1_PIX pixels a thread at a time, their loads in flight together
  for (int ox0 = pix0; ox0 < p.Wo; ox0 += per * C1_PIX) {
    float in[C1_PIX][3][3];
#pragma unroll
    for (int u = 0; u < C1_PIX; ++u) {
      const int x0 = ox0 + u * per - 1;
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const int iy = oy - 1 + i, ix = x0 + j;
          float v = 0.f;
          if (iy >= 0 && iy < p.H && ix >= 0 && ix < p.W)
            v = __ldg(xb + (long long)iy * p.W + ix);
          in[u][i][j] = round_tf32 ? tf32_hi(v) : v;
        }
    }
#pragma unroll
    for (int u = 0; u < C1_PIX; ++u) {
      const int ox = ox0 + u * per;
      if (ox >= p.Wo) break;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const float v = in[u][tap / 3][tap % 3];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] = fmaf(v, w[tap][e], acc[e]);
      }
      float4 out = make_float4(acc[0] + bias.x, acc[1] + bias.y,
                               acc[2] + bias.z, acc[3] + bias.w);
      if (p.relu) {
        out.x = fmaxf(out.x, 0.f);
        out.y = fmaxf(out.y, 0.f);
        out.z = fmaxf(out.z, 0.f);
        out.w = fmaxf(out.w, 0.f);
      }
      *reinterpret_cast<float4*>(yrow + (long long)ox * p.Cout) = out;
    }
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

template <int KS, int MT, bool F32>
cudaError_t run(Params p, int B, cudaStream_t stream) {
  using S = Shape<KS, MT>;
  auto kern = conv_nhwc_kernel<KS, MT, F32>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::SMEM);
  if (e != cudaSuccess) return e;
  // rows and columns before the pool (a last odd one left out)
  const int hc = p.pool ? 2 * p.Ho : p.Ho, wc = p.pool ? 2 * p.Wo : p.Wo;
  p.tiles_y = (hc + S::TH - 1) / S::TH;
  p.tiles_x = (wc + TW - 1) / TW;
  p.nblocks = (p.Cout + BN - 1) / BN;
  p.chunks = (p.Cin + KC - 1) / KC;
  const long long ntiles = (long long)B * p.tiles_y * p.tiles_x * p.nblocks;
  if (ntiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  p.ntiles = (int)ntiles;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT,
                                                    S::SMEM);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int cap = per_sm * sm_count();
  kern<<<p.ntiles < cap ? p.ntiles : cap, NT, S::SMEM, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// x (B, H, W, Cin), w (Cout, k, k, Cin) and bias (Cout) float32,
// contiguous; y (B, Ho, Wo, Cout) float32, contiguous, with Ho, Wo = H / 2,
// W / 2 when `pool` is nonzero, else H, W. k is 1 or 3 ("same" padding);
// Cin is a multiple of 4, or 1 with k 3, no pool and Cout a multiple of 4
// up to 1024; x, w, bias and y start on 16 bytes. `relu` nonzero applies
// the ReLU; `full_f32` nonzero computes the products in full float32
// (3xTF32), else TF32. One launch on `stream`; returns its CUDA error (0
// on success).
extern "C" int conv_nhwc_launch(const float* x, const float* w,
                                const float* bias, float* y, int B, int H,
                                int W, int Cin, int Cout, int k, int relu,
                                int pool, int full_f32, cudaStream_t stream) {
  if (B < 0 || H < 0 || W < 0 || Cin < 1 || Cout < 1 || (k != 1 && k != 3))
    return (int)cudaErrorInvalidValue;
  if (Cin != 1 && Cin % 4) return (int)cudaErrorInvalidValue;
  if (Cin == 1 && (k != 3 || pool || Cout % 4 || Cout > 4 * C1_NT ||
                   (long long)B * H > 0x7fffffffLL))
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)x | (uintptr_t)w | (uintptr_t)bias | (uintptr_t)y) % 16)
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.x = x;
  p.w = w;
  p.bias = bias;
  p.y = y;
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.Cout = Cout;
  p.Ho = pool ? H / 2 : H;
  p.Wo = pool ? W / 2 : W;
  p.relu = relu != 0;
  p.pool = pool != 0;
  if (B == 0 || p.Ho == 0 || p.Wo == 0) return 0;
  cudaError_t e;
  if (Cin == 1) {
    conv_c1_kernel<<<B * H, C1_NT, 0, stream>>>(p, !full_f32);
    e = cudaGetLastError();
  } else if (full_f32) {
    e = k == 3 ? run<3, 2, true>(p, B, stream) : run<1, 2, true>(p, B, stream);
  } else {
    e = k == 3 ? run<3, 4, false>(p, B, stream)
               : run<1, 4, false>(p, B, stream);
  }
  return (int)e;
}
