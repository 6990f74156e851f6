// DoG stack and 3x3x3 extremum score of one SIFT octave in one pass: the
// `dog_extrema` kernel.
//
// Replaces no TPU kernel. The reference computes the same mask in XLA with
// separable `lax.reduce_window` passes (`tpu3drec/ops/sift.py:97-116`),
// which the TPU's compiler fuses; the port's plain form
// (`tpu3drec_torch/ops/sift.py:dog_extrema_plain`) is about 16 PyTorch
// launches an octave: the subtraction, two `max_pool3d` passes (one on a
// negated copy, both writing int64 indices nobody reads), the comparisons,
// the gates and the `where`. For a Gaussian stack gauss (B, S, h, w) it
// writes
//
//     dog[b, d]   = gauss[b, d + 1] - gauss[b, d]                (d < S - 1)
//     score[b, d] = |dog| where dog >= the max or <= the min of its 3x3x3
//                   neighbourhood (itself included), |dog| > prelim, d in
//                   1..S-3 and the pixel `border` px or more inside every
//                   edge; 0 elsewhere.
//
// bit for bit as the plain form: the subtraction is one float32 operation,
// max and min are exact in any order (`max.NaN` / `min.NaN` propagate a NaN
// as `max_pool3d`'s scan does), and `prelim` comes in rounded to float32,
// as PyTorch rounds the Python scalar it compares with. Every pixel the
// gates keep has its whole neighbourhood inside the stack, so the pools'
// -inf padding never decides an output.
//
// What bounds it: bytes. It reads the Gaussian stack once and writes the
// DoG stack and the score once, (S + 2 (S - 1)) x 4 = 64 bytes a pixel at
// S = 6, against ~54 comparisons a kept pixel. The b96 pair step (192
// images, five octaves from 480x640, 409,200 pixels an image) moves
// 5.03 GB: 1.50 ms at 3.35 TB/s.
//
// Design. A CTA of 256 threads owns a tile of 16 rows x 16 vectors of one
// image (a vector is 4 floats where every row starts on 16 bytes, else 1)
// and walks the scale axis once. Per Gaussian level it stages the tile
// with a one-vector, one-row halo: each thread loads at most two vectors
// (16-byte `ld.global.nc` where it can), keeps the previous level's in
// registers, forms the DoG vector there, writes it out if it lies in the
// tile and stores it to a double-buffered shared stage (one barrier a
// level). The next level's loads start before the barrier. Each
// thread then reads its own vector's 3x3 neighbourhood from the stage and
// folds it into a spatial max and min, so the rolling window across scale
// is two levels of per-pixel max / min and one of centres, all in
// registers: the 3x3x3 test for level d - 1 takes the pair max of levels
// d - 2 and d - 1 and the spatial max of level d. Levels 0 and S - 2 of
// the score are written as zeros. Halo rows and vectors are read again by
// the neighbouring tiles, mostly from L2. Three CTAs an SM (80 registers):
// capped at four, the vector path spills 40 bytes and takes 2.15 ms at the
// b96 shapes against 1.92 (78% of the bound); two CTAs, or tiles of 8 or
// 32 rows, take 2.13-2.26 ms (NVIDIA H100 80GB HBM3, 700 W).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;    // threads per CTA
constexpr int TVX = 16;    // output vectors per tile row
constexpr int TY = 16;     // output rows per tile
static_assert(TVX * TY == NT, "one output vector a thread");

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

template <int V>
struct Vec {
  float v[V];
};

template <int V>
__device__ __forceinline__ Vec<V> load_vec(const float* p) {
  Vec<V> r;
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    r.v[0] = t.x; r.v[1] = t.y; r.v[2] = t.z; r.v[3] = t.w;
  } else {
    r.v[0] = __ldg(p);
  }
  return r;
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const Vec<V>& r) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r.v[0], r.v[1], r.v[2], r.v[3]);
  } else {
    *p = r.v[0];
  }
}

template <int V>
__device__ __forceinline__ Vec<V> zero_vec() {
  Vec<V> r;
#pragma unroll
  for (int i = 0; i < V; ++i) r.v[i] = 0.f;
  return r;
}

template <int V>
__global__ void __launch_bounds__(NT, 3)
dog_extrema_kernel(const float* __restrict__ gauss, float* __restrict__ dog,
                   float* __restrict__ score, int S, int h, int w,
                   int tiles_x, int tiles_y, float prelim, int border) {
  constexpr int RV = TVX + 2;             // staged vectors a row
  constexpr int SW = RV * V;              // staged floats a row
  constexpr int NSLOT = (TY + 2) * RV;    // staged vectors a level
  constexpr int PER = (NSLOT + NT - 1) / NT;
  __shared__ __align__(16) float stage[2][TY + 2][SW];

  const int tid = threadIdx.x;
  const long long tile = blockIdx.x;
  const int tx = (int)(tile % tiles_x);
  const int ty = (int)((tile / tiles_x) % tiles_y);
  const long long b = tile / ((long long)tiles_x * tiles_y);
  const int x0 = tx * TVX * V;
  const int y0 = ty * TY;
  const size_t plane = (size_t)h * w;
  const int D = S - 1;
  const float* g = gauss + (size_t)b * S * plane;
  float* dg = dog + (size_t)b * D * plane;
  float* sc = score + (size_t)b * D * plane;

  // this thread's staged vectors: offset in a plane (-1 off the image),
  // place in the stage (-1 past the last slot), and whether the DoG
  // vector is the tile's own, to be written out
  int off[PER], sro[PER], sco[PER];
  bool own[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int slot = tid + k * NT;
    const int r = slot / RV, c = slot % RV;
    const int y = y0 - 1 + r, x = x0 + (c - 1) * V;
    const bool in = slot < NSLOT && y >= 0 && y < h && x >= 0 && x < w;
    off[k] = in ? y * w + x : -1;
    sro[k] = slot < NSLOT ? r : -1;
    sco[k] = c * V;
    own[k] = in && r >= 1 && r <= TY && c >= 1 && c <= TVX;
  }

  // this thread's output vector
  const int ox = tid % TVX, oy = tid / TVX;
  const int py = y0 + oy, px = x0 + ox * V;
  const bool out_in = py < h && px < w;
  const int out_off = py * w + px;
  const bool row_ok = py >= border && py < h - border;

  Vec<V> gp[PER], gn[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    gp[k] = off[k] >= 0 ? load_vec<V>(g + off[k]) : zero_vec<V>();
    gn[k] = off[k] >= 0 ? load_vec<V>(g + plane + off[k]) : zero_vec<V>();
  }

  // rolling state: spatial max / min of the previous level, pair max / min
  // of the two previous levels, the previous level's centres
  float m_prev[V], n_prev[V], m_pair[V], n_pair[V], c_prev[V];
#pragma unroll
  for (int i = 0; i < V; ++i)
    m_prev[i] = n_prev[i] = m_pair[i] = n_pair[i] = c_prev[i] = 0.f;

  for (int d = 0; d < D; ++d) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      Vec<V> dv;
#pragma unroll
      for (int i = 0; i < V; ++i) dv.v[i] = __fsub_rn(gn[k].v[i], gp[k].v[i]);
      gp[k] = gn[k];
      if (d + 2 < S && off[k] >= 0)
        gn[k] = load_vec<V>(g + (size_t)(d + 2) * plane + off[k]);
      if (sro[k] >= 0) store_vec<V>(&stage[d & 1][sro[k]][sco[k]], dv);
      if (own[k]) store_vec<V>(dg + (size_t)d * plane + off[k], dv);
    }
    if (d == 0 && out_in) store_vec<V>(sc + out_off, zero_vec<V>());
    __syncthreads();

    // the 3x3 neighbourhood of this thread's vector, from the stage
    float mx[V], mn[V], cen[V];
#pragma unroll
    for (int rr = 0; rr < 3; ++rr) {
      const float* row = &stage[d & 1][oy + rr][V + ox * V - 1];
      float wv[V + 2];
      wv[0] = row[0];
      if constexpr (V == 4) {
        const float4 t = *reinterpret_cast<const float4*>(row + 1);
        wv[1] = t.x; wv[2] = t.y; wv[3] = t.z; wv[4] = t.w;
      } else {
        wv[1] = row[1];
      }
      wv[V + 1] = row[V + 1];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float hx = max_nan(max_nan(wv[i], wv[i + 1]), wv[i + 2]);
        const float hn = min_nan(min_nan(wv[i], wv[i + 1]), wv[i + 2]);
        mx[i] = rr == 0 ? hx : max_nan(mx[i], hx);
        mn[i] = rr == 0 ? hn : min_nan(mn[i], hn);
        if (rr == 1) cen[i] = wv[i + 1];
      }
    }

    if (d >= 2) {    // level d - 1 has both scale neighbours
      Vec<V> out;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float hi = max_nan(m_pair[i], mx[i]);
        const float lo = min_nan(n_pair[i], mn[i]);
        const float c = c_prev[i];
        const float a = fabsf(c);
        const int x = px + i;
        const bool keep = (c >= hi || c <= lo) && a > prelim && row_ok &&
                          x >= border && x < w - border;
        out.v[i] = keep ? a : 0.f;
      }
      if (out_in) store_vec<V>(sc + (size_t)(d - 1) * plane + out_off, out);
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (d >= 1) {
        m_pair[i] = max_nan(m_prev[i], mx[i]);
        n_pair[i] = min_nan(n_prev[i], mn[i]);
      }
      m_prev[i] = mx[i];
      n_prev[i] = mn[i];
      c_prev[i] = cen[i];
    }
  }
  if (out_in) store_vec<V>(sc + (size_t)(D - 1) * plane + out_off, zero_vec<V>());
}

template <int V>
int launch(const float* gauss, float* dog, float* score, int B, int S, int h,
           int w, float prelim, int border, cudaStream_t stream) {
  const int tiles_x = (w + TVX * V - 1) / (TVX * V);
  const int tiles_y = (h + TY - 1) / TY;
  const long long tiles = (long long)B * tiles_x * tiles_y;
  if (tiles > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  dog_extrema_kernel<V><<<(unsigned)tiles, NT, 0, stream>>>(
      gauss, dog, score, S, h, w, tiles_x, tiles_y, prelim, border);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// DoG stack `dog` and extremum score `score`, each (B, S - 1, h, w)
// float32, of the Gaussian stack `gauss` (B, S, h, w) float32, all
// contiguous, on `stream`: one kernel launch. `prelim` is the contrast
// gate as float32, `border` the width of the edge band kept clear.
// 16-byte vectors where w % 4 == 0 and all three pointers lie on 16 bytes,
// single floats otherwise. Returns the launch's CUDA error (0 on success).
extern "C" int dog_extrema_launch(const float* gauss, float* dog, float* score,
                                  int B, int S, int h, int w, float prelim,
                                  int border, cudaStream_t stream) {
  if (B < 0 || S < 3 || h < 0 || w < 0 || border < 1)
    return (int)cudaErrorInvalidValue;
  if ((long long)h * w > INT_MAX) return (int)cudaErrorInvalidValue;
  if (B == 0 || h == 0 || w == 0) return 0;
  if (w % 4 == 0 && aligned16(gauss) && aligned16(dog) && aligned16(score))
    return launch<4>(gauss, dog, score, B, S, h, w, prelim, border, stream);
  return launch<1>(gauss, dog, score, B, S, h, w, prelim, border, stream);
}
