// Masked softmax attention in one pass: the `masked_attention` kernel.
//
// Replaces no TPU kernel. The reference computes LightGlue's attention with
// XLA einsums and softmaxes (`tpu3drec/models/lightglue.py:106-108` for the
// self blocks, `:137-143` for the cross block), which write the (h, N, N)
// scores to memory; the port's plain form
// (`tpu3drec_torch/ops/attention.py:masked_attention_plain`) does the same
// in PyTorch: a TF32 GEMM, the scale, `masked_fill`, the softmax and a
// second GEMM, five passes over a float32 score tensor of B x h x Nq x Nk.
// For q (B, Nq, h, dh), k and v (B, Nk, h, dh) and a key mask (B, Nk) this
// kernel writes
//
//     o[b, n, i] = sum_m softmax_m(s[b, i, n, m]) v[b, m, i]
//     s[b, i, n, m] = scale * q[b, n, i] . k[b, m, i]   where mask[b, m]
//                   = -1e9                              elsewhere
//
// and nothing else: no score, mask fill or softmax reaches device memory.
// A masked key's score is replaced, not left out, so a row whose keys are
// all masked is the plain mean of v over all Nk keys, as in the plain form;
// the slots past Nk that exist only because tiles are rounded up are left
// out (their weight is exactly 0).
//
// Precision: the products q.k^T and P.v take TF32 operands (rounded to
// nearest, ties away, as `cvt.rna.tf32.f32` rounds) with float32
// accumulators, what cuBLAS does for the plain form under `allow_tf32`;
// the scale, the running maximum, exp2 (`ex2.approx`, with the scale
// folded into a log2(e) prescale) and the row sums are float32. P is
// rounded to TF32 for P.v, as cuBLAS rounds the materialised softmax.
// Nothing is held in a type narrower than TF32. Full float32 (`F32`, for
// callers with TF32 off) splits each operand x into hi = tf32(x) and
// lo = tf32(x - hi) and takes hi.hi' + hi.lo' + lo.hi' on the tensor cores
// in both products (3xTF32: 22 of float32's 24 bits, three times the
// MMAs), with 64-row tiles; each 8-key block's P.v products start from
// zero and join o by a float32 add, as the tensor cores' accumulation
// truncates.
//
// What bounds it: operations. 4 Nq Nk dh flops a (sequence, head), against
// q, k, v and o read or written once: at LightGlue's self blocks (32
// sequences, 2,048 keypoints, 4 heads, dh 64) 137.4 GFLOP against 0.27 GB,
// 0.278 ms at 494.7 TFLOP/s TF32 and 0.08 ms at 3.35 TB/s.
//
// Design (the FlashAttention-2 loop on `mma.sync.m16n8k8` TF32). A CTA of
// four warps owns a tile of 128 query rows of one (sequence, head), 64
// where dh is above 64 or in full float32; each warp owns 32 (MT = 2) or
// 16 (MT = 1) rows, their q fragments held in registers for the whole
// loop. The CTA streams the key and value tiles of 64 keys through a
// two-stage `cp.async` ring in shared memory
// (zero-filled past Nk and past dh), with each key's score map (scale,
// -1e9 or -inf). Per tile each warp computes its S = q k^T fragments,
// folds them into a running row maximum and row sum (the online softmax,
// four lanes a row, two shuffles) and adds P.v, all in registers. The
// running maxima move only when a row of the warp finds a score above its
// maximum by more than a factor 2^8 (P stays below 256), so most tiles
// skip the rescale of the accumulators. The summation over dh and over
// keys is order-free, which the fragment layouts use:
//   - within each 16 columns of dh, a thread's two k-steps read the four
//     consecutive floats 4 t .. 4 t + 3 of a k row (one 16-byte load, k
//     rows 16 floats apart modulo 32 banks: no conflicts), and its q
//     fragments are loaded the same way;
//   - P.v takes P straight from S's accumulators: the accumulator's
//     columns 2 t and 2 t + 1 of an 8-key tile act as the product's k
//     indices t and t + 4, and v's fragment rows follow (v rows 4 floats
//     apart modulo 32 banks: no conflicts), so there is no shuffle and no
//     transpose of v.
// The query tile follows dh and the precision alone: at dh 72-128 (or with
// the split operands of full float32), 32 rows a warp would hold twice the
// q fragments and accumulators that fit in registers. dh is padded to 32,
// 64 or 128 inside the kernel.
//
// On an NVIDIA H100 80GB HBM3 at 700 W a self launch at the shape above
// takes 0.93-0.94 ms (147 TFLOP/s, 30% of the TF32 peak; `mma.sync` TF32
// alone peaks at 320 TFLOP/s there). About 250 registers at 128 rows hold
// two CTAs an SM. Measured and left out: `cvt.rna.tf32.f32` for the
// rounding (the same bits, 0.99 ms), rounding k and v once in shared
// memory (no faster), truncating operands to TF32 (2-3x the error),
// 32-key tiles, eight warps a CTA, row sums on the tensor cores and an
// all-valid fast path (each 2-13% slower), and a 64-row tile where the
// grid leaves SMs idle: at one sequence (the folder engine's one pair a
// call) it is within 5% at 512-1,024 keypoints and 15-30% slower at
// 2,048-4,096.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 4;
constexpr int NT = NWARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;
// the plain form's fill, -1e9, in the log2 domain of the running softmax
constexpr float MASKED_L2 = -1e9f * LOG2E;

constexpr int BN = 64;  // keys a tile
// how far a row's maximum may grow (log2 domain) before the running
// maximum moves and the accumulators are rescaled: P stays below 2^8
constexpr float LAZY_L2 = 8.f;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const uint8_t* mask;
  float* o;
  long long q_sb, q_sn, q_sh;  // strides in floats; dh has stride 1
  long long k_sb, k_sn, k_sh;
  long long v_sb, v_sn, v_sh;
  long long o_sb, o_sn, o_sh;
  int nq, nk, dh;
  float scale_l2;  // scale * log2(e)
};

// DHP: dh padded; MT: 16-row m-tiles a warp
template <int DHP, int MT>
struct Shape {
  static constexpr int BM = NWARPS * 16 * MT;
  static constexpr int SK = DHP + 16;  // k row stride (floats): 16 mod 32
  static constexpr int SV = DHP + 4;   // v row stride (floats): 4 mod 32
  // a stage: k, v, then a (multiplier, addend) pair a key
  static constexpr int STAGE = BN * (SK + SV + 2);
  static constexpr size_t SMEM = (size_t)2 * STAGE * 4;
  static_assert(DHP % 16 == 0 && BN % 16 == 0, "tile shapes");
};

// x rounded to TF32 (to nearest, ties away from zero) as the tensor cores
// read it: they drop the low 13 bits, so adding half of that step first
// rounds a finite x as `cvt.rna.tf32.f32` does, in one integer add (the
// cvt is three instructions on this card)
__device__ __forceinline__ uint32_t tf32(float x) {
  return __float_as_uint(x) + 0x1000u;
}

// x rounded to TF32 as a float (the low 13 bits cleared), so that x - hi
// is exact: the split of full float32 mode
__device__ __forceinline__ float tf32_hi(float x) {
  return __uint_as_float(tf32(x) & 0xFFFFE000u);
}

// 2^x to ~2 ulp; 2^-inf = 0
__device__ __forceinline__ float exp2_(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
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

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// One key tile of k and v into a stage, and each key's score map: the
// score in the log2 domain is fma(q.k, mul, add), with (scale log2(e), 0)
// for a valid key, (0, -1e9 log2(e)) for a masked one and (0, -inf) for
// the padding past nk.
template <int DHP, int MT>
__device__ __forceinline__ void load_tile(const Params& p, const float* K,
                                          const float* V, const uint8_t* M,
                                          int tile, float* stage) {
  using S = Shape<DHP, MT>;
  constexpr int CHUNKS = DHP / 4;  // 16-byte chunks a row
  float* ks = stage;
  float* vs = stage + BN * S::SK;
  float2* kmap = reinterpret_cast<float2*>(vs + BN * S::SV);
  const int key0 = tile * BN;
#pragma unroll
  for (int i = threadIdx.x; i < BN * CHUNKS; i += NT) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    const int key = key0 + r;
    const bool ok = key < p.nk && 4 * c < p.dh;
    const long long kr = ok ? key : 0;
    const int cc = ok ? c : 0;
    cp_async16(ks + r * S::SK + 4 * c, K + kr * p.k_sn + 4 * cc, ok);
    cp_async16(vs + r * S::SV + 4 * c, V + kr * p.v_sn + 4 * cc, ok);
  }
  for (int r = threadIdx.x; r < BN; r += NT) {
    const int key = key0 + r;
    kmap[r] = key >= p.nk ? make_float2(0.f, -INFINITY)
              : M[key]    ? make_float2(p.scale_l2, 0.f)
                          : make_float2(0.f, MASKED_L2);
  }
}

// F32: full float32 (3xTF32); q fragments then hold float32 bits
template <int DHP, int MT, bool F32>
__global__ void __launch_bounds__(NT)
    masked_attention_kernel(const Params p) {
  using S = Shape<DHP, MT>;
  constexpr int KS = DHP / 8;  // k-steps over dh; n-tiles of the output
  constexpr int NB = BN / 8;   // n-tiles of a score tile; k-steps of P.v
  extern __shared__ __align__(16) float smem[];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int row0 = blockIdx.x * S::BM + warp * 16 * MT;
  const float* Q = p.q + b * p.q_sb + h * p.q_sh;
  const float* K = p.k + b * p.k_sb + h * p.k_sh;
  const float* V = p.v + b * p.v_sb + h * p.v_sh;
  const uint8_t* M = p.mask + (long long)b * p.nk;
  const int tiles = (p.nk + BN - 1) / BN;

  load_tile<DHP, MT>(p, K, V, M, 0, smem);
  cp_async_commit();

  // q fragments: k-step 2 s + j holds dh columns 16 s + 4 t + 2 j (as k
  // index t) and + 1 (as k index t + 4), rows g (a0, a2) and g + 8 (a1, a3)
  uint32_t qf[MT][KS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + mt * 16 + g + 8 * half;
#pragma unroll
      for (int s = 0; s < DHP / 16; ++s) {
        const int d = 16 * s + 4 * t;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row < p.nq && d < p.dh)
          x = __ldg(reinterpret_cast<const float4*>(Q + row * p.q_sn + d));
        if constexpr (F32) {
          qf[mt][2 * s][half] = __float_as_uint(x.x);
          qf[mt][2 * s][2 + half] = __float_as_uint(x.y);
          qf[mt][2 * s + 1][half] = __float_as_uint(x.z);
          qf[mt][2 * s + 1][2 + half] = __float_as_uint(x.w);
        } else {
          qf[mt][2 * s][half] = tf32(x.x);
          qf[mt][2 * s][2 + half] = tf32(x.y);
          qf[mt][2 * s + 1][half] = tf32(x.z);
          qf[mt][2 * s + 1][2 + half] = tf32(x.w);
        }
      }
    }
  }

  float acc[MT][KS][4];
  float mrow[MT][2], lrow[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < KS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
    mrow[mt][0] = mrow[mt][1] = -INFINITY;
    lrow[mt][0] = lrow[mt][1] = 0.f;
  }

  for (int tile = 0; tile < tiles; ++tile) {
    const int st = tile & 1;
    if (tile + 1 < tiles)
      load_tile<DHP, MT>(p, K, V, M, tile + 1, smem + (st ^ 1) * S::STAGE);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const float* ks = smem + st * S::STAGE;
    const float* vs = ks + BN * S::SK;
    const float2* kmap = reinterpret_cast<const float2*>(vs + BN * S::SV);

    // S = q k^T: n-tile j is keys 8 j + (0..7), the thread's key 8 j + g
    float sc[MT][NB][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[mt][j][e] = 0.f;
    if constexpr (F32) {
#pragma unroll
      for (int s = 0; s < DHP / 16; ++s) {
        uint32_t qh[MT][2][4], ql[MT][2][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float x = __uint_as_float(qf[mt][2 * s + jj][e]);
              const float hi = tf32_hi(x);
              qh[mt][jj][e] = __float_as_uint(hi);
              ql[mt][jj][e] = tf32(x - hi);
            }
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const float4 kv = *reinterpret_cast<const float4*>(
              ks + (8 * j + g) * S::SK + 16 * s + 4 * t);
          const float kx[4] = {kv.x, kv.y, kv.z, kv.w};
          uint32_t kh[4], kl[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float hi = tf32_hi(kx[e]);
            kh[e] = __float_as_uint(hi);
            kl[e] = tf32(kx[e] - hi);
          }
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma_tf32(sc[mt][j], ql[mt][jj], kh[2 * jj], kh[2 * jj + 1]);
              mma_tf32(sc[mt][j], qh[mt][jj], kl[2 * jj], kl[2 * jj + 1]);
              mma_tf32(sc[mt][j], qh[mt][jj], kh[2 * jj], kh[2 * jj + 1]);
            }
        }
      }
    } else {
#pragma unroll
      for (int s = 0; s < DHP / 16; ++s) {
        uint32_t kb[NB][4];
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const float4 kv = *reinterpret_cast<const float4*>(
              ks + (8 * j + g) * S::SK + 16 * s + 4 * t);
          kb[j][0] = tf32(kv.x);
          kb[j][1] = tf32(kv.y);
          kb[j][2] = tf32(kv.z);
          kb[j][3] = tf32(kv.w);
        }
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int j = 0; j < NB; ++j)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              mma_tf32(sc[mt][j], qf[mt][2 * s + jj], kb[j][2 * jj],
                       kb[j][2 * jj + 1]);
      }
    }

    // scores in the log2 domain: the thread holds keys 8 j + 2 t and + 1
    // of rows g and g + 8
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const float4 m = *reinterpret_cast<const float4*>(kmap + 8 * j + 2 * t);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        sc[mt][j][0] = fmaf(sc[mt][j][0], m.x, m.y);
        sc[mt][j][1] = fmaf(sc[mt][j][1], m.z, m.w);
        sc[mt][j][2] = fmaf(sc[mt][j][2], m.x, m.y);
        sc[mt][j][3] = fmaf(sc[mt][j][3], m.z, m.w);
      }
    }

    // the online softmax: the tile's row maxima over the quad; the running
    // maxima move (and the accumulators are rescaled) when a row of the
    // warp grows by more than LAZY_L2, so P stays below 2^LAZY_L2
    float mx[MT][2];
    bool grow = false;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float x = -INFINITY;
#pragma unroll
        for (int j = 0; j < NB; ++j)
          x = fmaxf(x, fmaxf(sc[mt][j][2 * half], sc[mt][j][2 * half + 1]));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        mx[mt][half] = x;  // finite: a key of the tile is < nk
        grow = grow || mx[mt][half] > mrow[mt][half] + LAZY_L2;
      }
    if (__any_sync(0xffffffffu, grow)) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float mnew = fmaxf(mrow[mt][half], mx[mt][half]);
          const float alpha = exp2_(mrow[mt][half] - mnew);
          mrow[mt][half] = mnew;
          lrow[mt][half] *= alpha;
#pragma unroll
          for (int n = 0; n < KS; ++n) {
            acc[mt][n][2 * half] *= alpha;
            acc[mt][n][2 * half + 1] *= alpha;
          }
        }
    }
    // P = 2^(s - m) in TF32, and o += P v, one 8-key block at a time:
    // k-step j takes keys 8 j + 2 t (k index t) and 8 j + 2 t + 1 (k index
    // t + 4), straight from S's accumulators. In F32 each block's three
    // products start from zero and join o by float32 adds, and the tile's
    // row sums join l so: the tensor cores' accumulation truncates, and one
    // chain over all keys read 7-65 times the plain form's float32 error
    [[maybe_unused]] float ls[MT][2];
    if constexpr (F32) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) ls[mt][0] = ls[mt][1] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      // P in TF32 (its hi part in F32), and P's lo part in F32
      uint32_t a[MT][4];
      [[maybe_unused]] uint32_t al[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float pe[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pe[e] = exp2_(sc[mt][j][e] - mrow[mt][e >> 1]);
        if constexpr (F32) {
          ls[mt][0] += pe[0] + pe[1];
          ls[mt][1] += pe[2] + pe[3];
        } else {
          lrow[mt][0] += pe[0] + pe[1];
          lrow[mt][1] += pe[2] + pe[3];
        }
        constexpr int order[4] = {0, 2, 1, 3};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = pe[order[e]];
          if constexpr (F32) {
            const float hi = tf32_hi(x);
            a[mt][e] = __float_as_uint(hi);
            al[mt][e] = tf32(x - hi);
          } else {
            a[mt][e] = tf32(x);
          }
        }
      }
      const float* v0 = vs + (8 * j + 2 * t) * S::SV + g;
#pragma unroll
      for (int n = 0; n < KS; ++n) {
        const float x0 = v0[8 * n], x1 = v0[S::SV + 8 * n];
        if constexpr (F32) {
          const float h0 = tf32_hi(x0), h1 = tf32_hi(x1);
          const uint32_t b0 = __float_as_uint(h0), b1 = __float_as_uint(h1);
          const uint32_t l0 = tf32(x0 - h0), l1 = tf32(x1 - h1);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            float c[4] = {0.f, 0.f, 0.f, 0.f};
            mma_tf32(c, al[mt], b0, b1);
            mma_tf32(c, a[mt], l0, l1);
            mma_tf32(c, a[mt], b0, b1);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][n][e] += c[e];
          }
        } else {
          const uint32_t b0 = tf32(x0), b1 = tf32(x1);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_tf32(acc[mt][n], a[mt], b0, b1);
        }
      }
    }
    if constexpr (F32) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        lrow[mt][0] += ls[mt][0];
        lrow[mt][1] += ls[mt][1];
      }
    }
    __syncthreads();
  }

  // the row sums over the quad, then o = acc / l
  float* O = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float l = lrow[mt][half];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.f / l;
      const int row = row0 + mt * 16 + g + 8 * half;
      if (row >= p.nq) continue;
#pragma unroll
      for (int n = 0; n < KS; ++n) {
        const int d = 8 * n + 2 * t;
        if (8 * n < p.dh)
          *reinterpret_cast<float2*>(O + row * p.o_sn + d) = make_float2(
              acc[mt][n][2 * half] * inv, acc[mt][n][2 * half + 1] * inv);
      }
    }
  }
}

template <int DHP, int MT, bool F32>
cudaError_t launch(const Params& p, int B, int H, cudaStream_t stream) {
  using S = Shape<DHP, MT>;
  auto kern = masked_attention_kernel<DHP, MT, F32>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.nq + S::BM - 1) / S::BM, H, B);
  kern<<<grid, NT, S::SMEM, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q (B, Nq, H, dh), k and v (B, Nk, H, dh) float32 with dh contiguous,
// every stride (in floats) a multiple of 4 and every pointer on 16 bytes;
// mask (B, Nk) one byte a key, contiguous; o (B, Nq, H, dh) with the same
// rules. dh a multiple of 8 up to 128, Nk >= 1. `full_f32` nonzero
// computes the products in full float32 (3xTF32), else TF32. One launch on
// `stream`; returns its CUDA error (0 on success).
extern "C" int masked_attention_launch(
    const float* q, const float* k, const float* v, const uint8_t* mask,
    float* o, long long q_sb, long long q_sn, long long q_sh, long long k_sb,
    long long k_sn, long long k_sh, long long v_sb, long long v_sn,
    long long v_sh, long long o_sb, long long o_sn, long long o_sh, int B,
    int H, int Nq, int Nk, int dh, float scale, int full_f32,
    cudaStream_t stream) {
  if (B < 0 || H < 0 || Nq < 0 || Nk < 1 || dh < 8 || dh > 128 || dh % 8)
    return (int)cudaErrorInvalidValue;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  const long long strides[12] = {q_sb, q_sn, q_sh, k_sb, k_sn, k_sh,
                                 v_sb, v_sn, v_sh, o_sb, o_sn, o_sh};
  for (int i = 0; i < 12; ++i)
    if (strides[i] % 4) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || Nq == 0) return 0;
  const Params p{q,    k,    v,    mask, o,  q_sb, q_sn, q_sh,
                 k_sb, k_sn, k_sh, v_sb, v_sn, v_sh, o_sb, o_sn,
                 o_sh, Nq,   Nk,   dh,   scale * LOG2E};
  cudaError_t e;
  if (full_f32)
    e = dh <= 32   ? launch<32, 1, true>(p, B, H, stream)
        : dh <= 64 ? launch<64, 1, true>(p, B, H, stream)
                   : launch<128, 1, true>(p, B, H, stream);
  else
    e = dh <= 32   ? launch<32, 2, false>(p, B, H, stream)
        : dh <= 64 ? launch<64, 2, false>(p, B, H, stream)
                   : launch<128, 1, false>(p, B, H, stream);
  return (int)e;
}
