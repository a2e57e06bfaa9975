// K3 (SVGF a-trous chain) and K4 (separable bilateral blur), edge-clamped
// taps.
//
// K3 replaces _make_step_kernel / _atrous_step of hybrid_rendering_tpu/
// ops/pallas/stencil.py (pallas_call at stencil.py:162, entry atrous_chain
// :190); K4 replaces _make_blur_kernel / bilateral_blur (pallas_call at
// stencil.py:337, called from models/ao.py:136).
//
// The TPU kernels DMA edge-padded row bands plus a halo into VMEM and take
// every tap as a static vector slice, one pallas_call per iteration.
//
// K3 on the H100. Its bound is bytes (37 B/pixel for a chain of any
// length), but a tap costs far more instructions than bytes: nine taps a
// pixel and iteration, each with a normal dot, three edge-stopping
// weights and C + 2 accumulations (~300 instructions a pixel and
// iteration, which the taps run at about the card's instruction rate). A block
// first loads its tile, then runs the taps, then writes, and the three do
// not overlap much across the few waves of blocks a launch has: measured,
// an iteration at 1080p divides about evenly between the load and the
// taps, so it is bound by instruction rate and by the latency of its load, at
// about a tenth of the bytes bound. The design spends as little of either
// as it can:
//   - one exponential a tap: w = k * n^phi_n * exp(-|dz|/phi_z) *
//     exp(-|dl|/phi_l) = k * n^phi_n * exp2(-|dz|*rz - |dl|*rl) with rz =
//     log2(e)/phi_z a launch constant and rl = log2(e)/phi_l once a pixel;
//     n^32 (every preset) is five squarings, any other power phi_n *
//     log2(n) (and log2 k) inside the same exponential; ex2.approx /
//     lg2.approx and FMA contraction (this file is built with -fmad=true).
//     So K3 agrees with the plain version to a tolerance, not bit for bit:
//     ~1e-6 as a rule, up to 4e-5 where the variance is 0 and the luma
//     weight is at its steepest. Measured, the plain version's own
//     arithmetic (powf, two expf, divisions, no contraction) in this same
//     tiling agrees to 3e-7 and takes 2.6 times as long;
//   - a block loads its tile plus halo once into shared memory: normal and
//     depth packed as one float4 (one 16-byte, conflict-free read a tap),
//     colour as a float (C=1) or float4 (r, g, b, luma: the luma of a
//     pixel is formed once, not once per use), variance as its own plane
//     (the 3x3 variance box reads it without bank conflicts), the mask as
//     bytes;
//   - consecutive iterations fuse into one launch: normal, depth and mask
//     (17 of the 25 input bytes) do not change along the chain, so a launch of n
//     iterations loads a halo of the sum of their reaches, runs iteration
//     k on the tile plus the halo the later iterations still need
//     (ping-pong colour/variance buffers in shared memory, a block barrier
//     between iterations) and writes only the tile. Which iterations fuse
//     and the tile size are the wrapper's choice (ops/stencil.py _plan):
//     measured, fusing steps 1 and 2 pays a little and any larger halo
//     loses to its recomputation;
//   - taps clamp in image coordinates and then index the tile, so a block
//     edge reproduces filters.shift2d's image-edge clamp exactly; positions
//     outside the image are neither loaded nor computed.
//
// K4 on the H100. Its bound is bytes (21 B in and 4 B out a pixel), but a
// tap's weight costs a powf (normal^32: ~70 instructions), an expf and an
// IEEE division, all kept for bit parity with ops/filters.py
// bilateral_blur_separable, so it is bound by instruction issue. The parent
// ran two launches (vertical into a full-size plane, then horizontal) and
// evaluated 18 weights a pixel. One launch now, one block a tile:
//   - a warp's 32 lanes span the tile's columns plus an R-pixel halo on
//     each side (a tile is 32 - 2R wide and BLUR_TILE_H high), so a lane
//     indexes a column of every shared-memory plane and no thread divides;
//     the tile plus its halo (image, normal and depth; clamped to the
//     image) is loaded once;
//   - the vertical pass runs on the tile's rows at all 32 columns into
//     shared memory, the horizontal pass reads it there and applies the
//     mask: no intermediate plane in device memory;
//   - a weight depends on its pair of pixels only: n_p . n_q sums the same
//     three products as n_q . n_p, and |z_p - z_q| = |z_q - z_p|, bit for
//     bit. So (wn, wz) of each unordered pair at distance 1..R along an
//     axis is computed once (a job list in shared memory: a warp a row of
//     pairs) and read from both ends: ~13 evaluations a pixel at R = 4;
//     a pixel's pair with itself is evaluated too (it is not 1 where a
//     depth is infinite);
//   - weights exact by IEEE 754's rules skip their transcendental: pow(1,
//     y) = 1, pow(+-0, y > 0), exp(-0) = 1, x / 1 = x (axis-aligned normals
//     and the sky's equal depths make those common); the exponent 32 of
//     every preset is a constant of the code;
//   - taps clamp in image coordinates and then index the tile (as K3), so
//     block edges reproduce filters.shift2d exactly;
//   - a tile without a masked-in pixel copies its input and stops;
//   - rounding: each tap is (g_i * wn) * wz, sum_c and sum_w add the taps
//     left to right, and the final division is IEEE, every multiply and
//     add written unfused (this file compiles with -fmad=true), so the
//     kernel rounds like the plain version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

constexpr int MAX_BLUR_RADIUS = 8;  // ops/kernels.py MAX_BLUR_RADIUS
constexpr int MAX_FUSED = 4;        // ops/kernels.py MAX_FUSED

// Bilateral-blur Gaussian taps, passed by value (ops/kernels.py GaussTaps)
struct GaussTaps {
  float w[2 * MAX_BLUR_RADIUS + 1];
};

namespace {

constexpr int K3_MAX_THREADS = 512;
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may ask for
constexpr float LOG2E = 1.4426950408889634f;

// B3 spline taps, products formed in double and rounded once, as the JAX
// package forms the python-float product before it meets a float32 array
__device__ __forceinline__ float atrous_k(int ady, int adx) {
  const double K[3] = {1.0, 2.0 / 3.0, 1.0 / 6.0};
  return (float)(K[ady] * K[adx]);
}

// log2 of the same taps, for the weight that is all one exponential
__device__ __forceinline__ float atrous_log2k(int ady, int adx) {
  const double L[3] = {0.0, -0.58496250072115619, -2.5849625007211561};
  return (float)(L[ady] + L[adx]);
}

__device__ __forceinline__ int clampi(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float lg2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Luma rounded as the plain version rounds it (no contraction): where the
// variance is 0 the luma weight turns an ulp of luma into 1e-4 of a tap
__device__ __forceinline__ float luma3(float r, float g, float b) {
  return fmaxf(__fadd_rn(__fadd_rn(__fmul_rn(r, 0.299f), __fmul_rn(g, 0.587f)),
                         __fmul_rn(b, 0.114f)), 1e-4f);
}

// One launch of the chain: n_iter fused iterations on tiles of tile_w x
// tile_h pixels. reach of iteration k = max(radius * step[k], 1) (its taps
// and the 3x3 variance box); halo = the sum of all reaches; after[k] = the
// sum of the reaches of the iterations after k.
struct AtrousLaunch {
  const float* color;
  const float* variance;
  const float* normal;
  const float* depth;
  const uint8_t* mask;
  float* out_color;
  float* out_var;
  float* out_feedback;  // colour after iteration feedback_at, or null
  int H, W, tile_w, tile_h, n_iter, feedback_at, halo;
  int step[MAX_FUSED];
  int after[MAX_FUSED];
  float rz[MAX_FUSED];  // log2(e) / depth_phi of each iteration
  float phi_color, phi_normal;
  bool squarings;  // phi_normal is 32: n^32 by five squarings
};

// Colour of a pixel in shared memory: the value (C=1) or r, g, b, luma
template <int C>
struct Color {
  typedef float4 type;
  static __device__ __forceinline__ float luma(float4 c) { return c.w; }
};
template <>
struct Color<1> {
  typedef float type;
  static __device__ __forceinline__ float luma(float c) { return c; }
};

// floor(idx / w) for 0 <= idx < 2^20, w <= 2^10, inv_w = 1 / w
__device__ __forceinline__ int row_of(int idx, float inv_w) {
  return (int)(((float)idx + 0.5f) * inv_w);
}

// One iteration at one masked-in pixel (x, y), shared-memory index s:
// filters.atrous_iteration with the folded weights. G, A, VA index the
// loaded region, whose origin is (rx0, ry0) and pitch RW.
template <int C, int R>
__device__ __forceinline__ void atrous_pixel(
    const float4* __restrict__ G, const typename Color<C>::type* __restrict__ A,
    const float* __restrict__ VA, int s, int x, int y, int rx0, int ry0, int RW, int H,
    int W, int step, float rz, float phi_color, float phi_normal, bool squarings,
    typename Color<C>::type* out_c, float* out_v) {
  // 3x3 variance box sum, rows then columns (filters.box_filter_sum)
  const int xm = x > 0 ? -1 : 0, xp = x < W - 1 ? 1 : 0;
  const int ym = y > 0 ? -RW : 0, yp = y < H - 1 ? RW : 0;
  const float c0 = (VA[s] + VA[s + ym]) + VA[s + yp];
  const float c1 = (VA[s + xm] + VA[s + xm + ym]) + VA[s + xm + yp];
  const float c2 = (VA[s + xp] + VA[s + xp + ym]) + VA[s + xp + yp];
  const float vb = (c0 + c1) + c2;
  const float phi_l = fmaxf(phi_color * sqrtf(fmaxf(vb / 9.0f, 1e-10f)), 1e-6f);
  const float rl = LOG2E / phi_l;

  const float4 g0 = G[s];
  const float l0 = Color<C>::luma(A[s]);
  float sum_r = 0.0f, sum_g = 0.0f, sum_b = 0.0f, sum_v = 0.0f, sum_w = 0.0f;
#pragma unroll
  for (int dy = -R; dy <= R; ++dy) {
    // shift2d(img, dy*step, dx*step) reads img[y - dy*step, x - dx*step]
    const int row = (clampi(y - dy * step, H - 1) - ry0) * RW - rx0;
#pragma unroll
    for (int dx = -R; dx <= R; ++dx) {
      const int q = row + clampi(x - dx * step, W - 1);
      const float4 g = G[q];
      const typename Color<C>::type cq = A[q];
      const float nd = __saturatef(g0.x * g.x + g0.y * g.y + g0.z * g.z);
      const int ady = dy < 0 ? -dy : dy, adx = dx < 0 ? -dx : dx;
      float e = -fabsf(g0.w - g.w) * rz - fabsf(l0 - Color<C>::luma(cq)) * rl;
      float w;
      if (squarings) {  // n^32
        float n2 = nd * nd;
        n2 *= n2;
        n2 *= n2;
        n2 *= n2;
        w = atrous_k(ady, adx) * (n2 * n2) * ex2_approx(e);
      } else {  // k and n^phi inside the exponential; lg2(0) = -inf gives w = 0
        e += atrous_log2k(ady, adx);
        if (phi_normal != 0.0f) e += phi_normal * lg2_approx(nd);
        w = ex2_approx(e);
      }
      if constexpr (C == 1) {
        sum_r += cq * w;
      } else {
        sum_r += cq.x * w;
        sum_g += cq.y * w;
        sum_b += cq.z * w;
      }
      sum_v += VA[q] * w * w;
      sum_w += w;
    }
  }
  const float inv = 1.0f / fmaxf(sum_w, 1e-8f);
  *out_v = sum_v / fmaxf(sum_w * sum_w, 1e-8f);
  if constexpr (C == 1) {
    *out_c = sum_r * inv;
  } else {
    const float r = sum_r * inv, g = sum_g * inv, b = sum_b * inv;
    *out_c = make_float4(r, g, b, luma3(r, g, b));
  }
}

template <int C, int R>
__global__ void __launch_bounds__(K3_MAX_THREADS) atrous_tile_kernel(const AtrousLaunch a) {
  typedef typename Color<C>::type CT;
  extern __shared__ float4 smem[];
  const int H = a.H, W = a.W;
  const int RW = a.tile_w + 2 * a.halo, RH = a.tile_h + 2 * a.halo, NP = RW * RH;
  const int NB = a.n_iter > 1 ? NP : 0;  // a single iteration needs no second buffer
  float4* G = smem;               // normal.xyz, depth
  CT* A = (CT*)(G + NP);          // colour in, and out of every second iteration
  CT* B = A + NB;
  float* VA = (float*)(B + NP);   // variance, likewise
  float* VB = VA + NB;
  uint8_t* M = (uint8_t*)(VB + NP);
  const int bx0 = blockIdx.x * a.tile_w, by0 = blockIdx.y * a.tile_h;
  const int rx0 = bx0 - a.halo, ry0 = by0 - a.halo;
  const int tid = threadIdx.x, nt = blockDim.x;

  {  // load the part of the region that lies in the image
    const int x0 = max(rx0, 0), x1 = min(rx0 + RW, W);
    const int y0 = max(ry0, 0), y1 = min(ry0 + RH, H);
    const int w = x1 - x0, n = w * (y1 - y0);
    const float inv_w = 1.0f / (float)w;
    for (int idx = tid; idx < n; idx += nt) {
      const int j = row_of(idx, inv_w);
      const int x = x0 + idx - j * w, y = y0 + j;
      const int p = y * W + x, s = (y - ry0) * RW + (x - rx0);
      G[s] = make_float4(__ldg(a.normal + 3 * p), __ldg(a.normal + 3 * p + 1),
                         __ldg(a.normal + 3 * p + 2), __ldg(a.depth + p));
      if constexpr (C == 1) {
        A[s] = __ldg(a.color + p);
      } else {
        const float r = __ldg(a.color + 3 * p), g = __ldg(a.color + 3 * p + 1),
                    b = __ldg(a.color + 3 * p + 2);
        A[s] = make_float4(r, g, b, luma3(r, g, b));
      }
      VA[s] = __ldg(a.variance + p);
      M[s] = a.mask[p];
    }
  }
  __syncthreads();

#pragma unroll
  for (int k = 0; k < MAX_FUSED; ++k) {
    if (k >= a.n_iter) break;
    const bool last = k == a.n_iter - 1;
    // this iteration's pixels: the tile plus what later iterations reach
    const int e = a.after[k];
    const int x0 = max(bx0 - e, 0), x1 = min(bx0 + a.tile_w + e, W);
    const int y0 = max(by0 - e, 0), y1 = min(by0 + a.tile_h + e, H);
    const int w = x1 - x0, n = w * (y1 - y0);
    const float inv_w = 1.0f / (float)w;
    for (int idx = tid; idx < n; idx += nt) {
      const int j = row_of(idx, inv_w);
      const int x = x0 + idx - j * w, y = y0 + j;
      const int s = (y - ry0) * RW + (x - rx0);
      CT oc = A[s];  // masked pixels pass through untouched
      float ov = VA[s];
      if (M[s]) {
        atrous_pixel<C, R>(G, A, VA, s, x, y, rx0, ry0, RW, H, W, a.step[k], a.rz[k],
                           a.phi_color, a.phi_normal, a.squarings, &oc, &ov);
      }
      const int p = y * W + x;
      const bool in_tile = x >= bx0 && x < bx0 + a.tile_w && y >= by0 && y < by0 + a.tile_h;
      float* dst = last ? a.out_color : (k == a.feedback_at && in_tile ? a.out_feedback : nullptr);
      if (dst != nullptr) {
        if constexpr (C == 1) {
          dst[p] = oc;
        } else {
          dst[3 * p] = oc.x;
          dst[3 * p + 1] = oc.y;
          dst[3 * p + 2] = oc.z;
        }
      }
      if (last) {
        a.out_var[p] = ov;
      } else {
        B[s] = oc;
        VB[s] = ov;
      }
    }
    if (last) break;
    __syncthreads();
    CT* tc = A;
    A = B;
    B = tc;
    float* tv = VA;
    VA = VB;
    VB = tv;
  }
}

template <int C, int R>
int launch_atrous(const AtrousLaunch& a, int threads, size_t smem_bytes, cudaStream_t s) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        atrous_tile_kernel<C, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((a.W + a.tile_w - 1) / a.tile_w, (a.H + a.tile_h - 1) / a.tile_h);
  atrous_tile_kernel<C, R><<<grid, threads, smem_bytes, s>>>(a);
  return (int)cudaGetLastError();
}

template <int C>
int launch_atrous_radius(int radius, const AtrousLaunch& a, int threads, size_t smem_bytes,
                         cudaStream_t s) {
  switch (radius) {
    case 0: return launch_atrous<C, 0>(a, threads, smem_bytes, s);
    case 1: return launch_atrous<C, 1>(a, threads, smem_bytes, s);
    case 2: return launch_atrous<C, 2>(a, threads, smem_bytes, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Edge-stopping weights of a pair of pixels (a, b), each a float4 of
// normal.xyz and depth: (clamp(n_a . n_b)^power, exp(-|z_a - z_b| / phi)),
// rounded as filters.normal_weight / depth_weight round them. Where the
// answer is exact by IEEE 754's rules the transcendental is skipped: pow(1,
// y) = 1; pow(+-0, y > 0) = +0, or the zero itself where y is an odd
// integer; exp(-0 / phi) = 1 for phi > 0 (the wrapper clamps phi to
// 1e-6); and x / 1 = x. Axis-aligned normals and the sky make those
// common.
__device__ __forceinline__ float2 blur_pair(float4 a, float4 b, float phi, float power,
                                            bool odd_power) {
  const float nd = __fadd_rn(__fadd_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)),
                             __fmul_rn(a.z, b.z));
  const float c = fminf(fmaxf(nd, 0.0f), 1.0f);
  const float wn = c == 1.0f ? 1.0f
                   : (c == 0.0f && power > 0.0f) ? (odd_power ? c : 0.0f)
                                                 : powf(c, power);
  const float dz = fabsf(a.w - b.w);
  // x / 1 = x: the division is skipped at phi = 1 (the AO pass's)
  return make_float2(wn, dz == 0.0f ? 1.0f : expf(phi == 1.0f ? -dz : -dz / phi));
}

// K4's tiles: a warp's 32 lanes span the tile's columns plus an R-pixel
// halo on each side, so a tile is 32 - 2R pixels wide, and a lane indexes
// a column of every shared-memory plane with no division. BLUR_TILE_H
// rows a tile and BLUR_THREADS threads a block: the fastest of the plans
// timed at the AO site on an H100 (PERF.md)
constexpr int BLUR_TILE_H = 8;
constexpr int BLUR_THREADS = 256;
static_assert(BLUR_TILE_H + 2 * MAX_BLUR_RADIUS <= 255, "a K4 job packs its row in 8 bits");
template <int R>
struct BlurTile {
  static constexpr int RW = 32;           // loaded columns
  static constexpr int TW = RW - 2 * R;   // output columns
};

// Shared-memory layout of one K4 block (TH = BLUR_TILE_H output rows,
// radius R): the region of the tile plus an R halo, 32 x (TH + 2R), as G
// (normal, depth) and I (image); the pair weights along y (R x (TH + R) x
// 32, the pair's upper end's row indexes them), along x (R x TH x 32), of
// each pixel with itself (TH x 32); the vertical pass (TH x 32); the
// block's job list (one int a job).
template <int R>
struct BlurSmem {
  static constexpr int TH = BLUR_TILE_H, RH = TH + 2 * R, nG = 32 * RH,
                       nPV = R * (TH + R) * 32, nPH = R * TH * 32, nS = TH * 32,
                       jobs = R * TH + R * (R + 1) / 2 + R * TH + TH;
  static constexpr size_t bytes =
      (size_t)nG * 20 + (size_t)(nPV + nPH + nS) * 8 + (size_t)nS * 4 + (size_t)jobs * 4;
};

struct BlurLaunch {
  const float* img;
  const float* normal;
  const float* depth;
  const uint8_t* mask;
  float* out;
  int H, W;
  float depth_phi, normal_power;
  bool odd_power;  // normal_power is an odd integer
  GaussTaps g;
};

// A job of the pair phase: kind (0: along y, 1: along x, 2: a pixel with
// itself), distance d and row, packed; a warp runs a job at its 32 columns
enum { JOB_V = 0, JOB_H = 1, JOB_S = 2 };
__device__ __forceinline__ int blur_job(int kind, int d, int row) {
  return (kind << 16) | (d << 8) | row;
}

// P32: normal_power is 32 (every preset), and powf's exponent is a
// constant of the code
template <int R, bool P32>
__global__ void __launch_bounds__(BLUR_THREADS) blur_tile_kernel(const BlurLaunch a) {
  extern __shared__ float4 blur_smem[];
  constexpr int RW = BlurTile<R>::RW, TW = BlurTile<R>::TW;
  using L = BlurSmem<R>;
  constexpr int TH = L::TH, THr = TH + R, nw = BLUR_THREADS / 32;
  const int H = a.H, W = a.W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bx0 = blockIdx.x * TW, by0 = blockIdx.y * TH;
  const int tw = min(TW, W - bx0), th = min(TH, H - by0);  // the tile's pixels in the image
  const int rx0 = bx0 - R, ry0 = by0 - R;
  float4* G = blur_smem;
  float2* PV = (float2*)(G + L::nG);
  float2* PH = PV + L::nPV;
  float2* S = PH + L::nPH;
  float* I = (float*)(S + L::nS);
  float* V = I + L::nG;
  int* jobs = (int*)(V + L::nS);

  // a tile with no masked-in pixel keeps its input
  bool any = false;
  for (int ty = warp; ty < th; ty += nw)
    any |= lane < tw && a.mask[(by0 + ty) * W + bx0 + lane] != 0;
  if (!__syncthreads_or(any)) {
    for (int ty = warp; ty < th; ty += nw) {
      if (lane < tw) {
        const int p = (by0 + ty) * W + bx0 + lane;
        a.out[p] = __ldg(a.img + p);
      }
    }
    return;
  }

  // the part of the region that lies in the image; lane = column
  const int x = rx0 + lane;
  const int cx0 = max(rx0, 0), cx1 = min(bx0 + tw + R, W);
  const bool col_in = x >= cx0 && x < cx1;
  const int cy0 = max(ry0, 0), cy1 = min(by0 + th + R, H);
  for (int y = cy0 + warp; y < cy1; y += nw) {
    if (col_in) {
      const int p = y * W + x, s = (y - ry0) * RW + lane;
      G[s] = make_float4(__ldg(a.normal + 3 * p), __ldg(a.normal + 3 * p + 1),
                         __ldg(a.normal + 3 * p + 2), __ldg(a.depth + p));
      I[s] = __ldg(a.img + p);
    }
  }
  // the job list: pairs along y at distance d on rows [R - d, R + TH) of
  // the region (the lower end's), pairs along x on the tile's rows, each
  // pixel with itself on the tile's rows
  for (int t = threadIdx.x; t < L::jobs; t += BLUR_THREADS) {
    int j = t, job = 0;
    for (int d = 1; d <= R; ++d) {
      if (j >= 0 && j < TH + d) job = blur_job(JOB_V, d, R - d + j);
      j -= TH + d;
    }
    if (j >= 0 && j < R * TH) job = blur_job(JOB_H, j / TH + 1, j % TH);
    j -= R * TH;
    if (j >= 0) job = blur_job(JOB_S, 0, j);
    jobs[t] = job;
  }
  __syncthreads();

  // every pair weight the two passes read, once; a warp a job
  const float phi = a.depth_phi, pw = P32 ? 32.0f : a.normal_power;
  const bool odd = P32 ? false : a.odd_power;
  for (int t = warp; t < L::jobs; t += nw) {
    const int job = jobs[t];
    const int kind = job >> 16, d = (job >> 8) & 0xff, row = job & 0xff;
    if (kind == JOB_V) {  // (y, y + d), y = ry0 + row in [by0 - d, by0 + th)
      const int y = ry0 + row;
      if (col_in && y >= max(by0 - d, 0) && y < min(by0 + th, H - d)) {
        const int s = row * RW + lane;
        PV[((d - 1) * THr + row) * RW + lane] = blur_pair(G[s], G[s + d * RW], phi, pw, odd);
      }
    } else if (kind == JOB_H) {  // (x, x + d), x in [bx0 - d, bx0 + tw), tile row `row`
      if (row < th && x >= max(bx0 - d, 0) && x < min(bx0 + tw, W - d)) {
        const int s = (row + R) * RW + lane;
        PH[((d - 1) * TH + row) * RW + lane] = blur_pair(G[s], G[s + d], phi, pw, odd);
      }
    } else if (row < th && col_in) {
      const float4 q = G[(row + R) * RW + lane];
      S[row * RW + lane] = blur_pair(q, q, phi, pw, odd);
    }
  }
  __syncthreads();

  // vertical pass on the tile's rows, every loaded column; tap i reads
  // shift2d(img, o, 0) = img[clamp(y - o)], o = i - R
  for (int ty = warp; ty < th; ty += nw) {
    if (!col_in) continue;
    const int y = by0 + ty;
    float sum_c = 0.0f, sum_w = 0.0f;
#pragma unroll
    for (int i = 0; i <= 2 * R; ++i) {
      const int q = clampi(y - (i - R), H - 1);
      const float2 wp = q == y ? S[ty * RW + lane]
                        : q > y ? PV[((q - y - 1) * THr + (y - ry0)) * RW + lane]
                                : PV[((y - q - 1) * THr + (q - ry0)) * RW + lane];
      const float w = __fmul_rn(__fmul_rn(a.g.w[i], wp.x), wp.y);
      sum_c = __fadd_rn(sum_c, __fmul_rn(I[(q - ry0) * RW + lane], w));
      sum_w = __fadd_rn(sum_w, w);
    }
    V[ty * RW + lane] = sum_c / fmaxf(sum_w, 1e-8f);
  }
  __syncthreads();

  // horizontal pass on the tile, then the mask's passthrough; lane = the
  // output column
  for (int ty = warp; ty < th; ty += nw) {
    if (lane >= tw) continue;
    const int xo = bx0 + lane, c = lane + R;  // c = xo - rx0
    const int p = (by0 + ty) * W + xo;
    float res = I[(ty + R) * RW + c];
    if (a.mask[p]) {
      float sum_c = 0.0f, sum_w = 0.0f;
#pragma unroll
      for (int i = 0; i <= 2 * R; ++i) {
        const int q = clampi(xo - (i - R), W - 1);
        const float2 wp = q == xo ? S[ty * RW + c]
                          : q > xo ? PH[((q - xo - 1) * TH + ty) * RW + c]
                                   : PH[((xo - q - 1) * TH + ty) * RW + (q - rx0)];
        const float w = __fmul_rn(__fmul_rn(a.g.w[i], wp.x), wp.y);
        sum_c = __fadd_rn(sum_c, __fmul_rn(V[ty * RW + (q - rx0)], w));
        sum_w = __fadd_rn(sum_w, w);
      }
      res = sum_c / fmaxf(sum_w, 1e-8f);
    }
    a.out[p] = res;
  }
}

template <int R, bool P32>
int launch_blur(const BlurLaunch& a, cudaStream_t s) {
  constexpr size_t smem = BlurSmem<R>::bytes;
  static_assert(smem <= (size_t)SMEM_LIMIT, "K4's tile exceeds a block's shared memory");
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        blur_tile_kernel<R, P32>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((a.W + BlurTile<R>::TW - 1) / BlurTile<R>::TW,
                  (a.H + BLUR_TILE_H - 1) / BLUR_TILE_H);
  blur_tile_kernel<R, P32><<<grid, BLUR_THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <int R>
int launch_blur_p(const BlurLaunch& a, cudaStream_t s) {
  return a.normal_power == 32.0f ? launch_blur<R, true>(a, s) : launch_blur<R, false>(a, s);
}

}  // namespace

// n_iter consecutive iterations of the chain in one launch. steps and
// depth_phi are host arrays of n_iter entries; feedback_at is the index of
// the iteration (not the last) whose colour also goes to out_feedback, or
// -1. Returns cudaErrorInvalidValue where the tile plus halo does not fit
// into a block's shared memory.
extern "C" int hr_atrous_fused(int channels, const float* color, const float* variance,
                               const float* normal, const float* depth,
                               const uint8_t* mask, int H, int W, int radius, int n_iter,
                               const int* steps, const float* depth_phi,
                               float phi_color, float phi_normal, int feedback_at,
                               int tile_w, int tile_h, int threads, float* out_color,
                               float* out_var, float* out_feedback, void* stream) {
  if (n_iter < 1 || n_iter > MAX_FUSED || tile_w < 1 || tile_h < 1 || threads < 32 ||
      threads > K3_MAX_THREADS || threads % 32 != 0 || feedback_at >= n_iter - 1 ||
      (feedback_at >= 0 && out_feedback == nullptr))
    return (int)cudaErrorInvalidValue;
  AtrousLaunch a;
  a.color = color;
  a.variance = variance;
  a.normal = normal;
  a.depth = depth;
  a.mask = mask;
  a.out_color = out_color;
  a.out_var = out_var;
  a.out_feedback = out_feedback;
  a.H = H;
  a.W = W;
  a.tile_w = tile_w;
  a.tile_h = tile_h;
  a.n_iter = n_iter;
  a.feedback_at = feedback_at;
  a.phi_color = phi_color;
  a.phi_normal = phi_normal;
  a.squarings = phi_normal == 32.0f;
  int reach[MAX_FUSED];
  a.halo = 0;
  for (int k = 0; k < MAX_FUSED; ++k) {
    a.step[k] = k < n_iter ? steps[k] : 0;
    a.rz[k] = k < n_iter ? LOG2E / depth_phi[k] : 0.0f;
    reach[k] = k < n_iter ? (radius * a.step[k] > 1 ? radius * a.step[k] : 1) : 0;
    if (a.step[k] < 0) return (int)cudaErrorInvalidValue;
    a.halo += reach[k];
  }
  for (int k = 0, left = a.halo; k < MAX_FUSED; ++k) {
    left -= reach[k];
    a.after[k] = left;
  }
  const size_t pixels = (size_t)(tile_w + 2 * a.halo) * (size_t)(tile_h + 2 * a.halo);
  const size_t smem_bytes =
      pixels * (16 + (n_iter > 1 ? 2 : 1) * ((channels == 1 ? 4 : 16) + 4) + 1);
  if (smem_bytes > (size_t)SMEM_LIMIT || pixels >= (1u << 20) ||
      tile_w + 2 * a.halo > 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (channels == 1) return launch_atrous_radius<1>(radius, a, threads, smem_bytes, s);
  if (channels == 3) return launch_atrous_radius<3>(radius, a, threads, smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}

// K4: the separable bilateral blur in one launch of tiles (32 - 2 * radius)
// x BLUR_TILE_H pixels, radius 1 to MAX_BLUR_RADIUS.
extern "C" int hr_bilateral_blur(const float* img, const float* normal,
                                 const float* depth, const uint8_t* mask, int H,
                                 int W, int radius, GaussTaps g, float depth_phi,
                                 float normal_power, float* out, void* stream) {
  if (radius < 1 || radius > MAX_BLUR_RADIUS) return (int)cudaErrorInvalidValue;
  if (H < 1 || W < 1) return (int)cudaGetLastError();
  BlurLaunch a;
  a.img = img;
  a.normal = normal;
  a.depth = depth;
  a.mask = mask;
  a.out = out;
  a.H = H;
  a.W = W;
  a.depth_phi = depth_phi;
  a.normal_power = normal_power;
  a.odd_power = floorf(normal_power) == normal_power && fmodf(normal_power, 2.0f) != 0.0f;
  a.g = g;
  cudaStream_t s = (cudaStream_t)stream;
  switch (radius) {
    case 1: return launch_blur_p<1>(a, s);
    case 2: return launch_blur_p<2>(a, s);
    case 3: return launch_blur_p<3>(a, s);
    case 4: return launch_blur_p<4>(a, s);
    case 5: return launch_blur_p<5>(a, s);
    case 6: return launch_blur_p<6>(a, s);
    case 7: return launch_blur_p<7>(a, s);
    default: return launch_blur_p<8>(a, s);
  }
}
