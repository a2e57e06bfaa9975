// K8: the temporal stage of the three SVGF denoisers, one launch a pass:
// models/shadows.py, models/ao.py and models/reflections.py
// temporal_accumulation_plain, which reproject the history along the
// motion vectors (ops/reprojection.py reproject) and blend it with the
// new samples.
//
// It replaces no TPU kernel: the JAX package leaves the temporal pass to
// XLA, which fuses it. Run eagerly, the plain version puts 191 (AO), 509
// (shadows) and 847 (reflections) kernels on the card a call: the 17x17
// box sums are 32 edge-clamped shifts each, every shift two index vectors
// and two gathers, and the separable warps add as many again. The stage
// needs 84 (AO) to 136 (reflections) bytes a pixel, each read or written
// once.
//
// One thread a pixel, in 32 x 8 tiles:
//   - the reprojection core (reproject_px) is shared by the three entry
//     points: the bilinear warp of the continuous planes (history,
//     moments, the previous normal) and the nearest warp of those and the
//     id planes (the previous position and mesh id), the +-MAX_RESIDUAL
//     window, the four disocclusion tests, the nearest-tap rescue and the
//     zeroing of invalid pixels. The warps keep ops/warp.py's separable
//     order: a row pass over the whole image, then a column pass over its
//     result. So the column tap at x' reads a row blend made with x''s
//     own displacement, not the pixel's: the thread evaluates each column
//     tap's reprojected y at that column (coords). A tap whose offset
//     lies outside the window is still read (at its clamped index) and
//     multiplied by its zero weight, as the plain gathers are;
//   - the 17x17 mean of the shadows and both moments of the reflections'
//     colour box are summed in the plain order, rows first (total +
//     img[y - o] + img[y + o] for o = 1..8, edge-clamped), then columns,
//     from a shared-memory tile with an 8-pixel halo loaded at clamped
//     image coordinates, so that a tile's edge reproduces shift2d's
//     image-edge clamp;
//   - the epilogues (the std clamp and the moments of the shadows, the
//     history cap of AO, the virtual-point coordinates, the camera-motion
//     cap read from the card and the colour AABB clip of the reflections)
//     are specialisations of one kernel template, selected by the entry.
//
// Rounding: built with -fmad=false and written in the plain version's
// operation order as PyTorch evaluates it on the card, so the two agree
// bit for bit: torch.sum over three terms adds (x + z) + y; a tensor
// divided by a Python number is multiplied by the float reciprocal;
// 1.0 / t is the reciprocal; clamp and minimum keep a NaN; the 4x4
// transform (an einsum, a cuBLAS GEMM) accumulates its four products in
// order with fused multiply-adds. A Python number is the float nearest to
// the double, so constants are written as (float)<double>.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE_X = 32;
constexpr int TILE_Y = 8;
constexpr int BLOCK = TILE_X * TILE_Y;
constexpr int R = 8;                    // the 17x17 box's radius
constexpr int SX = TILE_X + 2 * R;      // a tile and its halo: 48 x 24
constexpr int SY = TILE_Y + 2 * R;
constexpr int M = 6;                    // warp.MAX_RESIDUAL
constexpr float INV_BOX = 1.0f / 289.0f;  // / (17.0 * 17.0) on the card
constexpr float PLANE_DISTANCE = 5.0f;  // reprojection.PLANE_DISTANCE
constexpr float NORMAL_DISTANCE = (float)0.1;

constexpr int SHADOWS = 0;
constexpr int AO = 1;
constexpr int REFLECTIONS = 2;

struct V3 {
  float x, y, z;
};

struct Args {
  int H, W;
  // this frame's G-buffer: position, normal (H,W,3), mesh id (H,W),
  // motion (H,W,2); ray length and curvature (H,W) for the reflections
  const float* position;
  const float* normal;
  const int* mesh_id;
  const float* motion;
  const float* ray_length;
  const float* curvature;
  // the camera (reflections): position (3,), previous view-projection
  // (4,4), the frame-to-frame movement (1,)
  const float* cam_pos;
  const float* prev_vp;
  const float* camera_delta;
  // the previous G-buffer
  const float* prev_position;
  const float* prev_normal;
  const int* prev_mesh_id;
  // the history: colour (H,W,C), moments (H,W,2; not read by AO), length
  const float* history;
  const float* moments;
  const float* history_length;
  const float* raw;  // this frame's samples (H,W,C)
  float history_cap, alpha, moments_alpha, clamp_k, cap_moving;
  float* out;          // (H,W,C)
  float* out_variance;  // (H,W)
  float* out_moments;   // (H,W,2)
  float* out_length;    // (H,W)
};

__device__ __forceinline__ V3 load3(const float* __restrict__ a, int64_t i) {
  return V3{__ldg(a + 3 * i), __ldg(a + 3 * i + 1), __ldg(a + 3 * i + 2)};
}

// torch.sum(a * b, -1) on the card
__device__ __forceinline__ float dot(V3 a, V3 b) {
  const float x = a.x * b.x, y = a.y * b.y, z = a.z * b.z;
  return (x + z) + y;
}

__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}

// torch.clamp with tensor bounds
__device__ __forceinline__ float clamp3(float v, float lo, float hi) {
  if (isnan(v)) return v;
  if (isnan(lo)) return lo;
  if (isnan(hi)) return hi;
  return fminf(fmaxf(v, lo), hi);
}

// torch.minimum
__device__ __forceinline__ float minimum(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return fminf(a, b);
}

__device__ __forceinline__ int64_t clamp_index(int64_t i, int n) {
  return i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
}

// the float -> int64 cast of Tensor.to(torch.int64)
__device__ __forceinline__ int64_t to_i64(float v) { return (int64_t)v; }

// row i of the previous view-projection times (p, 1): cuBLAS's order
__device__ __forceinline__ float mat_row(const float* __restrict__ m, int i, V3 p) {
  const float* r = m + 4 * i;
  float acc = __ldg(r) * p.x;
  acc = fmaf(__ldg(r + 1), p.y, acc);
  acc = fmaf(__ldg(r + 2), p.z, acc);
  return fmaf(__ldg(r + 3), 1.0f, acc);
}

// The float pixel coordinates (hx, hy) in the previous frame of pixel
// (y, x): along the motion vector or, for a reflection with a hit on a
// flat surface (ray length > 0, curvature 0), of its virtual point
// (reprojection.virtual_point_coords: camera + direction * (|camera ray| +
// ray length), through the previous view-projection).
template <int SITE>
__device__ __forceinline__ void coords(const Args& a, int y, int x, float& hx, float& hy) {
  const int64_t i = (int64_t)y * a.W + x;
  if constexpr (SITE == REFLECTIONS) {
    const float rl = __ldg(a.ray_length + i);
    if (rl > 0.0f && __ldg(a.curvature + i) == 0.0f) {
      const V3 c = load3(a.cam_pos, 0), p = load3(a.position, i);
      const V3 ray{p.x - c.x, p.y - c.y, p.z - c.z};
      const float len = sqrtf(clamp_min(dot(ray, ray), (float)1e-12));
      const float s = len + rl;
      const V3 par{c.x + (ray.x / len) * s, c.y + (ray.y / len) * s, c.z + (ray.z / len) * s};
      const float c0 = mat_row(a.prev_vp, 0, par), c1 = mat_row(a.prev_vp, 1, par);
      const float w = mat_row(a.prev_vp, 3, par);
      const float aw = clamp_min(fabsf(w), (float)1e-8);
      const float sg = (float)((0.0f < w) - (w < 0.0f));  // torch.sign
      const float n0 = (c0 / aw) * sg, n1 = (c1 / aw) * sg;
      hx = (n0 * 0.5f + 0.5f) * (float)a.W - 0.5f;
      hy = ((1.0f - n1) * 0.5f) * (float)a.H - 0.5f;
      return;
    }
  }
  hx = (float)x + __ldg(a.motion + 2 * i) * (float)a.W;
  hy = (float)y + __ldg(a.motion + 2 * i + 1) * (float)a.H;
}

template <int SITE>
__device__ __forceinline__ float coord_y(const Args& a, int y, int x) {
  float hx, hy;
  coords<SITE>(a, y, x, hx, hy);
  return hy;
}

// The continuous planes of one pixel: colour, moments, previous normal.
template <int C>
struct Cont {
  float h[C];
  float m[2];
  V3 n;
};

// _axis_warp's row pass at column xc of row y: (1 - fy) * img[y + ky] +
// fy * img[y + ky + 1], each tap weighted 0 outside the window; (ky, fy)
// are column xc's own.
template <int SITE, int C>
__device__ __forceinline__ Cont<C> row_blend(const Args& a, int y, int64_t xc) {
  const float hy = coord_y<SITE>(a, y, (int)xc);
  const float fl = floorf(hy);
  const float f = hy - fl;
  const int64_t k = to_i64(fl - (float)y);
  const float w0 = (k >= -M && k <= M) ? 1.0f - f : 0.0f;
  const float w1 = (k >= -M - 1 && k <= M - 1) ? f : 0.0f;
  const int64_t i0 = clamp_index(y + k, a.H) * a.W + xc;
  const int64_t i1 = clamp_index(y + k + 1, a.H) * a.W + xc;
  Cont<C> v;
#pragma unroll
  for (int c = 0; c < C; ++c)
    v.h[c] = __ldg(a.history + C * i0 + c) * w0 + __ldg(a.history + C * i1 + c) * w1;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    if constexpr (SITE == AO) v.m[c] = 0.0f;  // no moments: reproject warps zeros
    else v.m[c] = __ldg(a.moments + 2 * i0 + c) * w0 + __ldg(a.moments + 2 * i1 + c) * w1;
  }
  const V3 n0 = load3(a.prev_normal, i0), n1 = load3(a.prev_normal, i1);
  v.n = V3{n0.x * w0 + n1.x * w1, n0.y * w0 + n1.y * w1, n0.z * w0 + n1.z * w1};
  return v;
}

// reprojection._disocclusion_valid
__device__ __forceinline__ bool disocclusion_valid(V3 cur_p, V3 cur_n, int cur_mesh, V3 prev_p,
                                                   V3 prev_n, int prev_mesh, bool in_frame) {
  const V3 d{cur_p.x - prev_p.x, cur_p.y - prev_p.y, cur_p.z - prev_p.z};
  const bool plane_ok = fabsf(dot(d, cur_n)) <= PLANE_DISTANCE;
  const float nd = fabsf(dot(cur_n, prev_n));
  return in_frame && cur_mesh == prev_mesh && plane_ok && nd * nd > NORMAL_DISTANCE;
}

template <int C>
struct Reprojected {
  float h[C];
  float m[2];
  float len;
  bool valid;
};

// reprojection.reproject at pixel (y, x), index i
template <int SITE, int C>
__device__ __forceinline__ Reprojected<C> reproject_px(const Args& a, int y, int x, int64_t i) {
  float hx, hy;
  coords<SITE>(a, y, x, hx, hy);
  const V3 cur_p = load3(a.position, i), cur_n = load3(a.normal, i);
  const int cur_mesh = __ldg(a.mesh_id + i);

  // bilinear: the column pass over two row blends
  const float flx = floorf(hx), fly = floorf(hy);
  const float fx = hx - flx;
  const int64_t kx = to_i64(flx - (float)x), ky = to_i64(fly - (float)y);
  const bool ok_b = kx >= -M && kx <= M - 1 && ky >= -M && ky <= M - 1 && hx >= 0.0f &&
                    hx <= (float)a.W - 1.0f && hy >= 0.0f && hy <= (float)a.H - 1.0f;
  const float wx0 = (kx >= -M && kx <= M) ? 1.0f - fx : 0.0f;
  const float wx1 = (kx >= -M - 1 && kx <= M - 1) ? fx : 0.0f;
  const Cont<C> v0 = row_blend<SITE, C>(a, y, clamp_index(x + kx, a.W));
  const Cont<C> v1 = row_blend<SITE, C>(a, y, clamp_index(x + kx + 1, a.W));
  Cont<C> bil;
#pragma unroll
  for (int c = 0; c < C; ++c) bil.h[c] = v0.h[c] * wx0 + v1.h[c] * wx1;
#pragma unroll
  for (int c = 0; c < 2; ++c) bil.m[c] = v0.m[c] * wx0 + v1.m[c] * wx1;
  bil.n = V3{v0.n.x * wx0 + v1.n.x * wx1, v0.n.y * wx0 + v1.n.y * wx1,
             v0.n.z * wx0 + v1.n.z * wx1};

  // nearest: the row tap of column xn, taken with xn's own row offset
  const float rx = rintf(hx), ry = rintf(hy);
  const int64_t nkx = to_i64(rx - (float)x), nky = to_i64(ry - (float)y);
  const bool ok_n = nkx >= -M && nkx <= M && nky >= -M && nky <= M && rx >= 0.0f &&
                    rx <= (float)(a.W - 1) && ry >= 0.0f && ry <= (float)(a.H - 1);
  const int64_t xn = clamp_index(x + nkx, a.W);
  const int64_t cky = to_i64(rintf(coord_y<SITE>(a, y, (int)xn)) - (float)y);
  const bool take = nkx >= -M && nkx <= M && cky >= -M && cky <= M;
  const int64_t j = clamp_index(y + cky, a.H) * a.W + xn;
  float near_h[C], near_m[2];
#pragma unroll
  for (int c = 0; c < C; ++c) near_h[c] = take ? __ldg(a.history + C * j + c) : 0.0f;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    if constexpr (SITE == AO) near_m[c] = 0.0f;
    else near_m[c] = take ? __ldg(a.moments + 2 * j + c) : 0.0f;
  }
  const float near_len = take ? __ldg(a.history_length + j) : 0.0f;
  const V3 zero{0.0f, 0.0f, 0.0f};
  const V3 near_n = take ? load3(a.prev_normal, j) : zero;
  const V3 prev_p = take ? load3(a.prev_position, j) : zero;
  const int prev_mesh = take ? (int)rintf((float)__ldg(a.prev_mesh_id + j)) : 0;

  const bool valid_b = disocclusion_valid(cur_p, cur_n, cur_mesh, prev_p, bil.n, prev_mesh, ok_b);
  const bool valid_n =
      disocclusion_valid(cur_p, cur_n, cur_mesh, prev_p, near_n, prev_mesh, ok_n);
  const bool use_near = !valid_b && valid_n;
  Reprojected<C> r;
  r.valid = valid_b || valid_n;
#pragma unroll
  for (int c = 0; c < C; ++c) r.h[c] = r.valid ? (use_near ? near_h[c] : bil.h[c]) : 0.0f;
#pragma unroll
  for (int c = 0; c < 2; ++c) r.m[c] = r.valid ? (use_near ? near_m[c] : bil.m[c]) : 0.0f;
  r.len = r.valid ? near_len : 0.0f;
  return r;
}

// filters.box_filter_sum(img, 8) of NP planes at every pixel of the tile:
// plane p < C is raw's channel p, plane C + p its square. Fills the tile
// (its halo at clamped image coordinates) and the row sums; sums[p] is the
// box sum at the thread's pixel.
template <int C, int NP>
__device__ __forceinline__ void box_sums(const Args& a, int y0, int x0, float* sums) {
  __shared__ float tile[C][SY][SX];
  __shared__ float rows[NP][TILE_Y][SX];
  const int t = threadIdx.y * TILE_X + threadIdx.x;
  for (int k = t; k < SY * SX; k += BLOCK) {
    const int j = k / SX, c0 = k % SX;
    const int64_t src = clamp_index(y0 - R + j, a.H) * a.W + clamp_index(x0 - R + c0, a.W);
#pragma unroll
    for (int c = 0; c < C; ++c) tile[c][j][c0] = __ldg(a.raw + C * src + c);
  }
  __syncthreads();
  for (int k = t; k < TILE_Y * SX; k += BLOCK) {
    const int j = k / SX, c0 = k % SX;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int c = p < C ? p : p - C;
      const bool sq = p >= C;
      float v = tile[c][j + R][c0];
      float s = sq ? v * v : v;
#pragma unroll
      for (int o = 1; o <= R; ++o) {
        const float up = tile[c][j + R - o][c0], down = tile[c][j + R + o][c0];
        s = (s + (sq ? up * up : up)) + (sq ? down * down : down);
      }
      rows[p][j][c0] = s;
    }
  }
  __syncthreads();
  const int ty = threadIdx.y, tx = threadIdx.x + R;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    float s = rows[p][ty][tx];
#pragma unroll
    for (int o = 1; o <= R; ++o) s = (s + rows[p][ty][tx - o]) + rows[p][ty][tx + o];
    sums[p] = s;
  }
}

template <int SITE, int C>
__global__ void __launch_bounds__(BLOCK) temporal_kernel(Args a) {
  const int x0 = blockIdx.x * TILE_X, y0 = blockIdx.y * TILE_Y;
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  constexpr int NP = SITE == SHADOWS ? 1 : (SITE == REFLECTIONS ? 2 * C : 0);
  float sums[NP > 0 ? NP : 1];
  if constexpr (NP > 0) box_sums<C, NP>(a, y0, x0, sums);
  if (x >= a.W || y >= a.H) return;
  const int64_t i = (int64_t)y * a.W + x;

  const Reprojected<C> rep = reproject_px<SITE, C>(a, y, x, i);
  const bool geom = __ldg(a.mesh_id + i) >= 0;
  const bool success = rep.valid && geom;
  const float grown = success ? rep.len + 1.0f : 1.0f;
  float len;
  if constexpr (SITE == REFLECTIONS) {  // camera-motion-aware cap (comp:161-168)
    const float cap = __ldg(a.camera_delta) > (float)1e-5 ? a.cap_moving : a.history_cap;
    len = minimum(cap, grown);
  } else {
    len = clamp_max(grown, a.history_cap);
  }
  const float inv = 1.0f / len;
  const float alpha = success ? clamp_min(inv, a.alpha) : 1.0f;
  float raw[C];
#pragma unroll
  for (int c = 0; c < C; ++c) raw[c] = __ldg(a.raw + C * i + c);

  if constexpr (SITE == AO) {
    const float hist = success ? rep.h[0] : 0.0f;
    a.out[i] = geom ? hist + (raw[0] - hist) * alpha : 1.0f;
    a.out_length[i] = len;
  } else {
    float hist[C];
    float cur0, cur1;  // this frame's moments
    if constexpr (SITE == SHADOWS) {
      // the 17x17 mean of a binary signal, E[x^2] = E[x] (comp:242-246)
      const float mean = sums[0] * INV_BOX;
      const float sd = sqrtf(clamp_min(mean - mean * mean, 0.0f));
      const float ks = sd * a.clamp_k;
      hist[0] = success ? clamp3(rep.h[0], mean - ks, mean + ks) : 0.0f;
      cur0 = raw[0];
      cur1 = raw[0] * raw[0];
    } else {
      // the 17x17 colour mean/sigma AABB clip (comp:111-157, 221-232)
      float center[C], vc[C];
      float ma = 0.0f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float m1 = sums[c] * INV_BOX, m2 = sums[C + c] * INV_BOX;
        const float sigma = sqrtf(clamp_min(m2 - m1 * m1, 0.0f));
        const float lo = m1 - sigma, hi = m1 + sigma;
        center[c] = 0.5f * (hi + lo);
        const float extent = 0.5f * (hi - lo) + (float)1e-5;
        vc[c] = rep.h[c] - center[c];
        const float q = fabsf(vc[c] / extent);
        ma = c == 0 ? q : (isnan(ma) || isnan(q) ? NAN : fmaxf(ma, q));  // torch.amax
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float h = ma > 1.0f ? center[c] + vc[c] / clamp_min(ma, (float)1e-6) : rep.h[c];
        hist[c] = success ? h : 0.0f;
      }
      // math3d.luminance
      cur0 = clamp_min((raw[0] * (float)0.299 + raw[1] * (float)0.587) + raw[2] * (float)0.114,
                       (float)1e-4);
      cur1 = cur0 * cur0;
    }
    const float alpha_m = success ? clamp_min(inv, a.moments_alpha) : 1.0f;
    const float p0 = success ? rep.m[0] : 0.0f, p1 = success ? rep.m[1] : 0.0f;
    const float m0 = p0 + (cur0 - p0) * alpha_m, m1 = p1 + (cur1 - p1) * alpha_m;
    const float variance = clamp_min(m1 - m0 * m0, 0.0f);
#pragma unroll
    for (int c = 0; c < C; ++c)
      a.out[C * i + c] = geom ? hist[c] + (raw[c] - hist[c]) * alpha : 0.0f;
    // the shadows mask their moments and variance, the reflections do not
    const bool keep = SITE == REFLECTIONS || geom;
    a.out_variance[i] = keep ? variance : 0.0f;
    a.out_moments[2 * i] = keep ? m0 : 0.0f;
    a.out_moments[2 * i + 1] = keep ? m1 : 0.0f;
    a.out_length[i] = geom ? len : 0.0f;
  }
}

template <int SITE, int C>
int launch(const Args& a, void* stream) {
  if (a.H > 0 && a.W > 0) {
    const dim3 grid((a.W + TILE_X - 1) / TILE_X, (a.H + TILE_Y - 1) / TILE_Y);
    temporal_kernel<SITE, C><<<grid, dim3(TILE_X, TILE_Y), 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hr_temporal_shadows(int H, int W, const float* position, const float* normal,
                                   const int* mesh_id, const float* motion,
                                   const float* prev_position, const float* prev_normal,
                                   const int* prev_mesh_id, const float* history,
                                   const float* moments, const float* history_length,
                                   const float* raw, float history_cap, float alpha,
                                   float moments_alpha, float clamp_k, float* visibility,
                                   float* variance, float* moments_out, float* length_out,
                                   void* stream) {
  const Args a{H, W, position, normal, mesh_id, motion, nullptr, nullptr, nullptr, nullptr,
               nullptr, prev_position, prev_normal, prev_mesh_id, history, moments,
               history_length, raw, history_cap, alpha, moments_alpha, clamp_k, 0.0f,
               visibility, variance, moments_out, length_out};
  return launch<SHADOWS, 1>(a, stream);
}

extern "C" int hr_temporal_ao(int H, int W, const float* position, const float* normal,
                              const int* mesh_id, const float* motion, const float* prev_position,
                              const float* prev_normal, const int* prev_mesh_id,
                              const float* history, const float* history_length, const float* raw,
                              float history_cap, float alpha, float* ao, float* length_out,
                              void* stream) {
  const Args a{H, W, position, normal, mesh_id, motion, nullptr, nullptr, nullptr, nullptr,
               nullptr, prev_position, prev_normal, prev_mesh_id, history, nullptr,
               history_length, raw, history_cap, alpha, 0.0f, 0.0f, 0.0f,
               ao, nullptr, nullptr, length_out};
  return launch<AO, 1>(a, stream);
}

extern "C" int hr_temporal_reflections(
    int H, int W, const float* position, const float* normal, const int* mesh_id,
    const float* motion, const float* ray_length, const float* curvature, const float* cam_pos,
    const float* prev_view_proj, const float* camera_delta, const float* prev_position,
    const float* prev_normal, const int* prev_mesh_id, const float* history,
    const float* moments, const float* history_length, const float* raw, float history_cap,
    float cap_moving, float alpha, float moments_alpha, float* color, float* variance,
    float* moments_out, float* length_out, void* stream) {
  const Args a{H, W, position, normal, mesh_id, motion, ray_length, curvature, cam_pos,
               prev_view_proj, camera_delta, prev_position, prev_normal, prev_mesh_id, history,
               moments, history_length, raw, history_cap, alpha, moments_alpha, 0.0f,
               cap_moving, color, variance, moments_out, length_out};
  return launch<REFLECTIONS, 3>(a, stream);
}
