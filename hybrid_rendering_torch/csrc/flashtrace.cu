// K6 (dense closest hit, with or without the winner's attribute row) and
// K6' (dense any-hit visibility): every ray against every triangle through
// the affine Moller-Trumbore product.
//
// Replaces the dense v1 FlashTrace Pallas kernels of hybrid_rendering_tpu/
// ops/pallas/flashtrace.py: K6 = _closest_kernel (:247; pallas_call at
// :411 in _flash_closest_impl, entries flash_closest_hit :437 and
// flash_closest_hit_attrs :446), K6' = _anyhit_kernel (:317; pallas_call
// at :1742 in flash_visibility :1728).
//
// The TPU kernels compute a (rays x 16) @ (16 x 4*128) MXU product per
// (ray tile, triangle tile) grid step, keep a running argmin (or a blocked
// flag) in VMEM and select the winner's attribute row with a one-hot
// matmul. Here a thread holds one or two rays' 10 features [o - center, d,
// (o - center) x d, 1] in registers; the block stages a tile of 128
// triangles' 19 non-zero coefficients (20 floats a triangle, 10 KB) in
// shared memory and every thread loops over it, reading each coefficient
// as a broadcast. Both kernels first compact the live rays (t_max > t_min),
// reject most pairs by tests without the reciprocal that provably never
// reject a pair the exact test accepts, and split the triangles over
// several parts where the rays are few. K6 keeps the running best with a
// strict '<' (the lowest index wins a tie) and reads the winner's attribute
// row at the end (the one-hot select is a gather here); K6' stops a ray at
// its first blocker. The designs and what bounds each are set out above
// each kernel below.
//
// The exact test, the plain version's (ops/flashtrace.py pair_tests):
// |det| > 1e-9, inv_det = RN(1 / det) (__frcp_rn), t, u, v = num * inv_det,
// u >= 0, v >= 0, u + v <= 1, t_min < t < t_max (K6: < the running best).
// Rounding: built with -fmad=false; each scalar is summed left to right
// over the non-zero features as ops/flashtrace.py _affine sums it, so both
// kernels match the plain version bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int TILE = 128;   // triangles staged per pass
constexpr int FEAT = 10;    // ops/flashtrace.py FEAT
constexpr int COEF4 = 5;    // a triangle's 20 coefficients as 5 float4
constexpr int ATTR = 24;    // attribute row width

// Coefficient record of one triangle (ops/flashtrace.py make_flash_scene
// coef): [det: d0 d1 d2 | t: o0 o1 o2 1 | u: d0 d1 d2 m0 m1 m2 |
//         v: d0 d1 d2 m0 m1 m2 | pad]

// ---------------------------------------------------------------------------
// K6, redesigned for the H100
//
// What bounds it: issued instructions. The parent took 9.84 ms for the
// 5.2e9 (ray, triangle) pairs of the 1080p primary site (an H100 80GB HBM3
// at 700 W, chip_smoke.py), ~63 issued instructions a pair at 132 SMs x 4
// issues a clock: every pair with |det| > 1e-9 (nearly all) paid the
// correctly rounded reciprocal and t's product, and t_min < t < best holds
// for a large share of the pairs (every plane in front of a ray that
// misses), whose u and v a warp then computes for all its lanes; the
// probe and reflection rays of a warp point every way. The design:
//   (a) pre-tests without the reciprocal. With s = sign(det), a = |det|,
//       st = s * t_num, su = s * u_num, sv = s * v_num (sign flips, exact),
//       a pair goes on to the exact test only where
//         klo * a < st < bhi * a,   klo = RN(t_min * (1 - 2^-20)),
//                                   bhi = RN(best * (1 + 2^-20)),
//         su >= -a * 2^-60,  sv >= -a * 2^-60,  su + sv <= a * (1 + 2^-20).
//       Proof that no pair the exact test accepts is rejected, with
//       u = 2^-24 and inv = RN(1/det) = (s/a)(1 + e0), |e0| <= u (the
//       exact test needs a > 1e-9, and a block takes the pre-tests only if
//       no ray of it can meet a > 2^100, so inv is normal):
//       * t: t = RN(t_num * inv) in (t_min, best), t_min >= 2^-90, so the
//         product is normal and t = (st/a)(1+e0)(1+e1). Hence st >
//         a t_min/(1+u)^2 > a t_min (1-2^-20)(1+u)^2 >= RN(klo * a), as
//         (1-2^-20) <= (1+u)^-4; and st < a best/(1-u)^2 <= a best
//         (1+2^-20)(1-u)^2 <= RN(bhi * a) (or inf), as (1+2^-20) >=
//         (1-u)^-4. Every product is normal: a t_min >= 2^-120.
//       * u (v alike): RN(u_num * inv) >= 0 holds for a negative product
//         only if it rounds to -0, i.e. |u_num * inv| <= 2^-150, so
//         su >= -2^-150 a (1+u) > -a 2^-60 (a 2^-60 is exact).
//       * u + v: RN(u + v) <= 1 means u + v <= 1 + u, and undoing the two
//         roundings of each (relative u, absolute 2^-150 where it
//         underflows) gives su + sv <= a (1 + 2^-22) in reals, so RN(su +
//         sv) <= a (1 + 2^-22)(1 + u) <= a (1 + 2^-20)(1 - u) <= RN(a (1 +
//         2^-20)). NaN fails both tests; inf can only pass a pre-test.
//       Where the proof does not reach (t_min outside [2^-90, 2^20], or a
//       ray whose |d_x| + |d_y| + |d_z| times the scene's det_bound exceeds
//       2^99) the block's bounds are open: the factors are infinite, and
//       with t_min >= 0 (the wrapper refuses a negative t_min) a live ray's
//       best is > 0 and so is every accepted t, so bhi * a is +inf for
//       every a > 0. Pairs that pass run the
//       parent's exact arithmetic unchanged (|det| > 1e-9, reciprocal, t,
//       u, v, acceptance), so the exact test still decides every result.
//       tests/test_torch_k6_design.py holds a float32 model of these
//       tests to the plain acceptance. Pairs in t's window still compute
//       u and v, so the scan issues ~43 instructions a pair at the primary
//       site (6.65 ms, same card; PERF.md), not ~63.
//   (b) two rays a thread from 2^20 rays up (each broadcast coefficient
//       load feeds two chains), one below (the small sites diverge more);
//   (c) the coefficient table padded with zero rows to whole tiles (det =
//       0 fails every pair), so the tile loop has a fixed trip count;
//   (d) tiles double-buffered through cp.async were measured (PERF.md) and
//       not kept: 1.8% faster at the primary site, 6% and 13% slower at
//       the probe and reflection sites;
//   (e) live rays compacted first, a block of 1,024 rays at a time and in
//       order (dead rays get their miss written there: 72% of the
//       reflection site), and the triangles split over up to MAX_PARTS
//       parts where the rays' blocks fill less than the card (the probe
//       site: 2). The scan leaves each ray's winner as a 64-bit key
//       (bits(t) << 32 | tri_id), stored or, across parts, merged with
//       atomicMin: for t > 0 (t_min >= 0) the float bits order as the
//       value, and the lower index wins a tie, the plain version's rule.
//       A merge kernel then recomputes the winner's u, v with the scan's
//       arithmetic and gathers its attribute row; a key left at all ones
//       is a miss.
// Rounding stays the parent's: -fmad=false, sums left to right, a
// correctly rounded reciprocal: bit for bit the plain version.

constexpr int K6_BLOCK = 128;     // threads a block
constexpr int K6_TILE4 = TILE * COEF4;  // float4 a tile
constexpr float K6_SLACK_HI = 1.00000095367431640625f;  // 1 + 2^-20
constexpr unsigned long long K6_MISS = ~0ull;

struct K6Args {
  const float4* coef;      // (num_tiles * TILE, 20) zero-padded
  const float* attrs;      // (T, 24) or null
  const float* feats;      // (R, 10)
  const float* t_max;      // (R,)
  const int* list;         // live ray indices, *count of them
  const int* count;
  int num_tiles;
  float t_min, klo;
  int pre;                 // 2^-90 <= t_min <= 2^20: the pre-tests' proof holds
  float det_bound;         // max over triangles of |c_d0| + |c_d1| + |c_d2|, rounded up
  float* out_t;
  float* out_u;
  float* out_v;
  int* out_id;
  float* out_attrs;        // (R, 24) or null
  unsigned long long* keys;  // (R,) each live ray's winner as a key, all ones: none
};

struct K6PArgs {
  const float4* coef;      // (num_tiles * TILE, 20) zero-padded
  const float* origin;     // (R, 3) origins, directions and the scene's (3,) center,
  const float* direction;  // from which the scan forms each ray's features
  const float* center;
  const float* t_max;      // (R,)
  const int* list;         // live ray indices, *count of them
  const int* count;
  int num_tiles;
  float t_min, klo;
  int pre;                 // 2^-90 <= t_min <= 2^20: the pre-tests' proof holds
  float det_bound;         // max over triangles of |c_d0| + |c_d1| + |c_d2|, rounded up
  float* out_vis;          // (R,) 1.0 unoccluded, 0.0 blocked: the parts' shared flag
};

// s * x for s = sign(det): x with det's sign bit xor-ed in (exact)
__device__ __forceinline__ float k6_xsign(float x, float det) {
  return __int_as_float(__float_as_int(x) ^ (__float_as_int(det) & (int)0x80000000));
}

__device__ __forceinline__ void k6_write(const K6Args& a, int r, float t, float u, float v,
                                         int id) {
  a.out_t[r] = t;
  a.out_u[r] = u;
  a.out_v[r] = v;
  a.out_id[r] = id;
  if (a.out_attrs != nullptr) {
    float4* row = reinterpret_cast<float4*>(a.out_attrs + (size_t)r * ATTR);
    if (id >= 0) {
      const float4* src = reinterpret_cast<const float4*>(a.attrs + (size_t)id * ATTR);
#pragma unroll
      for (int k = 0; k < ATTR / 4; ++k) row[k] = __ldg(src + k);
    } else {
#pragma unroll
      for (int k = 0; k < ATTR / 4; ++k) row[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
}

// Compaction: the live rays (t_max > t_min) of a block of K6_COMPACT rays
// appended to the list together and in order, so that the scan's blocks
// get neighbouring rays. What a dead ray gets is written here: K6's miss (t =
// t_max, u = v = 0, tri_id -1, a zero row), K6''s 0.0 (blocked,
// flashtrace.py:323); a live ray's K6 merge key is set to a miss, its K6'
// flag to 1.0 (unoccluded until a part finds a blocker).
constexpr int K6_COMPACT = 1024;

__device__ __forceinline__ void k6_mark_live(const K6Args& a, int r) { a.keys[r] = K6_MISS; }
__device__ __forceinline__ void k6_mark_dead(const K6Args& a, int r, float tm) {
  k6_write(a, r, tm, 0.0f, 0.0f, -1);
}
__device__ __forceinline__ void k6_mark_live(const K6PArgs& a, int r) { a.out_vis[r] = 1.0f; }
__device__ __forceinline__ void k6_mark_dead(const K6PArgs& a, int r, float) {
  a.out_vis[r] = 0.0f;
}

template <class Args>
__global__ void __launch_bounds__(K6_COMPACT) k6_compact_kernel(const Args a, int num_rays,
                                                                int* list, int* count) {
  __shared__ int warp_base[K6_COMPACT / 32 + 1];
  const int r = blockIdx.x * K6_COMPACT + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float tm = r < num_rays ? __ldg(a.t_max + r) : 0.0f;
  const bool live = r < num_rays && tm > a.t_min;
  const unsigned ballot = __ballot_sync(0xffffffffu, live);
  if (lane == 0) warp_base[warp] = __popc(ballot);
  __syncthreads();
  if (threadIdx.x == 0) {  // the block's live rays in warp order, one atomic
    int total = 0;
    for (int w = 0; w < K6_COMPACT / 32; ++w) {
      const int c = warp_base[w];
      warp_base[w] = total;
      total += c;
    }
    warp_base[K6_COMPACT / 32] = total > 0 ? atomicAdd(count, total) : 0;
  }
  __syncthreads();
  if (live) {
    list[warp_base[K6_COMPACT / 32] + warp_base[warp] + __popc(ballot & ((1u << lane) - 1u))] = r;
    k6_mark_live(a, r);
  } else if (r < num_rays) {
    k6_mark_dead(a, r, tm);
  }
}

// The winner's u and v, recomputed with the scan's arithmetic (bit for
// bit what the scan computed), and the ray's outputs written
__device__ __forceinline__ void k6_finish(const K6Args& a, int r, float t, int id) {
  if (id < 0) {
    k6_write(a, r, t, 0.0f, 0.0f, -1);
    return;
  }
  float fk[FEAT];
#pragma unroll
  for (int q = 0; q < FEAT; ++q) fk[q] = __ldg(a.feats + (size_t)r * FEAT + q);
  const float4* c = a.coef + (size_t)id * COEF4;
  const float4 A = __ldg(c), B = __ldg(c + 1), C = __ldg(c + 2), E = __ldg(c + 3),
               G = __ldg(c + 4);
  const float det = (fk[3] * A.x + fk[4] * A.y) + fk[5] * A.z;
  const float un = ((((fk[3] * B.w + fk[4] * C.x) + fk[5] * C.y) + fk[6] * C.z) +
                    fk[7] * C.w) + fk[8] * E.x;
  const float vn = ((((fk[3] * E.y + fk[4] * E.z) + fk[5] * E.w) + fk[6] * G.x) +
                    fk[7] * G.y) + fk[8] * G.z;
  const float inv_det = __frcp_rn(det);
  k6_write(a, r, t, un * inv_det, vn * inv_det, id);
}

// The scan of one part of the triangles (blockIdx.y of gridDim.y) by a
// group of K6_BLOCK * RPT live rays (blockIdx.x): a thread holds RPT rays,
// list entries group base + k * K6_BLOCK + threadIdx.x. A ray's pre-test
// bounds are klo * a, bhi * a, -a * mrg and a * cap; where the proof does
// not reach (pre is 0: t_min outside its range; or a ray of the block
// could meet a |det| above 2^100: its |d_x| + |d_y| + |d_z| times the
// scene's det_bound above 2^99, never at the scenes' sizes) the block's
// factors are infinite and the bounds open, so the pair math is the same
// in every block.
template <int RPT>
__global__ void __launch_bounds__(K6_BLOCK) k6_closest_kernel(const K6Args a) {
  __shared__ __align__(16) float4 tiles[K6_TILE4];
  const int n = *a.count;
  const int base = blockIdx.x * K6_BLOCK * RPT;
  if (base >= n) return;  // the list is shorter than the launch
  const int tid = threadIdx.x, parts = gridDim.y, part = blockIdx.y;
  const int t0 = (int)((long long)part * a.num_tiles / parts);
  const int t1 = (int)((long long)(part + 1) * a.num_tiles / parts);

  float f[RPT][FEAT];
  float best[RPT], bhi[RPT];
  int bid[RPT], ray[RPT];  // the winner's u and v are recomputed at the end
  bool bounded = true;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int e = base + k * K6_BLOCK + tid;
    ray[k] = e < n ? a.list[e] : -1;
    // an empty slot has zero features: det = 0 fails every pair
#pragma unroll
    for (int q = 0; q < FEAT; ++q)
      f[k][q] = ray[k] >= 0 ? __ldg(a.feats + (size_t)ray[k] * FEAT + q) : 0.0f;
    bounded &= (fabsf(f[k][3]) + fabsf(f[k][4]) + fabsf(f[k][5])) * a.det_bound <= 0x1p99f;
    best[k] = ray[k] >= 0 ? __ldg(a.t_max + ray[k]) : 0.0f;
    bid[k] = -1;
  }
  // the block's factors of the pre-test bounds, the same for its rays
  const bool pre = a.pre && __syncthreads_and(bounded);
  const float klo = pre ? a.klo : -INFINITY, mrg = pre ? 0x1p-60f : INFINITY,
              cap = pre ? K6_SLACK_HI : INFINITY;
#pragma unroll
  for (int k = 0; k < RPT; ++k) bhi[k] = best[k] * cap;  // RN(best (1 + 2^-20)), or open

  for (int tile = t0; tile < t1; ++tile) {
    for (int i = tid; i < K6_TILE4; i += K6_BLOCK)
      tiles[i] = __ldg(a.coef + (size_t)tile * K6_TILE4 + i);
    __syncthreads();
    const float4* tl = tiles;
    // one triangle against the thread's rays
    auto scan_one = [&](int j) {
      const float4 A = tl[j * COEF4 + 0];  // det d0 d1 d2, t o0
      const float4 B = tl[j * COEF4 + 1];  // t o1 o2 1, u d0
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        const float det = (f[k][3] * A.x + f[k][4] * A.y) + f[k][5] * A.z;
        // the feature 1 multiplies its coefficient exactly: 1 * c = c
        const float tn = ((f[k][0] * A.w + f[k][1] * B.x) + f[k][2] * B.y) + B.z;
        const float ad = fabsf(det);
        const float st = k6_xsign(tn, det);
        // |det| > 1e-9 is left to the exact test: where it fails, no bound
        // need hold (a zero det, an empty slot's, gives lo = hi = 0)
        if (!(st > klo * ad && st < bhi[k] * ad)) continue;
        const float4 C = tl[j * COEF4 + 2];  // u d1 d2 m0 m1
        const float4 E = tl[j * COEF4 + 3];  // u m2, v d0 d1 d2
        const float un = ((((f[k][3] * B.w + f[k][4] * C.x) + f[k][5] * C.y) + f[k][6] * C.z) +
                          f[k][7] * C.w) + f[k][8] * E.x;
        const float margin = -ad * mrg;
        const float su = k6_xsign(un, det);
        if (!(su >= margin)) continue;
        const float4 G = tl[j * COEF4 + 4];  // v m0 m1 m2, pad
        const float vn = ((((f[k][3] * E.y + f[k][4] * E.z) + f[k][5] * E.w) + f[k][6] * G.x) +
                          f[k][7] * G.y) + f[k][8] * G.z;
        const float sv = k6_xsign(vn, det);
        if (!(sv >= margin && su + sv <= ad * cap)) continue;
        // the parent's exact test
        if (!(ad > 1e-9f)) continue;
        const float inv_det = __frcp_rn(det);
        const float t = tn * inv_det;
        if (!(t > a.t_min && t < best[k])) continue;
        const float u = un * inv_det;
        const float v = vn * inv_det;
        if (u >= 0.0f && v >= 0.0f && u + v <= 1.0f) {
          best[k] = t;
          bhi[k] = t * cap;
          bid[k] = tile * TILE + j;
        }
      }
    };
    // the triangle loop unrolled 4 times with two rays a thread, not at all
    // with one (whose warps diverge most): measured (PERF.md)
    if constexpr (RPT == 2) {
#pragma unroll 4
      for (int j = 0; j < TILE; ++j) scan_one(j);
    } else {
#pragma unroll 1
      for (int j = 0; j < TILE; ++j) scan_one(j);
    }
    __syncthreads();  // before the next tile overwrites this one
  }

  // the winner as its key: stored, or merged with the other parts'
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    if (ray[k] < 0 || bid[k] < 0) continue;
    const unsigned long long key =
        ((unsigned long long)__float_as_uint(best[k]) << 32) | (unsigned)bid[k];
    if (parts == 1) {
      a.keys[ray[k]] = key;
    } else {
      atomicMin(a.keys + ray[k], key);
    }
  }
}

// After the scan: each live ray's winner (t from its key, u and v
// recomputed) and attribute row, or the miss.
__global__ void __launch_bounds__(256) k6_merge_kernel(const K6Args a) {
  const int n = *a.count;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n; e += gridDim.x * blockDim.x) {
    const int r = a.list[e];
    const unsigned long long key = a.keys[r];
    if (key == K6_MISS) {
      k6_finish(a, r, __ldg(a.t_max + r), -1);
    } else {
      k6_finish(a, r, __uint_as_float((unsigned)(key >> 32)), (int)(unsigned)(key & 0xffffffffu));
    }
  }
}

template <int RPT>
int launch_k6(const K6Args& a, int num_rays, int parts, cudaStream_t s) {
  const dim3 grid((num_rays + K6_BLOCK * RPT - 1) / (K6_BLOCK * RPT), parts);
  k6_closest_kernel<RPT><<<grid, K6_BLOCK, 0, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  k6_merge_kernel<<<(num_rays + 255) / 256, 256, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K6', redesigned for the H100
//
// What bounds it: issued instructions, as K6. The parent (one thread a ray,
// 128 rays a block, the exact test on every pair) took 8.45 ms for the
// 2,592,000 shadow + AO rays of the 1080p dense frame (an H100 80GB HBM3 at
// 700 W, chip_smoke.py), 21% of its operations bound: every pair with
// |det| > 1e-9 paid the correctly rounded reciprocal and t's product; a
// lane whose ray was blocked idled while its warp scanned on for the
// others, and its block went on until all 128 rays were blocked; dead rays
// (t_max <= t_min: sky pixels, the reflection rays that missed, ~87% of the
// reflection-hit site) held lanes; and the probe sites' 1,156 blocks and
// the reflection-hit site's live rays filled less than the card. The design:
//   (a) K6's pre-tests without the reciprocal, with the window fixed: a pair
//       goes on to the exact test only where
//         klo * a < st < thi * a,   thi = RN(t_max * (1 + 2^-20)), once a ray,
//         su >= -a * 2^-60,  sv >= -a * 2^-60,  su + sv <= a * (1 + 2^-20).
//       K6's proof (above) holds word for word with best = t_max: any-hit
//       never narrows the window, and every listed ray has t_max > t_min >=
//       2^-90 where the bounds are closed, so thi > 0 and thi * a >= 2^-120
//       is normal for a > 1e-9. Where the proof does not reach (t_min
//       outside [2^-90, 2^20], or a ray of the block whose |d_x| + |d_y| +
//       |d_z| times the scene's det_bound exceeds 2^99) the block's bounds
//       are set open directly, klo = -inf, thi = +inf, the margin's and the
//       cap's factors +inf, and never as t_max times an infinite factor
//       (NaN or -inf for t_max <= 0). Open bounds pass every pair whose
//       scalars are finite and a > 0 (-inf < st < +inf, su >= -inf, su + sv
//       <= +inf); they reject a = 0 (a NaN bound), which |det| > 1e-9
//       rejects too, and an infinite or NaN scalar, which the exact test
//       cannot accept either (t, u or v is then infinite or NaN). So every
//       t_min and t_max is taken: a negative t_min, t_max = +inf, t_max <= 0
//       with a negative t_min. Pairs that pass run the parent's exact
//       arithmetic unchanged, so the exact test decides every result.
//       tests/test_torch_k6p_design.py holds a float32 model of these tests
//       to the plain acceptance and breaks when any slack is 0.
//   (b) a warp that stops issuing pair tests once all its rays are blocked
//       (a vote every 2 to 16 triangles) was measured and not kept: with
//       >= 93% of the live rays unoccluded at every site of the frame the
//       votes cost more than they save (PERF.md). A blocked lane skips its
//       pairs, and the block leaves the tile loop once none of its rays
//       searches, as in the parent;
//   (c) live rays compacted first by K6's compaction (dead rays get their
//       0.0 there), so the scan's lanes hold only live rays; the scan forms
//       a live ray's features from its origin, direction and the scene's
//       center (as ops/flashtrace.py features rounds them), so no (R, 10)
//       table is written and read for every ray;
//   (d) the triangles split over up to max_parts parts where the live rays'
//       blocks fill less than the card: split_parts's rule (ops/
//       flashtrace.py), applied on the device to the live count, so that
//       no host read waits for it; the grid holds enough blocks for any
//       count, and those past the chosen split leave at once. Any-hit is an
//       OR over the triangles, so the parts scan their tiles in any order
//       and need no merge: a part that finds a blocker stores 0.0 to the
//       ray's word, which the compaction set to 1.0 and which is the output
//       (stores of one value, race-free), and every part reads the word
//       before each tile to stop early. Two rays a thread from 2^20 rays
//       up, as K6; with one, u and v are tested in one branch (a warp's
//       lanes diverge more there, and a second branch costs more than the
//       v it saves).
// Measured and not kept besides (PERF.md): the rays of a narrow batch
// sorted by the Morton code of their origin (its warps agree more and the
// probe sites gain 9-14%, but sorting the whole batch costs more than it
// saves at the other sites). What bounds it after the redesign: issue, at
// ~0.75e12 pairs/s on the coherent shadow + AO batch as K6 on its primary
// rays, and ~0.44e12 on the probe batches, whose warps' lanes disagree on
// t's window for most pairs.
// No tile is culled by its box: the exact test accepts grazing pairs whose
// t lies far from the geometric hit, and no margin for that was proven.
// Rounding stays the parent's: -fmad=false, sums left to right, a
// correctly rounded reciprocal: bit for bit the plain version.

// The parts K6' splits the triangles into for `groups` (>= 1) groups of
// live rays: ops/flashtrace.py split_parts, with max_parts for MAX_PARTS.
__device__ __forceinline__ int k6p_parts(int groups, int max_parts, int resident,
                                         int num_tiles) {
  if (groups >= resident) return 1;
  return max(1, min(min(max_parts, (resident + groups - 1) / groups), num_tiles));
}

// Ray r's features [o - center, d, (o - center) x d, 1], rounded as
// ops/flashtrace.py features forms them (each product and difference alone)
__device__ __forceinline__ void k6p_features(const K6PArgs& a, int r, float* f) {
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    f[q] = __ldg(a.origin + (size_t)r * 3 + q) - __ldg(a.center + q);
    f[3 + q] = __ldg(a.direction + (size_t)r * 3 + q);
  }
  f[6] = f[1] * f[5] - f[2] * f[4];
  f[7] = f[2] * f[3] - f[0] * f[5];
  f[8] = f[0] * f[4] - f[1] * f[3];
  f[9] = 1.0f;
}

// The scan: block b scans part b / groups of the triangles with group
// b % groups of the live rays (K6_BLOCK * RPT of them, list entries group
// base + k * K6_BLOCK + threadIdx.x), the pre-test bounds of K6's scan with
// the window fixed at each ray's (t_min, t_max).
template <int RPT>
__device__ __forceinline__ void k6p_scan(const K6PArgs& a, int max_parts, int resident) {
  __shared__ __align__(16) float4 tiles[K6_TILE4];
  const int n = *a.count;
  const int groups = (n + K6_BLOCK * RPT - 1) / (K6_BLOCK * RPT);
  if (groups == 0) return;
  const int parts = k6p_parts(groups, max_parts, resident, a.num_tiles);
  if ((int)blockIdx.x >= groups * parts) return;  // past the split chosen for this count
  const int part = blockIdx.x / groups;
  const int base = (blockIdx.x - part * groups) * K6_BLOCK * RPT;
  const int tid = threadIdx.x;
  const int t0 = (int)((long long)part * a.num_tiles / parts);
  const int t1 = (int)((long long)(part + 1) * a.num_tiles / parts);

  float f[RPT][FEAT];
  float tmax[RPT], thi[RPT];
  int ray[RPT];
  bool live[RPT];  // listed, and no blocker found yet
  bool bounded = true;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int e = base + k * K6_BLOCK + tid;
    ray[k] = e < n ? a.list[e] : -1;
    if (ray[k] >= 0) {
      k6p_features(a, ray[k], f[k]);
    } else {  // an empty slot has zero features: det = 0 fails every pair
#pragma unroll
      for (int q = 0; q < FEAT; ++q) f[k][q] = 0.0f;
    }
    bounded &= (fabsf(f[k][3]) + fabsf(f[k][4]) + fabsf(f[k][5])) * a.det_bound <= 0x1p99f;
    tmax[k] = ray[k] >= 0 ? __ldg(a.t_max + ray[k]) : 0.0f;
    live[k] = ray[k] >= 0;
  }
  // the block's pre-test bounds: closed where the proof holds for all its
  // rays, else open, set directly
  const bool pre = a.pre && __syncthreads_and(bounded);
  const float klo = pre ? a.klo : -INFINITY, mrg = pre ? 0x1p-60f : INFINITY,
              cap = pre ? K6_SLACK_HI : INFINITY;
#pragma unroll
  for (int k = 0; k < RPT; ++k) thi[k] = pre ? tmax[k] * K6_SLACK_HI : INFINITY;

  for (int tile = t0; tile < t1; ++tile) {
    bool searching = false;
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      // a blocker another part found (its store of 0.0, read from L2)
      if (parts > 1 && live[k] && __ldcg(a.out_vis + ray[k]) == 0.0f) live[k] = false;
      searching |= live[k];
    }
    // the barrier before the tile is overwritten; the block leaves once
    // none of its rays searches
    if (!__syncthreads_or(searching)) break;
    for (int i = tid; i < K6_TILE4; i += K6_BLOCK)
      tiles[i] = __ldg(a.coef + (size_t)tile * K6_TILE4 + i);
    __syncthreads();
    const float4* tl = tiles;
    // one triangle against the thread's rays that still search
    auto scan_one = [&](int j) {
      const float4 A = tl[j * COEF4 + 0];  // det d0 d1 d2, t o0
      const float4 B = tl[j * COEF4 + 1];  // t o1 o2 1, u d0
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        if (!live[k]) continue;
        const float det = (f[k][3] * A.x + f[k][4] * A.y) + f[k][5] * A.z;
        // the feature 1 multiplies its coefficient exactly: 1 * c = c
        const float tn = ((f[k][0] * A.w + f[k][1] * B.x) + f[k][2] * B.y) + B.z;
        const float ad = fabsf(det);
        const float st = k6_xsign(tn, det);
        if (!(st > klo * ad && st < thi[k] * ad)) continue;
        const float4 C = tl[j * COEF4 + 2];  // u d1 d2 m0 m1
        const float4 E = tl[j * COEF4 + 3];  // u m2, v d0 d1 d2
        const float un = ((((f[k][3] * B.w + f[k][4] * C.x) + f[k][5] * C.y) + f[k][6] * C.z) +
                          f[k][7] * C.w) + f[k][8] * E.x;
        const float margin = -ad * mrg;
        const float su = k6_xsign(un, det);
        // two rays a thread skip v where u fails; one tests both at once
        if (RPT == 2 && !(su >= margin)) continue;
        const float4 G = tl[j * COEF4 + 4];  // v m0 m1 m2, pad
        const float vn = ((((f[k][3] * E.y + f[k][4] * E.z) + f[k][5] * E.w) + f[k][6] * G.x) +
                          f[k][7] * G.y) + f[k][8] * G.z;
        const float sv = k6_xsign(vn, det);
        if (!((RPT == 2 || su >= margin) && sv >= margin && su + sv <= ad * cap)) continue;
        // the parent's exact test
        if (!(ad > 1e-9f)) continue;
        const float inv_det = __frcp_rn(det);
        const float t = tn * inv_det;
        if (!(t > a.t_min && t < tmax[k])) continue;
        const float u = un * inv_det;
        const float v = vn * inv_det;
        if (u >= 0.0f && v >= 0.0f && u + v <= 1.0f) {
          live[k] = false;
          a.out_vis[ray[k]] = 0.0f;
        }
      }
    };
#pragma unroll 8
    for (int j = 0; j < TILE; ++j) scan_one(j);
  }
}

// The scan's kernels: with two rays a thread the registers are capped at
// 8 blocks a multiprocessor (64 a thread), with one they are left to the
// compiler (54): each measured the faster (PERF.md)
__global__ void __launch_bounds__(K6_BLOCK) k6p_anyhit_kernel1(const K6PArgs a, int max_parts,
                                                               int resident) {
  k6p_scan<1>(a, max_parts, resident);
}

__global__ void __launch_bounds__(K6_BLOCK, 8) k6p_anyhit_kernel2(const K6PArgs a, int max_parts,
                                                                  int resident) {
  k6p_scan<2>(a, max_parts, resident);
}

template <int RPT>
int launch_k6p(const K6PArgs& a, int num_rays, int max_parts, int resident, cudaStream_t s) {
  // blocks for the split the kernel chooses from any live count n <= num_rays:
  // groups(n) x parts <= groups(num_rays) x max_parts, and below resident +
  // groups(n) where it splits (parts = ceil(resident / groups(n)) at most)
  const long long groups = (num_rays + K6_BLOCK * RPT - 1) / (K6_BLOCK * RPT);
  const long long blocks =
      std::max(groups, std::min(groups * max_parts, (long long)resident + groups));
  if (RPT == 1) {
    k6p_anyhit_kernel1<<<(unsigned)blocks, K6_BLOCK, 0, s>>>(a, max_parts, resident);
  } else {
    k6p_anyhit_kernel2<<<(unsigned)blocks, K6_BLOCK, 0, s>>>(a, max_parts, resident);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// K6: closest hit with t in (t_min, t_max), every live ray against every
// triangle. coef is the (num_tiles * 128, 20) zero-padded table; attrs /
// out_attrs may be null (no attribute rows). list (R ints), count (1 int)
// and keys (R 64-bit words) are the wrapper's scratch. rays_per_thread is
// 1 or 2; parts splits the triangles (1: no split); t_min >= 0 (the
// merge key orders positive t only); pre: 2^-90 <= t_min
// <= 2^20 (the pre-tests' proof holds); det_bound: the scene's
// FlashScene.det_bound. Four launches: a memset, the compaction, the
// scan, the merge.
extern "C" int hr_flash_closest(const float* coef, int num_tiles, const float* attrs,
                                const float* feats, const float* t_max, int num_rays,
                                float t_min, float klo, int pre, float det_bound,
                                int rays_per_thread, int parts, int* list, int* count,
                                unsigned long long* keys, float* out_t, float* out_u,
                                float* out_v, int* out_id, float* out_attrs, void* stream) {
  if (num_rays <= 0) return (int)cudaGetLastError();
  if (num_tiles < 1 || parts < 1 || parts > num_tiles || keys == nullptr || !(t_min >= 0.0f) ||
      num_rays > (1 << 30) ||
      (rays_per_thread != 1 && rays_per_thread != 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  K6Args a;
  a.coef = reinterpret_cast<const float4*>(coef);
  a.attrs = attrs;
  a.feats = feats;
  a.t_max = t_max;
  a.list = list;
  a.count = count;
  a.num_tiles = num_tiles;
  a.t_min = t_min;
  a.klo = klo;
  a.pre = pre;
  a.det_bound = det_bound;
  a.out_t = out_t;
  a.out_u = out_u;
  a.out_v = out_v;
  a.out_id = out_id;
  a.out_attrs = out_attrs;
  a.keys = keys;
  cudaError_t e = cudaMemsetAsync(count, 0, sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  k6_compact_kernel<K6Args><<<(num_rays + K6_COMPACT - 1) / K6_COMPACT, K6_COMPACT, 0, s>>>(
      a, num_rays, list, count);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return rays_per_thread == 1 ? launch_k6<1>(a, num_rays, parts, s)
                              : launch_k6<2>(a, num_rays, parts, s);
}

// K6's scan blocks a multiprocessor holds at once at rays_per_thread, for
// the wrapper's choice of the split; -1 on a bad argument.
extern "C" int hr_flash_closest_blocks_per_sm(int rays_per_thread) {
  int blocks = 0;
  if (rays_per_thread != 1 && rays_per_thread != 2) return -1;
  const cudaError_t e =
      rays_per_thread == 1
          ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k6_closest_kernel<1>, K6_BLOCK, 0)
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k6_closest_kernel<2>, K6_BLOCK, 0);
  return e == cudaSuccess ? blocks : -1;
}

// K6': any-hit visibility with t in (t_min, t_max), every live ray against
// every triangle: out_vis 1.0 unoccluded, 0.0 blocked, and 0.0 where t_max
// <= t_min (flashtrace.py:323). coef is the (num_tiles * 128, 20)
// zero-padded table; origin, direction (R, 3) and the scene's center (3,)
// give the features; list (R ints) and count (1 int) are the wrapper's
// scratch. Any t_min is taken; pre: 2^-90 <= t_min <= 2^20 (the pre-tests'
// proof holds), klo = RN(t_min (1 - 2^-20)); det_bound: the scene's
// FlashScene.det_bound. rays_per_thread is 1 or 2; the triangles split over
// at most max_parts parts, as many as bring the live rays' blocks up to
// `resident` (the scan's blocks the card holds at once; a resident above
// every block count forces max_parts parts). Three launches: a memset, the
// compaction, the scan.
extern "C" int hr_flash_visibility(const float* coef, int num_tiles, const float* origin,
                                   const float* direction, const float* center,
                                   const float* t_max, int num_rays, float t_min, float klo,
                                   int pre, float det_bound, int rays_per_thread, int max_parts,
                                   int resident, int* list, int* count, float* out_vis,
                                   void* stream) {
  if (num_rays <= 0) return (int)cudaGetLastError();
  if (num_tiles < 1 || max_parts < 1 || max_parts > 64 || resident < 1 ||
      num_rays > (1 << 30) || out_vis == nullptr ||
      (rays_per_thread != 1 && rays_per_thread != 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  K6PArgs a = {};
  a.coef = reinterpret_cast<const float4*>(coef);
  a.origin = origin;
  a.direction = direction;
  a.center = center;
  a.t_max = t_max;
  a.list = list;
  a.count = count;
  a.num_tiles = num_tiles;
  a.t_min = t_min;
  a.klo = klo;
  a.pre = pre;
  a.det_bound = det_bound;
  a.out_vis = out_vis;
  cudaError_t e = cudaMemsetAsync(count, 0, sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  k6_compact_kernel<K6PArgs><<<(num_rays + K6_COMPACT - 1) / K6_COMPACT, K6_COMPACT, 0, s>>>(
      a, num_rays, list, count);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return rays_per_thread == 1 ? launch_k6p<1>(a, num_rays, max_parts, resident, s)
                              : launch_k6p<2>(a, num_rays, max_parts, resident, s);
}

// K6''s scan blocks a multiprocessor holds at once at rays_per_thread, for
// the split; -1 on a bad argument.
extern "C" int hr_flash_visibility_blocks_per_sm(int rays_per_thread) {
  int blocks = 0;
  if (rays_per_thread != 1 && rays_per_thread != 2) return -1;
  const cudaError_t e =
      rays_per_thread == 1
          ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k6p_anyhit_kernel1, K6_BLOCK, 0)
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k6p_anyhit_kernel2, K6_BLOCK, 0);
  return e == cudaSuccess ? blocks : -1;
}

