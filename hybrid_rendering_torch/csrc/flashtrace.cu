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
// (ray tile, triangle tile) grid step, keep a running argmin in VMEM and
// select the winner's attribute row with a one-hot matmul. Here a ray is a
// thread with its 10 features [o - center, d, (o - center) x d, 1] in
// registers. The block stages a tile of 128 triangles' 19 non-zero
// coefficients (20 floats a triangle, 10 KB) in shared memory and every
// thread loops over it, reading each coefficient as a broadcast. The
// closest hit keeps the running best with a strict '<', so the lowest
// index wins a tie, and reads the winner's attribute row once at the end
// (the one-hot select is a gather here). K6' stops a ray at its first hit
// and the block at the first tile where none of its rays is still
// searching. K6' runs flash_kernel<true, false> below as ported; K6 runs
// k6_closest_kernel, its redesign for the H100 (further down: pre-tests
// without the reciprocal, several rays a thread, whole tiles, live rays
// compacted, the triangles split where the rays are few).
//
// What bounds it: fp32 operations. To save work without changing a
// result, a pair computes t_num only where |det| > 1e-9, and u and v only
// where t_min < t < best; the acceptance is the plain version's. So a
// tested pair costs its det and the |det| test (6 operations), a pair with
// |det| > 1e-9 the reciprocal, t and its two compares (11 more), and a
// pair whose t passes u, v and their three tests (28 more); chip_smoke.py
// counts these on each run's rays. The bytes (a ray's 40 bytes of
// features and 4 of t_max in, 16 or 112 out; the scene's 80 bytes a
// triangle, resident in L2) are a few hundred MB.
//
// Rounding: built with -fmad=false; each scalar is summed left to right
// over the non-zero features as ops/flashtrace.py _affine sums it, the
// reciprocal is correctly rounded (__frcp_rn = 1.0f / det) and t, u, v
// are products with it, so the kernel matches the plain version bit for
// bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 128;  // rays per block, one per thread
constexpr int TILE = 128;   // triangles staged per pass
constexpr int FEAT = 10;    // ops/flashtrace.py FEAT
constexpr int COEF4 = 5;    // a triangle's 20 coefficients as 5 float4
constexpr int ATTR = 24;    // attribute row width

// Coefficient record of one triangle (ops/flashtrace.py make_flash_scene
// coef): [det: d0 d1 d2 | t: o0 o1 o2 1 | u: d0 d1 d2 m0 m1 m2 |
//         v: d0 d1 d2 m0 m1 m2 | pad]
template <bool ANY_HIT, bool WITH_ATTRS>
__global__ void __launch_bounds__(BLOCK) flash_kernel(
    const float4* __restrict__ coef, int num_tris, const float* __restrict__ attr_table,
    const float* __restrict__ feats, const float* __restrict__ t_max, int num_rays,
    float t_min, float* __restrict__ out_t, float* __restrict__ out_u,
    float* __restrict__ out_v, int* __restrict__ out_id, float* __restrict__ out_attrs,
    float* __restrict__ out_vis) {
  __shared__ float4 tile[TILE][COEF4];

  const int r = blockIdx.x * BLOCK + threadIdx.x;
  const bool in_range = r < num_rays;
  float f[FEAT];
  float tmax = 0.0f;
#pragma unroll
  for (int k = 0; k < FEAT; ++k) f[k] = in_range ? __ldg(feats + (size_t)r * FEAT + k) : 0.0f;
  if (in_range) tmax = __ldg(t_max + r);

  float best = tmax;
  float best_u = 0.0f, best_v = 0.0f;
  int best_id = -1;
  // a ray with t_max <= t_min has no acceptable t: it searches nothing
  // (and K6' reports it blocked, flashtrace.py:323)
  bool live = in_range && tmax > t_min;
  const bool budget = live;

  for (int base = 0; base < num_tris; base += TILE) {
    // barrier before the tile is overwritten; ends the block's loop once
    // none of its rays is searching
    if (!__syncthreads_or(live)) break;
    const int n = min(TILE, num_tris - base);
    if (threadIdx.x < n) {
      const float4* src = coef + (size_t)(base + threadIdx.x) * COEF4;
#pragma unroll
      for (int c = 0; c < COEF4; ++c) tile[threadIdx.x][c] = __ldg(src + c);
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < n; ++j) {
      const float4 a = tile[j][0];  // det d0 d1 d2, t o0
      const float det = (f[3] * a.x + f[4] * a.y) + f[5] * a.z;
      if (!(fabsf(det) > 1e-9f)) continue;
      const float4 b = tile[j][1];  // t o1 o2 1, u d0
      const float inv_det = __frcp_rn(det);
      const float t = (((f[0] * a.w + f[1] * b.x) + f[2] * b.y) + f[9] * b.z) * inv_det;
      if (!(t > t_min && t < best)) continue;
      const float4 c = tile[j][2];  // u d1 d2 m0 m1
      const float4 e = tile[j][3];  // u m2, v d0 d1 d2
      const float4 g = tile[j][4];  // v m0 m1 m2, pad
      const float u = (((((f[3] * b.w + f[4] * c.x) + f[5] * c.y) + f[6] * c.z) +
                        f[7] * c.w) + f[8] * e.x) * inv_det;
      const float v = (((((f[3] * e.y + f[4] * e.z) + f[5] * e.w) + f[6] * g.x) +
                        f[7] * g.y) + f[8] * g.z) * inv_det;
      if (u >= 0.0f && v >= 0.0f && u + v <= 1.0f) {
        if (ANY_HIT) {
          live = false;
          break;
        }
        best = t;
        best_u = u;
        best_v = v;
        best_id = base + j;
      }
    }
  }
  if (!in_range) return;

  if (ANY_HIT) {
    out_vis[r] = (budget && live) ? 1.0f : 0.0f;
    return;
  }
  out_t[r] = best;
  out_u[r] = best_u;
  out_v[r] = best_v;
  out_id[r] = best_id;
  if (WITH_ATTRS) {
    float* row = out_attrs + (size_t)r * ATTR;
    if (best_id >= 0) {
      const float* src = attr_table + (size_t)best_id * ATTR;
#pragma unroll
      for (int k = 0; k < ATTR; ++k) row[k] = __ldg(src + k);
    } else {
#pragma unroll
      for (int k = 0; k < ATTR; ++k) row[k] = 0.0f;
    }
  }
}

inline int grid_for(int n) { return (n + BLOCK - 1) / BLOCK; }

// ---------------------------------------------------------------------------
// K6, redesigned for the H100 (K6' above still runs flash_kernel<true, false>)
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
// get neighbouring rays; a dead ray's miss written here (t = t_max, u = v
// = 0, tri_id -1, a zero row), a live ray's merge key set to a miss.
constexpr int K6_COMPACT = 1024;

__global__ void __launch_bounds__(K6_COMPACT) k6_compact_kernel(const K6Args a, int num_rays,
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
    a.keys[r] = K6_MISS;
  } else if (r < num_rays) {
    k6_write(a, r, tm, 0.0f, 0.0f, -1);
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
  k6_compact_kernel<<<(num_rays + K6_COMPACT - 1) / K6_COMPACT, K6_COMPACT, 0, s>>>(
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

// K6': 1.0 unoccluded, 0.0 blocked (and for t_max <= t_min).
extern "C" int hr_flash_visibility(const float* coef, int num_tris, const float* feats,
                                   const float* t_max, int num_rays, float t_min,
                                   float* out_vis, void* stream) {
  if (num_rays > 0) {
    flash_kernel<true, false><<<grid_for(num_rays), BLOCK, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(coef), num_tris, nullptr, feats, t_max, num_rays,
        t_min, nullptr, nullptr, nullptr, nullptr, nullptr, out_vis);
  }
  return (int)cudaGetLastError();
}
