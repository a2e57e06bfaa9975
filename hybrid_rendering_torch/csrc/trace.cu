// K1 (closest hit + attribute row) and K2 (any-hit visibility), a lane a
// ray. K1 walks the preorder skip-link BVH; K2, whose answer does not
// depend on the order of the walk, walks the same tree collapsed to 4
// children a node with a stack (its section below says why).
//
// Replaces the FlashTrace Pallas kernels of hybrid_rendering_tpu/ops/
// pallas/flashtrace.py: K1 = _loop_closest_kernel / _one_closest_packet
// (pallas_call at flashtrace.py:1358, entry flash_closest_hit_attrs_sparse
// :1708) and its v2 variant _sparse_closest_kernel (:1547); K2 =
// _loop_anyhit_kernel / _one_anyhit_packet (:1312, entry
// flash_visibility_sparse :1715) and _sparse_anyhit_kernel (:1506).
//
// The TPU kernels recast ray-triangle tests as bf16x3 MXU matmuls over
// ray packets x triangle clusters, with a packet/cluster culling prepass
// and overflow rounds, because the TPU has a matrix unit and no cheap
// per-lane branching. None of that carries over. On the H100 a ray is a
// lane and branches are cheap, so each lane of K1 runs the same stackless
// walk as the plain PyTorch version (ops/bvh.py traverse): slab test,
// descend on hit, skip link on miss or after a leaf, Moller-Trumbore on up
// to LEAF_SIZE triangles per leaf.
//
// What bounds it on the H100: the bound of K1 is bytes (the 96-byte
// attribute row is 2/3 of a ray's traffic), and the scenes are small
// (shadows_test: 2,498 triangles, ~150 KB of packed nodes and triangles),
// so the BVH stays in L1/L2 and the walk itself (about 23 box and 5
// triangle tests a primary ray) is bound by instruction rate under
// divergence and by load latency. What the design does about each:
//   - bytes: a warp copies the rows of its 32 rays together, lane l moving
//     16-byte piece l of the 32 x 6 pieces, so every store instruction
//     of the warp writes 512 consecutive bytes. Measured, this is the
//     larger half of the redesign's gain: a lane writing its own row in 24
//     4-byte stores touched every 32-byte sector eight times;
//   - instructions and latency: a node is two 16-byte records (min.xyz +
//     first|count, max.xyz + skip) and a triangle three (v0, e1, e2 with
//     the edges formed once, in fp32, when the scene is packed), read with
//     float4 __ldg, in place of nine dependent scalar loads each;
//   - idle lanes and tails: a warp takes 32 consecutive rays and the grid
//     is as large as that takes, so the card's block scheduler hands out
//     the work 128 rays at a time. A dead ray (t_max <= t_min: a miss,
//     visible) does not walk, and the warp writes the zero rows of its
//     dead rays before the others walk, so those stores overlap the walk
//     and a batch of mostly dead rays needs no compaction pass. Every
//     output is written by the ray's own index. Measured, a warp
//     that walks more than one batch (larger chunks, or a persistent grid
//     drawing from a counter or dealt out in turn) loses at every site:
//     one warp stays in an expensive region batch after batch while the
//     others wait.
//
// Rounding: the file is built with -fmad=false and every dot/cross is
// written in the same order as the plain version, so t, u, v follow it op
// by op; e1 and e2 are the same fp32 subtractions, done once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LEAF_SIZE = 4;  // ops/bvh.py LEAF_SIZE
constexpr int ATTR = 24;      // attribute row width (make_flash_scene layout)
constexpr int ROW4 = ATTR / 4;  // float4 pieces of a row
constexpr int BLOCK = 128;  // threads of a block: four warps of 32 rays
constexpr unsigned FULL = 0xffffffffu;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* __restrict__ p, int i) {
  return V3{__ldg(p + 3 * i), __ldg(p + 3 * i + 1), __ldg(p + 3 * i + 2)};
}
__device__ __forceinline__ V3 xyz(float4 a) { return V3{a.x, a.y, a.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return V3{a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ float dot3(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
  return V3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ float safe_inv(float d) {
  // bvh.py _safe_inv: |d| < 1e-12 -> +-1e-12 before the reciprocal
  float s = fabsf(d) < 1e-12f ? (d < 0.0f ? -1e-12f : 1e-12f) : d;
  return 1.0f / s;
}

__global__ void __launch_bounds__(BLOCK) closest_kernel(
    const float4* __restrict__ nodes, int num_nodes,
    const float4* __restrict__ tris, const float4* __restrict__ attr_table,
    int num_tris, const float* __restrict__ origin,
    const float* __restrict__ direction, const float* __restrict__ t_max,
    int num_rays, float t_min, float* __restrict__ out_t, float* __restrict__ out_u,
    float* __restrict__ out_v, int* __restrict__ out_id,
    float4* __restrict__ out_attrs) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * BLOCK + threadIdx.x;
  const int base = r - lane;  // the warp's first ray
  const bool valid = r < num_rays;

  // a dead ray (t_max <= t_min) misses and is visible (bvh.py traverse)
  float best_t = valid ? __ldg(t_max + r) : 0.0f;
  float best_u = 0.0f, best_v = 0.0f;
  int best_id = -1;
  const bool live = valid && !(best_t <= t_min);
  const unsigned dead_mask = __ballot_sync(FULL, valid && !live);
  if (dead_mask != 0u) {  // the zero rows of the dead, before the walk
#pragma unroll
    for (int j = 0; j < ROW4; ++j) {
      const int piece = j * 32 + lane;
      if ((dead_mask >> (piece / ROW4)) & 1u)
        out_attrs[(size_t)base * ROW4 + piece] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  if (live) {
    const V3 o = load3(origin, r);
    const V3 d = load3(direction, r);
    const V3 inv = V3{safe_inv(d.x), safe_inv(d.y), safe_inv(d.z)};

    int node = 0;
    while (node < num_nodes) {
      const float4 lo = __ldg(nodes + 2 * node);
      const float4 hi = __ldg(nodes + 2 * node + 1);
      const int first_count = __float_as_int(lo.w);
      const int skip = __float_as_int(hi.w);

      // _slab_test: inclusive tnear <= tfar, clipped to t_min / running best
      const float t0x = (lo.x - o.x) * inv.x, t1x = (hi.x - o.x) * inv.x;
      const float t0y = (lo.y - o.y) * inv.y, t1y = (hi.y - o.y) * inv.y;
      const float t0z = (lo.z - o.z) * inv.z, t1z = (hi.z - o.z) * inv.z;
      const float tnear = fmaxf(fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                                      fminf(t0z, t1z)), t_min);
      const float tfar = fminf(fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                                     fmaxf(t0z, t1z)), best_t);
      const bool hit_box = tnear <= tfar;
      const int count_tris = first_count & 7;
      const bool is_leaf = count_tris > 0;

      if (hit_box && is_leaf) {
        // _moller_leaf: |det| > 1e-9, t > t_min, strict t < best_t; lanes in
        // order, so the first of equal minima wins (argmin semantics)
        const int first = first_count >> 3;
        const int n = count_tris < LEAF_SIZE ? count_tris : LEAF_SIZE;
        for (int k = 0; k < n; ++k) {
          int idx = first + k;
          idx = idx > num_tris - 1 ? num_tris - 1 : idx;
          const V3 v0 = xyz(__ldg(tris + 3 * idx));
          const V3 e1 = xyz(__ldg(tris + 3 * idx + 1));
          const V3 e2 = xyz(__ldg(tris + 3 * idx + 2));
          const V3 pvec = cross3(d, e2);
          const float det = dot3(pvec, e1);
          const bool det_ok = fabsf(det) > 1e-9f;
          const float inv_det = det_ok ? 1.0f / det : 0.0f;
          const V3 tvec = sub(o, v0);
          const float u = dot3(tvec, pvec) * inv_det;
          const V3 qvec = cross3(tvec, e1);
          const float v = dot3(d, qvec) * inv_det;
          const float t = dot3(e2, qvec) * inv_det;
          const bool ok = det_ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
                          t > t_min && t < best_t;
          if (ok) {
            best_t = t;
            best_id = idx;
            best_u = u;
            best_v = v;
          }
        }
      }
      node = (hit_box && !is_leaf) ? node + 1 : skip;
    }
  }

  if (valid) {
    out_t[r] = best_t;
    out_u[r] = best_u;
    out_v[r] = best_v;
    out_id[r] = best_id;
  }
  // the warp's 32 rows are 192 consecutive 16-byte pieces: lane l moves
  // pieces l, l + 32, ..., each the part `piece % 6` of row `piece / 6`
#pragma unroll
  for (int j = 0; j < ROW4; ++j) {
    const int piece = j * 32 + lane;
    const int row = piece / ROW4, part = piece - row * ROW4;
    const int id = __shfl_sync(FULL, best_id, row);
    if (base + row < num_rays && !((dead_mask >> row) & 1u)) {
      out_attrs[(size_t)base * ROW4 + piece] =
          id >= 0 ? __ldg(attr_table + (size_t)id * ROW4 + part)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// ---------------------------------------------------------------------------
// K2: any-hit visibility
// ---------------------------------------------------------------------------
//
// Any-hit asks whether some triangle blocks the ray within (t_min, t_max).
// The far bound never shrinks, so a leaf's triangles are tested iff the ray
// hits the leaf's box and every box above it, and since a child's box lies
// inside its parent's and the slab test rounds monotonically, that is: iff
// it hits the leaf's box. The answer is an OR over leaves and depends
// neither on the order nor on the width of the walk. K2 therefore walks
// its own tree, the binary BVH collapsed to 4 children a node (ops/bvh.py
// pack_wide_nodes), with a stack a lane, and stays bit-identical to the
// plain walk: the slab and Moller-Trumbore arithmetic are K1's.
//
// What bounds it: the 2.6 million shadow and AO rays of the bench frame
// need few steps each (15 box and 0.7 triangle tests of the binary walk a
// live ray), and their launch behaves as bound by instruction rate:
// occupancy, block size, the order of the ray loads and the L1 carve-out
// move nothing, less work a step does; the leaf tests weigh most, since
// they run for a whole warp whenever one lane stands on a leaf. The probe
// and reflection-hit launches (148 to 518 thousand rays, under 4 box tests
// a ray on average) fill the card for a few waves at most, and their time
// is the warp with the longest walk, a chain of loads and arithmetic that
// nothing overlaps once the warp runs alone. Against both, a node step
// tests 4 boxes from seven 16-byte loads started together (half the steps
// of the binary walk, no step spent on a box that is missed), the last
// child entered stays in a register, and the leaf test comes in two forms
// chosen by the size of the batch: small batches load a leaf's 4 slots
// together, test them side by side and compute v and t only where u can
// still pass (the shortest path for the longest warp, 72 registers);
// large batches test the leaf's own triangles in turn (48 registers, more
// warps).

constexpr int WIDE_REC = 7;             // 16-byte records of a node (pack_wide_nodes)
constexpr int STACK = 64;               // ops/bvh.py WIDE_STACK
constexpr int EMPTY = (int)0x80000000;  // ops/bvh.py WIDE_EMPTY
// rays up to which the side-by-side leaf test is used. Measured on the
// bench frame's rays: it is ahead up to ~500 thousand rays (131 thousand
// shadow rays 0.0106 against 0.0114 ms, the probe and reflection-hit
// launches 0.020 to 0.025 against 0.025 to 0.027), level at 524 thousand
// shadow rays and behind from a million on (0.032 against 0.030 ms)
constexpr int SMALL_BATCH = 1 << 19;

struct Ray {
  V3 o, d, inv;
  float t_max;
};

// _slab_test against [t_min, t_max]: K2's far bound never shrinks
__device__ __forceinline__ bool slab(float lox, float loy, float loz, float hix, float hiy,
                                     float hiz, const Ray& ray, float t_min) {
  const float t0x = (lox - ray.o.x) * ray.inv.x, t1x = (hix - ray.o.x) * ray.inv.x;
  const float t0y = (loy - ray.o.y) * ray.inv.y, t1y = (hiy - ray.o.y) * ray.inv.y;
  const float t0z = (loz - ray.o.z) * ray.inv.z, t1z = (hiz - ray.o.z) * ray.inv.z;
  const float tnear = fmaxf(fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                                  fminf(t0z, t1z)), t_min);
  const float tfar = fminf(fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                                 fmaxf(t0z, t1z)), ray.t_max);
  return tnear <= tfar;
}

// _moller in two steps. The first: det, its reciprocal and u; false where
// the triangle cannot block the ray (v >= 0 and u + v <= 1 need u <= 1)
struct Partial {
  float inv_det, u;
  V3 tvec;
};

__device__ __forceinline__ bool moller_u(V3 v0, V3 e1, V3 e2, const Ray& ray, Partial& m) {
  const V3 pvec = cross3(ray.d, e2);
  const float det = dot3(pvec, e1);
  const bool det_ok = fabsf(det) > 1e-9f;
  m.inv_det = det_ok ? 1.0f / det : 0.0f;
  m.tvec = sub(ray.o, v0);
  m.u = dot3(m.tvec, pvec) * m.inv_det;
  return det_ok && m.u >= 0.0f && m.u <= 1.0f;
}

// the second: v and t, and the rest of the test
__device__ __forceinline__ bool moller_vt(V3 e1, V3 e2, const Partial& m, const Ray& ray,
                                          float t_min) {
  const V3 qvec = cross3(m.tvec, e1);
  const float v = dot3(ray.d, qvec) * m.inv_det;
  const float t = dot3(e2, qvec) * m.inv_det;
  return v >= 0.0f && m.u + v <= 1.0f && t > t_min && t < ray.t_max;
}

// does a triangle of the leaf `first_count` (first_tri * 8 + count) block the ray?
template <bool SIDE_BY_SIDE>
__device__ __forceinline__ bool leaf_blocks(const float4* __restrict__ tris, int num_tris,
                                            int first_count, const Ray& ray, float t_min) {
  const int first = first_count >> 3;
  const int n = first_count & 7;
  bool blocked = false;
  if (SIDE_BY_SIDE) {
    // all LEAF_SIZE slots in flight at once (a slot past the leaf's count
    // reads a clamped index and does not count): every load, then every
    // first step, then the second steps if any slot is still open
    V3 v0[LEAF_SIZE], e1[LEAF_SIZE], e2[LEAF_SIZE];
    Partial m[LEAF_SIZE];
    bool open[LEAF_SIZE];
    bool any_open = false;
#pragma unroll
    for (int k = 0; k < LEAF_SIZE; ++k) {
      const int idx = min(first + k, num_tris - 1);
      v0[k] = xyz(__ldg(tris + 3 * idx));
      e1[k] = xyz(__ldg(tris + 3 * idx + 1));
      e2[k] = xyz(__ldg(tris + 3 * idx + 2));
    }
#pragma unroll
    for (int k = 0; k < LEAF_SIZE; ++k) {
      open[k] = moller_u(v0[k], e1[k], e2[k], ray, m[k]) && k < n;
      any_open |= open[k];
    }
    if (any_open) {
#pragma unroll
      for (int k = 0; k < LEAF_SIZE; ++k)
        blocked |= open[k] && moller_vt(e1[k], e2[k], m[k], ray, t_min);
    }
  } else {
#pragma unroll
    for (int k = 0; k < LEAF_SIZE; ++k) {
      if (k < n) {
        const int idx = min(first + k, num_tris - 1);
        const V3 v0 = xyz(__ldg(tris + 3 * idx));
        const V3 e1 = xyz(__ldg(tris + 3 * idx + 1));
        const V3 e2 = xyz(__ldg(tris + 3 * idx + 2));
        Partial m;
        const bool open = moller_u(v0, e1, e2, ray, m);
        blocked |= moller_vt(e1, e2, m, ray, t_min) && open;
      }
    }
  }
  return blocked;
}

// The walk. An entry is a node (>= 0) or a leaf (~(first_tri * 8 + count));
// a node tests its 4 child boxes and yields the children the ray enters
// (an unused slot: none), a leaf tests its triangles and ends the walk if
// one blocks the ray. The last child entered stays in a register, the
// others wait on the lane's stack.
template <bool SIDE_BY_SIDE>
__global__ void __launch_bounds__(BLOCK) anyhit_kernel(
    const float4* __restrict__ wide, int num_wide, const float4* __restrict__ tris,
    int num_tris, const float* __restrict__ origin, const float* __restrict__ direction,
    const float* __restrict__ t_max, int num_rays, float t_min, float* __restrict__ out_vis) {
  const int r = blockIdx.x * BLOCK + threadIdx.x;
  if (r >= num_rays) return;
  // a dead ray (t_max <= t_min) is visible and does not walk (bvh.py traverse)
  Ray ray;
  ray.t_max = __ldg(t_max + r);
  bool blocked = false;
  if (!(ray.t_max <= t_min) && num_wide > 0) {
    ray.o = load3(origin, r);
    ray.d = load3(direction, r);
    ray.inv = V3{safe_inv(ray.d.x), safe_inv(ray.d.y), safe_inv(ray.d.z)};
    int stack[STACK];
    int sp = 0;
    int cur = 0;  // the root
    while (cur != EMPTY) {
      int next = EMPTY;
      if (cur >= 0) {
        const float4* rec = wide + WIDE_REC * cur;
        const float4 lox = __ldg(rec), loy = __ldg(rec + 1), loz = __ldg(rec + 2);
        const float4 hix = __ldg(rec + 3), hiy = __ldg(rec + 4), hiz = __ldg(rec + 5);
        const float4 word = __ldg(rec + 6);
#define HR_CHILD(c)                                                              \
  if (__float_as_int(word.c) != EMPTY &&                                         \
      slab(lox.c, loy.c, loz.c, hix.c, hiy.c, hiz.c, ray, t_min)) {              \
    if (next != EMPTY) stack[sp++] = next;                                       \
    next = __float_as_int(word.c);                                               \
  }
        HR_CHILD(x) HR_CHILD(y) HR_CHILD(z) HR_CHILD(w)
#undef HR_CHILD
      } else if (leaf_blocks<SIDE_BY_SIDE>(tris, num_tris, ~cur, ray, t_min)) {
        blocked = true;
        break;
      }
      if (next == EMPTY && sp > 0) next = stack[--sp];
      cur = next;
    }
  }
  out_vis[r] = blocked ? 0.0f : 1.0f;
}

// a launch that does no work: the card's floor for any kernel
__global__ void noop_kernel() {}

}  // namespace

extern "C" int hr_trace_closest(
    const float* nodes, int num_nodes, const float* tris,
    const float* attr_table, int num_tris, const float* origin,
    const float* direction, const float* t_max, int num_rays, float t_min,
    float* out_t, float* out_u, float* out_v, int* out_id, float* out_attrs,
    void* stream) {
  if (num_rays <= 0) return (int)cudaGetLastError();
  closest_kernel<<<(num_rays + BLOCK - 1) / BLOCK, BLOCK, 0, (cudaStream_t)stream>>>(
      (const float4*)nodes, num_nodes, (const float4*)tris, (const float4*)attr_table,
      num_tris, origin, direction, t_max, num_rays, t_min, out_t, out_u, out_v, out_id,
      (float4*)out_attrs);
  return (int)cudaGetLastError();
}

extern "C" int hr_trace_visibility(
    const float* wide, int num_wide, const float* tris, int num_tris,
    const float* origin, const float* direction, const float* t_max,
    int num_rays, float t_min, float* out_vis, void* stream) {
  if (num_rays <= 0) return (int)cudaGetLastError();
  auto kernel = num_rays <= SMALL_BATCH ? anyhit_kernel<true> : anyhit_kernel<false>;
  kernel<<<(num_rays + BLOCK - 1) / BLOCK, BLOCK, 0, (cudaStream_t)stream>>>(
      (const float4*)wide, num_wide, (const float4*)tris, num_tris, origin, direction, t_max,
      num_rays, t_min, out_vis);
  return (int)cudaGetLastError();
}

extern "C" int hr_noop(void* stream) {
  noop_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
