// K1 (closest hit + attribute row) and K2 (any-hit visibility): one
// template, a lane per ray in batches of 32, walking the preorder
// skip-link BVH.
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
// lane and branches are cheap, so each lane runs the same stackless walk
// as the plain PyTorch version (ops/bvh.py traverse): slab test, descend
// on hit, skip link on miss or after a leaf, Moller-Trumbore on up to
// LEAF_SIZE triangles per leaf.
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

template <bool ANY_HIT>
__global__ void __launch_bounds__(BLOCK) trace_kernel(
    const float4* __restrict__ nodes, int num_nodes,
    const float4* __restrict__ tris, const float4* __restrict__ attr_table,
    int num_tris, const float* __restrict__ origin,
    const float* __restrict__ direction, const float* __restrict__ t_max,
    int num_rays, float t_min, float* __restrict__ out_t, float* __restrict__ out_u,
    float* __restrict__ out_v, int* __restrict__ out_id,
    float4* __restrict__ out_attrs, float* __restrict__ out_vis) {
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
  if (!ANY_HIT && dead_mask != 0u) {  // the zero rows of the dead, before the walk
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
      if (ANY_HIT && best_id >= 0) break;
      node = (hit_box && !is_leaf) ? node + 1 : skip;
    }
  }

  if (ANY_HIT) {
    if (valid) out_vis[r] = best_id >= 0 ? 0.0f : 1.0f;
    return;
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

}  // namespace

extern "C" int hr_trace_closest(
    const float* nodes, int num_nodes, const float* tris,
    const float* attr_table, int num_tris, const float* origin,
    const float* direction, const float* t_max, int num_rays, float t_min,
    float* out_t, float* out_u, float* out_v, int* out_id, float* out_attrs,
    void* stream) {
  if (num_rays <= 0) return (int)cudaGetLastError();
  trace_kernel<false><<<(num_rays + BLOCK - 1) / BLOCK, BLOCK, 0, (cudaStream_t)stream>>>(
      (const float4*)nodes, num_nodes, (const float4*)tris, (const float4*)attr_table,
      num_tris, origin, direction, t_max, num_rays, t_min, out_t, out_u, out_v, out_id,
      (float4*)out_attrs, nullptr);
  return (int)cudaGetLastError();
}

extern "C" int hr_trace_visibility(
    const float* nodes, int num_nodes, const float* tris, int num_tris,
    const float* origin, const float* direction, const float* t_max,
    int num_rays, float t_min, float* out_vis, void* stream) {
  if (num_rays <= 0) return (int)cudaGetLastError();
  trace_kernel<true><<<(num_rays + BLOCK - 1) / BLOCK, BLOCK, 0, (cudaStream_t)stream>>>(
      (const float4*)nodes, num_nodes, (const float4*)tris, nullptr, num_tris, origin,
      direction, t_max, num_rays, t_min, nullptr, nullptr, nullptr, nullptr, nullptr,
      out_vis);
  return (int)cudaGetLastError();
}
