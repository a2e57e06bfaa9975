// K5: DDGI irradiance at points (p, n, wo) from the probe atlases. One
// thread per point walks the 8 corners of the point's probe cage.
//
// Replaces _make_kernel / _sample_tiles_call of hybrid_rendering_tpu/ops/
// pallas/ddgi_sample.py (pallas_call at ddgi_sample.py:537, entry
// make_fast_sampler :562). It computes the exact per-point
// models/ddgi.sample_irradiance (hybrid_rendering_tpu/models/ddgi.py:223),
// not the Pallas kernel's approximations: no tile windows, no rescue pass,
// no clamped depth taps, no half-resolution depth atlas, and the bilinear
// blend is taken before the sqrt, not after.
//
// The TPU kernel exists because per-point gathers are slow there: it
// stages a window of probes per tile of points in VMEM and selects taps
// with one-hot matmuls. On the H100 a gather is a load. Each corner reads
// 4 wrapped bilinear taps of the depth atlas (2 channels) and 4 of the
// irradiance atlas (3 channels) straight from global memory. At the bench
// grid (1,156 probes) the two atlases are 0.3 MB + 2.4 MB and stay in the
// 50 MB L2. Measured, the kernel is bound by instruction rate first (more
// lanes a point, which repeat the point's set-up, are slower, and so is
// anything that adds work) and, for points that lie apart (the probe rays'
// hit points), by the gathers' traffic from L2. Most of a corner's work is
// IEEE divisions and square roots that the plain version's rounding
// needs. The design: one thread a point, the point's state in registers,
// loads through the read-only path (__ldg); everything that depends on
// the point alone is done once and not once a corner (the normal's
// octahedral taps and bilinear fractions in the irradiance atlas: a third
// of a corner's work); taps that fall inside a probe's tile skip the two
// wrap passes; the direction's length and the distance share one square
// root.
//
// Every cell and texel index is clamped, and floor() of a non-finite
// coordinate counts as 0 before the clamp, so the points of missed probe
// rays (whose outputs the caller masks) never read out of bounds.
//
// Rounding: built with -fmad=false and written in the plain version's
// operation order (models/ddgi.py sample_irradiance, oct_bilinear_sample,
// ops/octahedral.py; dots summed left to right as math3d.dot3), so the two
// agree bit for bit. It stays so on purpose: where every ray of a depth
// texel missed, its variance |mean^2 - mean2| is rounding noise, and the
// Chebyshev weight variance / (variance + d^2) turns an ulp of that noise
// into 1e-3 of irradiance, so reciprocal multiplies and approximate roots
// in the visibility chain do not hold a tolerance (measured: 2.6e-3), and
// loosening only the rest buys under 10%.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BLOCK = 128;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* __restrict__ a, int i) {
  return V3{__ldg(a + 3 * i), __ldg(a + 3 * i + 1), __ldg(a + 3 * i + 2)};
}

__device__ __forceinline__ float dot3(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

__device__ __forceinline__ V3 normalize3(V3 v) {
  const float l = sqrtf(fmaxf(dot3(v, v), 1e-20f));
  return V3{v.x / l, v.y / l, v.z / l};
}

__device__ __forceinline__ float finite_floor(float x) {
  const float f = floorf(x);
  return isfinite(f) ? f : 0.0f;
}

__device__ __forceinline__ float sign_not_zero(float v) { return v >= 0.0f ? 1.0f : -1.0f; }

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// models/ddgi.py _wrap_oct_coords: two mirror passes, then a clamp
__device__ __forceinline__ void wrap_once(int& x, int& y, int side) {
  if (x < 0) { x = -x - 1; y = side - 1 - y; }
  if (x > side - 1) { x = 2 * side - 1 - x; y = side - 1 - y; }
  if (y < 0) { y = -y - 1; x = side - 1 - x; }
  if (y > side - 1) { y = 2 * side - 1 - y; x = side - 1 - x; }
}

__device__ __forceinline__ int texel(int x, int y, int side) {
  wrap_once(x, y, side);
  wrap_once(x, y, side);
  return clampi(y, 0, side - 1) * side + clampi(x, 0, side - 1);
}

// The four wrapped taps of models/ddgi.py oct_bilinear_sample for one
// direction: texel offsets within a probe's tile (in texels) and the
// bilinear fractions. They depend on the direction only, not on the probe.
struct Taps {
  int t00, t10, t01, t11;
  float fx, fy, ax, ay;
};

__device__ __forceinline__ Taps oct_taps(V3 d, int side) {
  // ops/octahedral.py direction_to_octahedral
  const float denom = fmaxf(fabsf(d.x) + fabsf(d.y) + fabsf(d.z), 1e-8f);
  float ox = d.x / denom, oy = d.y / denom;
  if (d.z < 0.0f) {
    const float fx = (1.0f - fabsf(oy)) * sign_not_zero(ox);
    const float fy = (1.0f - fabsf(ox)) * sign_not_zero(oy);
    ox = fx;
    oy = fy;
  }
  const float tx = (ox * 0.5f + 0.5f) * (float)side - 0.5f;
  const float ty = (oy * 0.5f + 0.5f) * (float)side - 0.5f;
  Taps t;
  t.fx = tx - floorf(tx);
  t.fy = ty - floorf(ty);
  t.ax = 1.0f - t.fx;
  t.ay = 1.0f - t.fy;
  const int x0 = (int)finite_floor(tx), y0 = (int)finite_floor(ty);
  if ((unsigned)x0 < (unsigned)(side - 1) && (unsigned)y0 < (unsigned)(side - 1)) {
    // all four taps inside the tile: nothing wraps
    t.t00 = y0 * side + x0;
    t.t10 = t.t00 + 1;
    t.t01 = t.t00 + side;
    t.t11 = t.t01 + 1;
  } else {
    t.t00 = texel(x0, y0, side);
    t.t10 = texel(x0 + 1, y0, side);
    t.t01 = texel(x0, y0 + 1, side);
    t.t11 = texel(x0 + 1, y0 + 1, side);
  }
  return t;
}

// the bilinear blend of a probe's tile at those taps, each product taken
// left to right as the plain version takes it
template <int C>
__device__ __forceinline__ void oct_blend(const float* __restrict__ atlas, int side, int probe,
                                          const Taps& t, float* out) {
  const float* base = atlas + (size_t)probe * side * side * C;
  const float* t00 = base + C * t.t00;
  const float* t10 = base + C * t.t10;
  const float* t01 = base + C * t.t01;
  const float* t11 = base + C * t.t11;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    out[c] = __ldg(t00 + c) * t.ax * t.ay + __ldg(t10 + c) * t.fx * t.ay +
             __ldg(t01 + c) * t.ax * t.fy + __ldg(t11 + c) * t.fx * t.fy;
  }
}

struct Grid {
  int cx, cy, cz;
  float sx, sy, sz;  // start
  float tx, ty, tz;  // step
};

__device__ __forceinline__ int cell(float p, float start, float step, int count) {
  const float f = finite_floor((p - start) / step);
  return (int)fminf(fmaxf(f, 0.0f), (float)(count - 1));
}

__global__ void __launch_bounds__(BLOCK) ddgi_sample_kernel(
    const float* __restrict__ irr_atlas, const float* __restrict__ depth_atlas, int irr_side,
    int depth_side, Grid g, float normal_bias, float energy, int visibility_test,
    const float* __restrict__ p_in, const float* __restrict__ n_in,
    const float* __restrict__ wo_in, int num_points, float* __restrict__ out) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= num_points) return;
  const V3 p = load3(p_in, i), n = load3(n_in, i), wo = load3(wo_in, i);

  const int bx = cell(p.x, g.sx, g.tx, g.cx);
  const int by = cell(p.y, g.sy, g.ty, g.cy);
  const int bz = cell(p.z, g.sz, g.tz, g.cz);
  const V3 base_pos{g.sx + (float)bx * g.tx, g.sy + (float)by * g.ty, g.sz + (float)bz * g.tz};
  const V3 alpha{fminf(fmaxf((p.x - base_pos.x) / g.tx, 0.0f), 1.0f),
                 fminf(fmaxf((p.y - base_pos.y) / g.ty, 0.0f), 1.0f),
                 fminf(fmaxf((p.z - base_pos.z) / g.tz, 0.0f), 1.0f)};
  const V3 bias{(n.x + 3.0f * wo.x) * normal_bias, (n.y + 3.0f * wo.y) * normal_bias,
                (n.z + 3.0f * wo.z) * normal_bias};
  // the normal's taps in the irradiance atlas: the same for all 8 probes
  const Taps irr_taps = oct_taps(n, irr_side);

  float sum_irr[3] = {0.0f, 0.0f, 0.0f};
  float sum_w = 0.0f;
#pragma unroll 1
  for (int c = 0; c < 8; ++c) {
    const int ox = c & 1, oy = (c >> 1) & 1, oz = (c >> 2) & 1;
    const int qx = min(bx + ox, g.cx - 1), qy = min(by + oy, g.cy - 1), qz = min(bz + oz, g.cz - 1);
    const int probe = qx + qy * g.cx + qz * (g.cx * g.cy);
    const V3 probe_pos{g.sx + (float)qx * g.tx, g.sy + (float)qy * g.ty, g.sz + (float)qz * g.tz};

    const V3 ptp{(p.x - probe_pos.x) + bias.x, (p.y - probe_pos.y) + bias.y,
                 (p.z - probe_pos.z) + bias.z};
    const float tri_w = (ox ? alpha.x : 1.0f - alpha.x) * (oy ? alpha.y : 1.0f - alpha.y) *
                        (oz ? alpha.z : 1.0f - alpha.z);

    // wrap-shaded backface (gi_common.glsl:252)
    const V3 true_dir = normalize3(V3{probe_pos.x - p.x, probe_pos.y - p.y, probe_pos.z - p.z});
    const float b = fmaxf((dot3(true_dir, n) + 1.0f) * 0.5f, 1e-4f);
    float w = b * b + 0.2f;

    if (visibility_test) {
      // normalize3(-ptp) and the distance share one square root: the two
      // clamps (1e-20, 1e-12) differ only below 1e-12
      const float dd = dot3(ptp, ptp);
      const float len = sqrtf(fmaxf(dd, 1e-20f));
      const float dist = dd >= 1e-12f ? len : sqrtf(1e-12f);
      // the depth direction -normalize3(-ptp): negation is exact
      const V3 from_probe{ptp.x / len, ptp.y / len, ptp.z / len};
      float temp[2];
      oct_blend<2>(depth_atlas, depth_side, probe, oct_taps(from_probe, depth_side), temp);
      const float mean = temp[0];
      const float variance = fabsf(mean * mean - temp[1]);
      const float d = fmaxf(dist - mean, 0.0f);
      float cheb = variance / (variance + d * d + 1e-12f);
      cheb = fmaxf(cheb * cheb * cheb, 0.0f);
      w = w * (dist <= mean ? 1.0f : cheb);
    }

    w = fmaxf(w, 1e-6f);
    // crush tiny weights (gi_common.glsl:288-291)
    if (w < 0.2f) w = w * w * w / 0.04f;
    w = w * tri_w;

    float irr[3];
    oct_blend<3>(irr_atlas, irr_side, probe, irr_taps, irr);
#pragma unroll
    for (int k = 0; k < 3; ++k) sum_irr[k] = sum_irr[k] + w * sqrtf(fmaxf(irr[k], 0.0f));
    sum_w = sum_w + w;
  }

  const float norm = fmaxf(sum_w, 1e-9f);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float net = sum_irr[k] / norm;
    out[3 * i + k] = net * net * energy;
  }
}

}  // namespace

extern "C" int hr_ddgi_sample(const float* irr_atlas, const float* depth_atlas, int irr_side,
                              int depth_side, int cx, int cy, int cz, float sx, float sy,
                              float sz, float tx, float ty, float tz, float normal_bias,
                              float energy, int visibility_test, const float* p,
                              const float* n, const float* wo, int num_points, float* out,
                              void* stream) {
  if (cx < 1 || cy < 1 || cz < 1 || irr_side < 1 || depth_side < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (num_points > 0) {
    const Grid g{cx, cy, cz, sx, sy, sz, tx, ty, tz};
    ddgi_sample_kernel<<<(num_points + BLOCK - 1) / BLOCK, BLOCK, 0, (cudaStream_t)stream>>>(
        irr_atlas, depth_atlas, irr_side, depth_side, g, normal_bias, energy, visibility_test,
        p, n, wo, num_points, out);
  }
  return (int)cudaGetLastError();
}
