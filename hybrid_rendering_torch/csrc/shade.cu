// K7: the direct light of a batch of surface points (ops/lighting.py
// direct_lighting), split at its one visibility query into two kernels:
//
//   K7a shade_rays_kernel: each point's shadow ray toward the light (soft
//     shadows: the light's direction perturbed in a disk), the light's
//     attenuation (falloff times the clamped N.Wi) and, with a sky sample,
//     a cosine-lobe sky ray written N rows after it. A ray whose point is
//     not valid, or whose attenuation is not > 0, gets t_max = 0: the
//     plain version discards its visibility (att * where(att > 0, vis, 0)),
//     so the early-out is exact.
//   K7b shade_combine_kernel: both uber-BRDF terms (brdf.glsl) of each
//     point, weighted by the visibilities the tracer answered, the light's
//     radiance and the path throughput. The sky's radiance is either the
//     ProceduralSky of ops/sky.py, evaluated here from its sun direction and
//     intensity, or a radiance the caller computed on K7a's sky directions.
//
// It replaces no TPU kernel: the JAX package leaves direct_lighting to XLA,
// which fuses it. Run eagerly, its plain PyTorch version is ~220 launches
// and 8 blocking copies of host-made constants a call; on the 2.07M-point
// wavefront each launch streams 8-25 MB. Both kernels are bound by bytes
// (~213 bytes a point with a throughput and a sky sample: the inputs read
// once, the rays and results written once) and do ~300 fp32 operations a
// point, so the design is one thread a point, everything in registers,
// inputs through the read-only path, and no shared memory.
//
// Rounding: built with -fmad=false and written in the plain version's
// operation order as PyTorch evaluates it on the card, so the two agree
// bit for bit: torch.sum(a * b, -1) over three terms adds (x + z) + y;
// torch.linalg.cross fuses its first product, fma(a1, b2, -(a2 * b1));
// a tensor divided by a Python number is multiplied by the float
// reciprocal; clamp keeps a NaN; sqrtf, cosf, sinf, expf and powf are the
// functions PyTorch's kernels call. A Python number is the float nearest
// to the double, so constants are written as (float)<double>.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;

// types.py LIGHT_TYPE_*
constexpr int LIGHT_DIRECTIONAL = 0;
constexpr int LIGHT_POINT = 1;

// sky modes of K7b: no sky sample, ProceduralSky here, a given radiance
constexpr int SKY_NONE = 0;
constexpr int SKY_PROCEDURAL = 1;
constexpr int SKY_GIVEN = 2;

constexpr float PI_F = (float)3.141592653589793;  // math.pi
constexpr float TWO_PI_F = (float)6.283185307179586;  // 2.0 * math.pi in Python
constexpr float INV_PI_F = 1.0f / PI_F;  // x / math.pi on the card
constexpr float EPS = (float)1e-4;  // math3d.EPSILON

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* __restrict__ a, int64_t i) {
  return V3{__ldg(a + 3 * i), __ldg(a + 3 * i + 1), __ldg(a + 3 * i + 2)};
}

__device__ __forceinline__ void store3(float* __restrict__ a, int64_t i, V3 v) {
  a[3 * i] = v.x;
  a[3 * i + 1] = v.y;
  a[3 * i + 2] = v.z;
}

// math3d.dot (torch.sum of the products over the last axis) on the card
__device__ __forceinline__ float dot(V3 a, V3 b) {
  const float x = a.x * b.x, y = a.y * b.y, z = a.z * b.z;
  return (x + z) + y;
}

// torch.linalg.cross on the card
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return V3{fmaf(a.y, b.z, -(a.z * b.y)), fmaf(a.z, b.x, -(a.x * b.z)),
            fmaf(a.x, b.y, -(a.y * b.x))};
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ V3 normalize(V3 v) {
  const float l = sqrtf(clamp_min(dot(v, v), (float)1e-20));
  return V3{v.x / l, v.y / l, v.z / l};
}

// lighting._disk_perturb
__device__ __forceinline__ V3 disk_perturb(V3 ld, float radius, float r0, float r1) {
  const V3 tangent = normalize(cross(ld, V3{0.0f, 1.0f, 0.0f}));
  const V3 bitangent = normalize(cross(tangent, ld));
  const float point_radius = radius * sqrtf(r0);
  const float point_angle = (r1 * 2.0f) * PI_F;
  const float dx = point_radius * cosf(point_angle);
  const float dy = point_radius * sinf(point_angle);
  return normalize(V3{(ld.x + dx * tangent.x) + dy * bitangent.x,
                      (ld.y + dx * tangent.y) + dy * bitangent.y,
                      (ld.z + dx * tangent.z) + dy * bitangent.z});
}

// brdf.sample_cosine_lobe (make_rotation_matrix, to_world)
__device__ __forceinline__ V3 cosine_lobe(V3 n, float u0, float u1) {
  const float r0 = clamp_min(u0, (float)1e-5), r1 = clamp_min(u1, (float)1e-5);
  const float phi = TWO_PI_F * r1;
  const float cos_theta = sqrtf(r0);
  const float sin_theta = sqrtf(1.0f - r0);
  const float t0 = sin_theta * cosf(phi), t1 = sin_theta * sinf(phi);
  const bool use_z = fabsf(dot(n, V3{0.0f, 1.0f, 0.0f})) > (float)0.99;
  const V3 ref = use_z ? V3{0.0f, 0.0f, 1.0f} : V3{0.0f, 1.0f, 0.0f};
  const V3 x = normalize(cross(ref, n));
  const V3 y = cross(n, x);
  return normalize(V3{(t0 * x.x + t1 * y.x) + cos_theta * n.x,
                      (t0 * x.y + t1 * y.y) + cos_theta * n.y,
                      (t0 * x.z + t1 * y.z) + cos_theta * n.z});
}

// brdf.evaluate_uber_brdf, one channel at a time after the shared terms
__device__ __forceinline__ V3 uber_brdf(V3 cd, float rough, V3 n, V3 f0, V3 wo, V3 wh, V3 wi) {
  const float ndotl = clamp_min(dot(n, wi), 0.0f);
  const float ndotv = clamp_min(dot(n, wo), 0.0f);
  const float ndoth = clamp_min(dot(n, wh), 0.0f);
  const float vdoth = clamp_min(dot(wi, wh), 0.0f);
  const float p5 = powf(clamp_min(1.0f - vdoth, 0.0f), 5.0f);
  const float alpha = rough * rough;
  const float a2 = alpha * alpha;
  const float denom = (ndoth * ndoth) * (a2 - 1.0f) + 1.0f;
  const float d = a2 / clamp_min((PI_F * denom) * denom, EPS);
  const float k = ((rough + 1.0f) * (rough + 1.0f)) * 0.125f;  // / 8.0 on the card
  const float g1l = ndotl / clamp_min(ndotl * (1.0f - k) + k, EPS);
  const float g1v = ndotv / clamp_min(ndotv * (1.0f - k) + k, EPS);
  const float g = g1l * g1v;
  const float den = clamp_min((4.0f * ndotl) * ndotv, EPS);
  const float fx = f0.x + (1.0f - f0.x) * p5;
  const float fy = f0.y + (1.0f - f0.y) * p5;
  const float fz = f0.z + (1.0f - f0.z) * p5;
  return V3{(1.0f - fx) * (cd.x * INV_PI_F) + ((d * fx) * g) / den,
            (1.0f - fy) * (cd.y * INV_PI_F) + ((d * fy) * g) / den,
            (1.0f - fz) * (cd.z * INV_PI_F) + ((d * fz) * g) / den};
}

// sky.ProceduralSky.radiance
__device__ __forceinline__ V3 procedural_sky(V3 dir, V3 sun, float sun_intensity) {
  const V3 d = normalize(dir);
  const float cos_gamma = clampf(dot(d, sun), -1.0f, 1.0f);
  const float up = clampf(d.y, -1.0f, 1.0f);
  if (up < 0.0f) return V3{(float)0.12, (float)0.10, (float)0.09};
  const float t = sqrtf(clampf(up, 0.0f, 1.0f));
  const float sky_x = (float)0.80 + ((float)0.22 - (float)0.80) * t;
  const float sky_y = (float)0.85 + ((float)0.45 - (float)0.85) * t;
  const float sky_z = (float)0.95 + ((float)0.90 - (float)0.95) * t;
  const float glow = expf((cos_gamma - 1.0f) * 12.0f);
  const float disc = cos_gamma > (float)0.9996 ? 1.0f : 0.0f;
  const float sun_h = clampf(sun.y, 0.0f, 1.0f);
  const float s = (float)0.8 * sun_h + (float)0.2;
  return V3{(sky_x * s + ((glow * 1.0f) * 0.5f) * sun_h) + (disc * 1.0f) * sun_intensity,
            (sky_y * s + ((glow * (float)0.85) * 0.5f) * sun_h) + (disc * (float)0.95) * sun_intensity,
            (sky_z * s + ((glow * (float)0.6) * 0.5f) * sun_h) + (disc * (float)0.85) * sun_intensity};
}

struct LightArgs {
  const float* direction;  // (3,), toward the light
  const float* position;   // (3,)
  const float* color;      // (3,)
  float intensity, radius, cos_outer, smooth_inv;  // smooth_inv: 1 / the cone's width
  int type;
};

__global__ void __launch_bounds__(BLOCK) shade_rays_kernel(
    LightArgs light, const float* __restrict__ p, const float* __restrict__ n,
    const float* __restrict__ rng_shadow, const float* __restrict__ rng_sky,
    const uint8_t* __restrict__ valid, float bias, int64_t num_points,
    float* __restrict__ origin, float* __restrict__ dir, float* __restrict__ t_max,
    float* __restrict__ att_out) {
  const int64_t i = (int64_t)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= num_points) return;
  const V3 pi = load3(p, i), ni = load3(n, i);
  const V3 ld = load3(light.direction, 0);
  const bool live = valid == nullptr || valid[i] != 0;

  V3 wi;
  float t, att;
  if (light.type == LIGHT_DIRECTIONAL) {
    wi = rng_shadow ? disk_perturb(ld, light.radius, __ldg(rng_shadow + 2 * i),
                                   __ldg(rng_shadow + 2 * i + 1))
                    : ld;
    t = (float)1e4;
    att = 1.0f;
  } else {
    const V3 lp = load3(light.position, 0);
    const V3 to_light{lp.x - pi.x, lp.y - pi.y, lp.z - pi.z};
    const float dist = sqrtf(clamp_min(dot(to_light, to_light), (float)1e-12));
    const V3 pl{to_light.x / dist, to_light.y / dist, to_light.z / dist};
    // light.radius / distance is reciprocal(distance) * radius in PyTorch
    wi = rng_shadow ? disk_perturb(pl, (1.0f / dist) * light.radius,
                                   __ldg(rng_shadow + 2 * i), __ldg(rng_shadow + 2 * i + 1))
                    : pl;
    t = dist;
    att = 1.0f / clamp_min(dist * dist, (float)1e-8);
    if (light.type != LIGHT_POINT) {  // spot: smoothstep over the cone
      const float s = clampf((-dot(wi, ld) - light.cos_outer) * light.smooth_inv, 0.0f, 1.0f);
      att = ((s * s) * (3.0f - 2.0f * s)) * att;
    }
  }
  att = att * clampf(dot(ni, wi), 0.0f, 1.0f);

  const V3 ro{pi.x + ni.x * bias, pi.y + ni.y * bias, pi.z + ni.z * bias};
  store3(origin, i, ro);
  store3(dir, i, wi);
  t_max[i] = live && att > 0.0f ? t : 0.0f;
  att_out[i] = att;
  if (rng_sky) {
    const int64_t j = num_points + i;
    store3(origin, j, ro);
    store3(dir, j, cosine_lobe(ni, __ldg(rng_sky + 2 * i), __ldg(rng_sky + 2 * i + 1)));
    t_max[j] = live ? (float)1e4 : 0.0f;
  }
}

__global__ void __launch_bounds__(BLOCK) shade_combine_kernel(
    LightArgs light, const float* __restrict__ wo, const float* __restrict__ n,
    const float* __restrict__ f0, const float* __restrict__ cd,
    const float* __restrict__ rough, const float* __restrict__ throughput,
    const float* __restrict__ att_in, const float* __restrict__ dir,
    const float* __restrict__ vis, int sky_mode, const float* __restrict__ sky,
    float sun_intensity, int64_t num_points, float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= num_points) return;
  const V3 woi = load3(wo, i), ni = load3(n, i), f0i = load3(f0, i), cdi = load3(cd, i);
  const float r = __ldg(rough + i);
  const V3 tp = throughput ? load3(throughput, i) : V3{1.0f, 1.0f, 1.0f};
  const V3 li{__ldg(light.color) * light.intensity, __ldg(light.color + 1) * light.intensity,
              __ldg(light.color + 2) * light.intensity};

  float att = __ldg(att_in + i);
  if (vis) {
    const float v = __ldg(vis + i);
    att = att * (att > 0.0f ? v : 0.0f);
  }
  const V3 wi = load3(dir, i);
  const V3 val = uber_brdf(cdi, r, ni, f0i, woi, normalize(V3{woi.x + wi.x, woi.y + wi.y,
                                                              woi.z + wi.z}), wi);
  // weighted(val) * att * li; without a throughput the multiply by ones
  // is left out, as the plain version leaves it out (it is exact)
  V3 lo{(throughput ? tp.x * val.x : val.x) * att * li.x,
        (throughput ? tp.y * val.y : val.y) * att * li.y,
        (throughput ? tp.z * val.z : val.z) * att * li.z};

  if (sky_mode != SKY_NONE) {
    const V3 ws = load3(dir, num_points + i);
    V3 ls = sky_mode == SKY_PROCEDURAL ? procedural_sky(ws, load3(sky, 0), sun_intensity)
                                       : load3(sky, i);
    if (vis) {
      const float v = __ldg(vis + num_points + i);
      ls = V3{ls.x * v, ls.y * v, ls.z * v};
    }
    const V3 vs = uber_brdf(cdi, r, ni, f0i, woi,
                            normalize(V3{woi.x + ws.x, woi.y + ws.y, woi.z + ws.z}), ws);
    lo = V3{lo.x + (throughput ? tp.x * vs.x : vs.x) * ls.x,
            lo.y + (throughput ? tp.y * vs.y : vs.y) * ls.y,
            lo.z + (throughput ? tp.z * vs.z : vs.z) * ls.z};
  }
  store3(out, i, lo);
}

inline int blocks(int64_t n) { return (int)((n + BLOCK - 1) / BLOCK); }

}  // namespace

extern "C" int hr_shade_rays(const float* light_dir, const float* light_pos, int light_type,
                             float radius, float cos_outer, float smooth_inv, const float* p,
                             const float* n, const float* rng_shadow, const float* rng_sky,
                             const uint8_t* valid, float bias, int num_points, float* origin,
                             float* dir, float* t_max, float* att, void* stream) {
  if (num_points > 0) {
    const LightArgs light{light_dir, light_pos, nullptr, 0.0f, radius, cos_outer, smooth_inv,
                          light_type};
    shade_rays_kernel<<<blocks(num_points), BLOCK, 0, (cudaStream_t)stream>>>(
        light, p, n, rng_shadow, rng_sky, valid, bias, num_points, origin, dir, t_max, att);
  }
  return (int)cudaGetLastError();
}

extern "C" int hr_shade_combine(const float* light_color, float intensity, const float* wo,
                                const float* n, const float* f0, const float* cd,
                                const float* rough, const float* throughput, const float* att,
                                const float* dir, const float* vis, int sky_mode,
                                const float* sky, float sun_intensity, int num_points,
                                float* out, void* stream) {
  if (sky_mode < SKY_NONE || sky_mode > SKY_GIVEN) return (int)cudaErrorInvalidValue;
  if (num_points > 0) {
    const LightArgs light{nullptr, nullptr, light_color, intensity, 0.0f, 0.0f, 0.0f, 0};
    shade_combine_kernel<<<blocks(num_points), BLOCK, 0, (cudaStream_t)stream>>>(
        light, wo, n, f0, cd, rough, throughput, att, dir, vis, sky_mode, sky, sun_intensity,
        num_points, out);
  }
  return (int)cudaGetLastError();
}
