// K1: closest hit over spheres (optionally moving), then quads.
//
// Replaces rustraytrace_tpu/ops/pallas_hit.py:_sphere_hit_raw (kernel body
// _make_kernel, pallas_hit.py:68-159).  Plain twin: ops/hit.py
// sphere_hit_plain.
//
// One thread per ray, a scalar loop over the sphere table and then the quad
// table with a strict "<" in table order, carrying (best_t, best_idx); quad
// winners are encoded as n_spheres + qi, and a miss returns (T_MAX, -1).
// Bound on this card: the tables are tiny and read by every thread at the
// same address (an L1 broadcast), so the loop is bound by its ~25 FP32
// operations per sphere per ray.  The design does nothing more about that
// yet (no shared-memory staging, no warp-level culling): this kernel is the
// exact check of the shared sphere quadric and quad test in rtt_common.cuh.
#include "rtt_common.cuh"

namespace {

// sphere table columns (pallas_hit.py S_*)
constexpr int S_COLS = 8;

__global__ void sphere_hit_kernel(const float* __restrict__ o,
                                  const float* __restrict__ d,
                                  const float* __restrict__ tm,
                                  const float* __restrict__ sph, int n_sph,
                                  const float* __restrict__ quad, int n_quad,
                                  int moving, float* __restrict__ t_out,
                                  int* __restrict__ idx_out, int n_rays) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float a = dx * dx + dy * dy + dz * dz;
  const float inv_a = 1.0f / a;
  const float t = moving ? tm[i] : 0.0f;

  float best_t = rtt::BIG;
  int best_i = -1;
  for (int s = 0; s < n_sph; ++s) {
    const float* row = sph + s * S_COLS;
    float cx = row[0], cy = row[1], cz = row[2];
    if (moving) {
      cx = cx + t * row[4];
      cy = cy + t * row[5];
      cz = cz + t * row[6];
    }
    bool ok;
    const float root =
        rtt::sphere_root(cx, cy, cz, row[3], ox, oy, oz, dx, dy, dz, a,
                         inv_a, &ok);
    if (ok && root < best_t) {
      best_t = root;
      best_i = s;
    }
  }
  // quads: plane hit + planar-coordinate interior test (quad.rs:59-88)
  for (int qi = 0; qi < n_quad; ++qi) {
    bool ok;
    const float tq =
        rtt::quad_hit(quad + qi * rtt::Q_COLS, ox, oy, oz, dx, dy, dz, &ok);
    if (ok && tq < best_t) {
      best_t = tq;
      best_i = n_sph + qi;
    }
  }
  t_out[i] = best_i >= 0 ? best_t : rtt::T_MAX;
  idx_out[i] = best_i;
}

}  // namespace

extern "C" int rtt_sphere_hit(const float* o, const float* d,
                              const float* tm, const float* sph, int n_sph,
                              const float* quad, int n_quad, int moving,
                              float* t_out, int* idx_out, int n_rays,
                              void* stream) {
  if (n_rays > 0) {
    const int block = 128;
    const int grid = (n_rays + block - 1) / block;
    sphere_hit_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        o, d, tm, sph, n_sph, quad, n_quad, moving, t_out, idx_out, n_rays);
  }
  return (int)cudaGetLastError();
}

// message of an error code returned by any entry point of this library
extern "C" const char* rtt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
