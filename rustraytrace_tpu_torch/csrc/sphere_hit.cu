// K1: closest hit over spheres (optionally moving), then quads.
//
// Replaces rustraytrace_tpu/ops/pallas_hit.py:_sphere_hit_raw (kernel body
// _make_kernel, pallas_hit.py:68-159).  Plain twin: ops/hit.py
// sphere_hit_plain.
//
// Each ray scans the sphere table and then the quad table in table order
// with a strict "<", carrying (best_t, best_idx); quad winners are encoded
// as n_spheres + qi, and a miss returns (T_MAX, -1).
//
// Bound on this card: the ~20 FP32 instructions of each (ray, sphere)
// quadric test; the table is small and every ray reads all of it.  So:
//
// * Persistent blocks (the SM count x the blocks that fit on one), each
//   taking groups of K1_THREADS x K1_RAYS consecutive rays, grid-stride.
// * The sphere table (ops/hit.py sphere_table_f4: float4 center, r^2 and,
//   when moving, a float4 velocity plane) streams through a ring of
//   K1_STAGES shared-memory tiles of K1_TILE spheres, filled by one thread
//   with bulk copies that complete on one mbarrier per stage; a table of at
//   most K1_STAGES tiles is loaded once and stays for every group.
// * K1_RAYS rays per thread: one broadcast shared-memory float4 load feeds
//   K1_RAYS quadric tests, and the rays are read with float4 loads.
// * The square root and the two roots are taken only where disc > 0; a
//   sphere with disc <= 0 is never a hit, so the result is unchanged.
// * Then the quads, from global memory, as before.
// Every expression keeps sphere_root's order (rtt_common.cuh), so t and idx
// are the plain twin's bitwise.
#include "rtt_common.cuh"

namespace {

constexpr int K1_THREADS = 128;
constexpr int K1_RAYS = 4;
constexpr int K1_GROUP = K1_THREADS * K1_RAYS;
constexpr int K1_TILE = 1024;
constexpr int K1_STAGES = 2;

struct Ring {
  const float4* geom;  // [n_sph] cx, cy, cz, r2
  const float4* vel;   // [n_sph] vx, vy, vz, 0 (read when moving)
  int n_sph, n_tiles;
  int stages;  // stages allocated: min(K1_STAGES, n_tiles)
  int cap;     // rows of one stage: min(K1_TILE, n_sph)
  int loads;   // tile loads of this block in all
};

// load j of the block: tile j % n_tiles into stage j % K1_STAGES
template <bool MOVING>
__device__ __forceinline__ void issue(const Ring& R, float4* ring,
                                      uint64_t* full, int j) {
  const int tile = j % R.n_tiles, stage = j % K1_STAGES;
  const int lo = tile * K1_TILE;
  const int rows = min(K1_TILE, R.n_sph - lo);
  const uint32_t bytes = (uint32_t)rows * 16u;
  rtt::mbar_expect_tx(&full[stage], MOVING ? 2u * bytes : bytes);
  rtt::bulk_g2s(ring + stage * R.cap, R.geom + lo, bytes, &full[stage]);
  if (MOVING)
    rtt::bulk_g2s(ring + (R.stages + stage) * R.cap, R.vel + lo, bytes,
                  &full[stage]);
}

// at least 4 blocks of 128 threads an SM: up to 128 registers, no spill
template <bool MOVING>
__global__ void __launch_bounds__(K1_THREADS, 4)
    sphere_hit_kernel(const float* __restrict__ o, const float* __restrict__ d,
                      const float* __restrict__ tm, Ring R,
                      const float* __restrict__ quad, int n_quad,
                      float* __restrict__ t_out, int* __restrict__ idx_out,
                      int n_rays) {
  extern __shared__ __align__(16) float4 ring[];
  __shared__ __align__(8) uint64_t full[K1_STAGES];
  const int tid = threadIdx.x;
  const int n_groups = (n_rays + K1_GROUP - 1) / K1_GROUP;
  const bool resident = R.n_tiles <= K1_STAGES;
  const int my_groups = (n_groups - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  R.loads = resident ? R.n_tiles : my_groups * R.n_tiles;
  if (tid == 0)
    for (int k = 0; k < K1_STAGES; ++k) rtt::mbar_init(&full[k], 1);
  __syncthreads();
  if (tid == 0)
    for (int j = 0; j < min(K1_STAGES, R.loads); ++j)
      issue<MOVING>(R, ring, full, j);
  if (resident)
    for (int j = 0; j < R.loads; ++j) rtt::mbar_wait(&full[j], 0);

  int j = 0;  // next tile load to consume (streaming tables)
  for (int g = blockIdx.x; g < n_groups; g += gridDim.x) {
    const int r0 = g * K1_GROUP + tid * K1_RAYS;
    float ox[K1_RAYS], oy[K1_RAYS], oz[K1_RAYS], dx[K1_RAYS], dy[K1_RAYS],
        dz[K1_RAYS], a[K1_RAYS], inv_a[K1_RAYS], t[K1_RAYS], best[K1_RAYS];
    int bi[K1_RAYS];
    if (r0 + K1_RAYS <= n_rays) {
      // 4 rays: 12 floats of o and d each, 16-byte aligned (the wrapper
      // checks the base pointers)
      const float4* o4 = reinterpret_cast<const float4*>(o + 3 * (size_t)r0);
      const float4* d4 = reinterpret_cast<const float4*>(d + 3 * (size_t)r0);
      const float4 oa = o4[0], ob = o4[1], oc = o4[2];
      const float4 da = d4[0], db = d4[1], dc = d4[2];
      const float ov[12] = {oa.x, oa.y, oa.z, oa.w, ob.x, ob.y,
                            ob.z, ob.w, oc.x, oc.y, oc.z, oc.w};
      const float dv[12] = {da.x, da.y, da.z, da.w, db.x, db.y,
                            db.z, db.w, dc.x, dc.y, dc.z, dc.w};
#pragma unroll
      for (int r = 0; r < K1_RAYS; ++r) {
        ox[r] = ov[3 * r];
        oy[r] = ov[3 * r + 1];
        oz[r] = ov[3 * r + 2];
        dx[r] = dv[3 * r];
        dy[r] = dv[3 * r + 1];
        dz[r] = dv[3 * r + 2];
      }
      if (MOVING) {
        const float4 tv = *reinterpret_cast<const float4*>(tm + r0);
        t[0] = tv.x;
        t[1] = tv.y;
        t[2] = tv.z;
        t[3] = tv.w;
      }
    } else {
#pragma unroll
      for (int r = 0; r < K1_RAYS; ++r) {
        const int i = min(r0 + r, n_rays - 1);  // the tail repeats a ray
        ox[r] = o[3 * (size_t)i];
        oy[r] = o[3 * (size_t)i + 1];
        oz[r] = o[3 * (size_t)i + 2];
        dx[r] = d[3 * (size_t)i];
        dy[r] = d[3 * (size_t)i + 1];
        dz[r] = d[3 * (size_t)i + 2];
        if (MOVING) t[r] = tm[i];
      }
    }
#pragma unroll
    for (int r = 0; r < K1_RAYS; ++r) {
      a[r] = dx[r] * dx[r] + dy[r] * dy[r] + dz[r] * dz[r];
      inv_a[r] = 1.0f / a[r];
      best[r] = rtt::BIG;
      bi[r] = -1;
    }

    for (int tile = 0; tile < R.n_tiles; ++tile) {
      const int stage = resident ? tile : j % K1_STAGES;
      if (!resident) rtt::mbar_wait(&full[stage], (j / K1_STAGES) & 1);
      const float4* G = ring + stage * R.cap;
      const float4* V = ring + (R.stages + stage) * R.cap;
      const int lo = tile * K1_TILE;
      const int rows = min(K1_TILE, R.n_sph - lo);
      for (int k = 0; k < rows; ++k) {
        const float4 gk = G[k];
        float4 vk;
        if (MOVING) vk = V[k];
#pragma unroll
        for (int r = 0; r < K1_RAYS; ++r) {
          float cx = gk.x, cy = gk.y, cz = gk.z;
          if (MOVING) {
            // center at the ray's time (sphere.rs:30-35)
            cx = cx + t[r] * vk.x;
            cy = cy + t[r] * vk.y;
            cz = cz + t[r] * vk.z;
          }
          // rtt::sphere_root, its root taken only where disc > 0
          const float ocx = cx - ox[r];
          const float ocy = cy - oy[r];
          const float ocz = cz - oz[r];
          const float h = dx[r] * ocx + dy[r] * ocy + dz[r] * ocz;
          const float c = ocx * ocx + ocy * ocy + ocz * ocz - gk.w;
          const float disc = h * h - a[r] * c;
          if (disc > 0.0f) {
            const float sq = sqrtf(disc);
            const float tn = (h - sq) * inv_a[r];
            const float tf = (h + sq) * inv_a[r];
            const float root =
                (tn > rtt::T_MIN && tn < rtt::T_MAX) ? tn : tf;
            if (root > rtt::T_MIN && root < rtt::T_MAX && root < best[r]) {
              best[r] = root;
              bi[r] = lo + k;
            }
          }
        }
      }
      if (!resident) {
        // every thread is done with this stage before it is refilled
        __syncthreads();
        if (tid == 0 && j + K1_STAGES < R.loads)
          issue<MOVING>(R, ring, full, j + K1_STAGES);
        ++j;
      }
    }

    // quads: plane hit + planar-coordinate interior test (quad.rs:59-88)
    for (int qi = 0; qi < n_quad; ++qi) {
      const float* q = quad + qi * rtt::Q_COLS;
#pragma unroll
      for (int r = 0; r < K1_RAYS; ++r) {
        bool ok;
        const float tq =
            rtt::quad_hit(q, ox[r], oy[r], oz[r], dx[r], dy[r], dz[r], &ok);
        if (ok && tq < best[r]) {
          best[r] = tq;
          bi[r] = R.n_sph + qi;
        }
      }
    }

    float tv[K1_RAYS];
#pragma unroll
    for (int r = 0; r < K1_RAYS; ++r) tv[r] = bi[r] >= 0 ? best[r] : rtt::T_MAX;
    if (r0 + K1_RAYS <= n_rays) {
      *reinterpret_cast<float4*>(t_out + r0) =
          make_float4(tv[0], tv[1], tv[2], tv[3]);
      *reinterpret_cast<int4*>(idx_out + r0) =
          make_int4(bi[0], bi[1], bi[2], bi[3]);
    } else {
#pragma unroll
      for (int r = 0; r < K1_RAYS; ++r)
        if (r0 + r < n_rays) {
          t_out[r0 + r] = tv[r];
          idx_out[r0 + r] = bi[r];
        }
    }
  }
}

template <bool MOVING>
cudaError_t launch(const float* o, const float* d, const float* tm, Ring R,
                   const float* quad, int n_quad, float* t_out, int* idx_out,
                   int n_rays, cudaStream_t st) {
  auto kernel = sphere_hit_kernel<MOVING>;
  const int smem = R.stages * R.cap * 16 * (MOVING ? 2 : 1);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, K1_THREADS, smem)) != cudaSuccess)
    return e;
  const int n_groups = (n_rays + K1_GROUP - 1) / K1_GROUP;
  const int grid = max(1, min(n_groups, sms * per_sm));
  kernel<<<grid, K1_THREADS, smem, st>>>(o, d, tm, R, quad, n_quad, t_out,
                                         idx_out, n_rays);
  return cudaGetLastError();
}

}  // namespace

// sph4: float32 [2, n_sph, 4], the float4 planes of ops/hit.py
// sphere_table_f4 (center and r^2, then the velocity)
extern "C" int rtt_sphere_hit(const float* o, const float* d,
                              const float* tm, const float* sph4, int n_sph,
                              const float* quad, int n_quad, int moving,
                              float* t_out, int* idx_out, int n_rays,
                              void* stream) {
  if (n_rays <= 0) return (int)cudaGetLastError();
  Ring R;
  R.geom = reinterpret_cast<const float4*>(sph4);
  R.vel = R.geom + n_sph;
  R.n_sph = n_sph;
  R.n_tiles = (n_sph + K1_TILE - 1) / K1_TILE;
  R.stages = min(K1_STAGES, R.n_tiles);
  R.cap = min(K1_TILE, n_sph);
  R.loads = 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e =
      moving ? launch<true>(o, d, tm, R, quad, n_quad, t_out, idx_out,
                            n_rays, st)
             : launch<false>(o, d, tm, R, quad, n_quad, t_out, idx_out,
                             n_rays, st);
  return (int)e;
}

// message of an error code returned by any entry point of this library
extern "C" const char* rtt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
