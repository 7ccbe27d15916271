// S1: the dense closest-sphere spike, as two kernels.
//
// Replaces rustraytrace_tpu/scripts/spike_dense_mxu.py: make_dense (:28,
// called at :181) and make_scalar (:111, called at :184).  Plain twins:
// ops/dense_hit.py dense_hit_plain and scalar_hit_plain.
//
// Both return, for every ray, the first index of the smallest valid root
// over the sphere table (-1 and BIG when there is none), repeated `iters`
// times with the best carried across, as the spike does.
//
// scalar_hit_kernel: one thread per ray, a loop over the [4, NS] table (cx,
// cy, cz, r^2) with the half-b quadric in the order of rtt_common.cuh's
// sphere_root and a strict "<".  Bound: ~30 FP32 operations per (ray,
// sphere) pair; the table is read at one address by a whole warp (an L1
// broadcast).  With -fmad=false it is bitwise equal to its twin.
//
// dense_hit_kernel: the two K=4 products of the expanded quadric,
// dC = C . d and m = C . o - (C^2 - r^2) / 2, on the tensor cores with
// mma.sync.m16n8k8 TF32 in the kernel's own body: A is 16 spheres x K 8
// (the dense table's 8 rows, whose rows 4-7 are the zero padding), B is
// K 8 x 8 rays holding [dx, dy, dz, 0] or [ox, oy, oz, -1] in rows 0-3 and
// zeros below.  HIGHEST is 3xTF32 (big and residual parts of each operand:
// small*big + big*small + big*big), the counterpart of Precision.HIGHEST;
// otherwise one TF32 pass, the counterpart of DEFAULT.  The epilogue runs
// in FP32 on the accumulator fragments (h = dC - d.o, c = |o|^2 - 2m, the
// roots), each thread keeps the best of its 2 rays over its sphere rows
// in increasing index order, and a warp shuffle over the 8 lanes that hold
// a ray column takes the minimum, the smaller index on a tie.  Bound: the
// FP32 epilogue (~22 operations a pair); the products are ~1/8 of the
// tensor cores' TF32 rate.  A warp handles 8 rays and reads the table from
// global memory (L1): wgmma, TMA and shared-memory staging are later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// the spike's constants (spike_dense_mxu.py:20-25)
constexpr float T_MIN = 1e-3f;
constexpr float T_MAX = 1e30f;
constexpr float BIG = 3e38f;

__global__ void scalar_hit_kernel(const float* __restrict__ tab, int ns,
                                  const float* __restrict__ ox,
                                  const float* __restrict__ oy,
                                  const float* __restrict__ oz,
                                  const float* __restrict__ dx,
                                  const float* __restrict__ dy,
                                  const float* __restrict__ dz, int iters,
                                  float* __restrict__ bt_out,
                                  int* __restrict__ bi_out, int n_rays) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const float x = ox[i], y = oy[i], z = oz[i];
  const float ddx = dx[i], ddy = dy[i], ddz = dz[i];
  const float a = ddx * ddx + ddy * ddy + ddz * ddz;
  const float inv_a = 1.0f / a;
  float bt = BIG;
  int bi = -1;
  for (int it = 0; it < iters; ++it) {
#pragma unroll 4
    for (int s = 0; s < ns; ++s) {
      const float ocx = tab[s] - x;
      const float ocy = tab[ns + s] - y;
      const float ocz = tab[2 * ns + s] - z;
      const float h = ddx * ocx + ddy * ocy + ddz * ocz;
      const float c = ocx * ocx + ocy * ocy + ocz * ocz - tab[3 * ns + s];
      const float disc = h * h - a * c;
      const float sq = sqrtf(fmaxf(disc, 0.0f));
      const float tn = (h - sq) * inv_a;
      const float tf = (h + sq) * inv_a;
      const float root = (tn > T_MIN && tn < T_MAX) ? tn : tf;
      if (disc > 0.0f && root > T_MIN && root < T_MAX && root < bt) {
        bt = root;
        bi = s;
      }
    }
  }
  bt_out[i] = bt;
  bi_out[i] = bi;
}

// round to TF32, nearest with ties away (the tensor cores read the top 19
// bits of the register)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// d += A (16x8, row) * B (8x8, col), TF32 in, FP32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment layout of m16n8k8 TF32 (PTX ISA), lane = 4 * g + q:
//   A: a0 (row g, col q), a1 (row g + 8, col q), a2 (row g, col q + 4),
//      a3 (row g + 8, col q + 4);
//   B: b0 (row q, col g), b1 (row q + 4, col g);
//   C: c0 (row g, col 2q), c1 (row g, col 2q + 1), c2 (row g + 8, col 2q),
//      c3 (row g + 8, col 2q + 1).
// Rows of A and C are spheres, columns of B and C rays.
template <bool HIGHEST>
__global__ void dense_hit_kernel(const float* __restrict__ dtab, int ns,
                                 const float* __restrict__ ox,
                                 const float* __restrict__ oy,
                                 const float* __restrict__ oz,
                                 const float* __restrict__ dx,
                                 const float* __restrict__ dy,
                                 const float* __restrict__ dz, int iters,
                                 float* __restrict__ bt_out,
                                 int* __restrict__ bi_out, int n_rays) {
  const int lane = threadIdx.x & 31;
  const int r0 = ((blockIdx.x * blockDim.x + threadIdx.x) >> 5) * 8;
  if (r0 >= n_rays) return;  // whole warps only: n_rays % 8 == 0
  const int g = lane >> 2, q = lane & 3;

  // B fragments, fixed for the whole sphere loop: ray r0 + g, row q
  const int rb = r0 + g;
  const float dv = q == 0 ? dx[rb] : q == 1 ? dy[rb] : q == 2 ? dz[rb] : 0.0f;
  const float ov = q == 0 ? ox[rb] : q == 1 ? oy[rb] : q == 2 ? oz[rb] : -1.0f;
  const uint32_t bd = to_tf32(dv), bo = to_tf32(ov);
  const uint32_t bd_s = to_tf32(dv - __uint_as_float(bd));
  const uint32_t bo_s = to_tf32(ov - __uint_as_float(bo));
  const uint32_t zero = 0u;  // rows 4-7 of B: the K padding

  // the epilogue's rays: r0 + 2q + j (the spike's per-row a, 1/a, d.o, o^2)
  float ra[2], rinv[2], rdo[2], ro2[2], best[2];
  int bidx[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = r0 + 2 * q + j;
    const float x = ox[r], y = oy[r], z = oz[r];
    const float ddx = dx[r], ddy = dy[r], ddz = dz[r];
    ra[j] = ddx * ddx + ddy * ddy + ddz * ddz;
    rinv[j] = 1.0f / ra[j];
    rdo[j] = ddx * x + ddy * y + ddz * z;
    ro2[j] = x * x + y * y + z * z;
    best[j] = BIG;
    bidx[j] = -1;
  }

  for (int it = 0; it < iters; ++it) {
    for (int s0 = 0; s0 < ns; s0 += 16) {
      const float av[4] = {dtab[q * ns + s0 + g], dtab[q * ns + s0 + g + 8],
                           dtab[(q + 4) * ns + s0 + g],
                           dtab[(q + 4) * ns + s0 + g + 8]};
      uint32_t ab[4], as[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        ab[k] = to_tf32(av[k]);
        as[k] = to_tf32(av[k] - __uint_as_float(ab[k]));
      }
      float dc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float mm[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (HIGHEST) {  // the residual products first, the big one last
        mma_tf32(dc, as, bd, zero);
        mma_tf32(dc, ab, bd_s, zero);
        mma_tf32(mm, as, bo, zero);
        mma_tf32(mm, ab, bo_s, zero);
      }
      mma_tf32(dc, ab, bd, zero);
      mma_tf32(mm, ab, bo, zero);
      // c[k]: sphere s0 + g (+8 for k >= 2), ray 2q + (k & 1); sphere
      // indices increase along k for each ray
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = k & 1;
        const float h = dc[k] - rdo[j];
        const float c0 = ro2[j] - 2.0f * mm[k];
        const float disc = h * h - ra[j] * c0;
        const float sq = sqrtf(fmaxf(disc, 0.0f));
        const float tn = (h - sq) * rinv[j];
        const float tf = (h + sq) * rinv[j];
        const float root = (tn > T_MIN && tn < T_MAX) ? tn : tf;
        const bool take = disc > 0.0f && root > T_MIN && root < T_MAX;
        const float key = take ? root : BIG;
        if (key < best[j]) {
          best[j] = key;
          bidx[j] = s0 + g + ((k >> 1) << 3);
        }
      }
    }
  }
  // min and first-index argmin over the 8 lanes of a ray column (same q)
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best[j], off);
      const int oi = __shfl_xor_sync(0xffffffffu, bidx[j], off);
      if (ob < best[j] || (ob == best[j] && oi < bidx[j])) {
        best[j] = ob;
        bidx[j] = oi;
      }
    }
    if (g == 0) {
      bt_out[r0 + 2 * q + j] = best[j];
      bi_out[r0 + 2 * q + j] = bidx[j];
    }
  }
}

}  // namespace

extern "C" int rtt_scalar_hit(const float* tab, int ns, const float* ox,
                              const float* oy, const float* oz,
                              const float* dx, const float* dy,
                              const float* dz, int iters, float* bt_out,
                              int* bi_out, int n_rays, void* stream) {
  if (n_rays > 0) {
    const int block = 128;
    const int grid = (n_rays + block - 1) / block;
    scalar_hit_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        tab, ns, ox, oy, oz, dx, dy, dz, iters, bt_out, bi_out, n_rays);
  }
  return (int)cudaGetLastError();
}

extern "C" int rtt_dense_hit(const float* dtab, int ns, const float* ox,
                             const float* oy, const float* oz,
                             const float* dx, const float* dy,
                             const float* dz, int iters, int highest,
                             float* bt_out, int* bi_out, int n_rays,
                             void* stream) {
  if (n_rays > 0) {
    const int block = 128;  // 4 warps, 8 rays each
    const int grid = (n_rays + 31) / 32;
    if (highest) {
      dense_hit_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(
          dtab, ns, ox, oy, oz, dx, dy, dz, iters, bt_out, bi_out, n_rays);
    } else {
      dense_hit_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(
          dtab, ns, ox, oy, oz, dx, dy, dz, iters, bt_out, bi_out, n_rays);
    }
  }
  return (int)cudaGetLastError();
}
