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
// scalar_hit_kernel: the [4, NS] table (cx, cy, cz, r^2) and the half-b
// quadric in the order of rtt_common.cuh's sphere_root, a strict "<" in
// table order.  Bound: ~32 FP32 operations per (ray, sphere) pair.  With
// -fmad=false it is bitwise equal to its twin.  The design fills the card
// whatever the ray count:
//
// * K lanes a ray (K a power of two up to 32, a template flag).  The
//   wrapper picks the least K whose grid covers one resident wave of the
//   card (rtt_scalar_split: the SM count times the blocks an SM holds, from
//   the occupancy query), so the spike's 4,096 rays run on 32 lanes each
//   and 2^20 rays on one.  Lane p of a ray scans spheres p, p + K, ...,
//   keeping its first strict minimum, and a shuffle takes the K lanes'
//   lexicographic minimum of (t, index), as path.cuh's warp_min_lex does:
//   the least root at the lowest index, which is what the strict "<" in
//   table order gives, so the result does not depend on K.
// * The table is staged in shared memory as float4 rows, 1,024 spheres (16
//   KB) at a time, and each row is read there by the lanes that test it.
// * Every pair of every scan is tested: the `iters` repeats stay (they
//   cannot change the winner, but they are the spike's work).  A pair
//   with disc <= 0 skips the root and sqrt, which the take does not need
//   (it needs disc > 0): at the spike's shape that took 1.69 to 1.04 ms,
//   at 2^20 rays 1.95 to 0.92 ms (chip_measure.py --segments, which
//   builds the other form with -DRTT_SCALAR_SKIP_MISS=0).
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

#ifndef RTT_SCALAR_SKIP_MISS
#define RTT_SCALAR_SKIP_MISS 1
#endif
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int NO_ROW = 0x7fffffff;
constexpr int SBLOCK = 256;  // threads a block of the scalar kernel
constexpr int STILE = 1024;  // spheres staged in shared memory at a time

template <int K>
__global__ void __launch_bounds__(SBLOCK) scalar_hit_kernel(
    const float* __restrict__ tab, int ns, const float* __restrict__ ox,
    const float* __restrict__ oy, const float* __restrict__ oz,
    const float* __restrict__ dx, const float* __restrict__ dy,
    const float* __restrict__ dz, int iters, float* __restrict__ bt_out,
    int* __restrict__ bi_out, int n_rays) {
  __shared__ float4 sm[STILE];
  const int t = blockIdx.x * SBLOCK + threadIdx.x;
  const int ray = t / K, part = t % K;
  // a thread past the last ray still stages the table and joins the
  // shuffle; it writes nothing
  const bool valid = ray < n_rays;
  const int r = valid ? ray : 0;
  const float x = ox[r], y = oy[r], z = oz[r];
  const float ddx = dx[r], ddy = dy[r], ddz = dz[r];
  const float a = ddx * ddx + ddy * ddy + ddz * ddz;
  const float inv_a = 1.0f / a;
  float bt = BIG;
  int bi = NO_ROW;
  for (int s0 = 0; s0 < ns; s0 += STILE) {
    const int m = min(STILE, ns - s0);
    __syncthreads();
    for (int j = threadIdx.x; j < m; j += SBLOCK)
      sm[j] = make_float4(tab[s0 + j], tab[ns + s0 + j],
                          tab[2 * ns + s0 + j], tab[3 * ns + s0 + j]);
    __syncthreads();
    // the repeats inside the tile: each lane still sees its spheres in
    // increasing index order, so the first strict minimum is the same
    for (int it = 0; it < iters; ++it) {
#pragma unroll 4
      for (int j = part; j < m; j += K) {
        const float4 g = sm[j];
        const float ocx = g.x - x;
        const float ocy = g.y - y;
        const float ocz = g.z - z;
        const float h = ddx * ocx + ddy * ocy + ddz * ocz;
        const float c = ocx * ocx + ocy * ocy + ocz * ocz - g.w;
        const float disc = h * h - a * c;
        if (RTT_SCALAR_SKIP_MISS && !(disc > 0.0f)) continue;
        const float sq = sqrtf(fmaxf(disc, 0.0f));
        const float tn = (h - sq) * inv_a;
        const float tf = (h + sq) * inv_a;
        const float root = (tn > T_MIN && tn < T_MAX) ? tn : tf;
        if (disc > 0.0f && root > T_MIN && root < T_MAX && root < bt) {
          bt = root;
          bi = s0 + j;
        }
      }
    }
  }
  // the lexicographic minimum of (t, index) over the ray's K lanes, which
  // are K consecutive lanes of one warp
#pragma unroll
  for (int off = K / 2; off > 0; off >>= 1) {
    const float ot = __shfl_xor_sync(FULL_MASK, bt, off);
    const int oi = __shfl_xor_sync(FULL_MASK, bi, off);
    if (ot < bt || (ot == bt && oi < bi)) {
      bt = ot;
      bi = oi;
    }
  }
  if (valid && part == 0) {
    bt_out[ray] = bt;
    bi_out[ray] = bi == NO_ROW ? -1 : bi;
  }
}

template <int K>
void scalar_launch(const float* tab, int ns, const float* ox,
                   const float* oy, const float* oz, const float* dx,
                   const float* dy, const float* dz, int iters, float* bt,
                   int* bi, int n_rays, cudaStream_t st) {
  const long long threads = (long long)n_rays * K;
  const int grid = (int)((threads + SBLOCK - 1) / SBLOCK);
  scalar_hit_kernel<K><<<grid, SBLOCK, 0, st>>>(tab, ns, ox, oy, oz, dx, dy,
                                                 dz, iters, bt, bi, n_rays);
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

// The lanes a ray of the scalar kernel for n_rays rays: the least power
// of two up to 32 whose grid covers one resident wave (the SMs times the
// blocks of SBLOCK threads an SM holds); negative on a CUDA error.
extern "C" int rtt_scalar_split(int n_rays) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, scalar_hit_kernel<1>, SBLOCK, 0);
  if (e != cudaSuccess) return -(int)e;
  const long long wave = (long long)sms * per_sm * SBLOCK;
  int k = 1;
  while (k < 32 && (long long)n_rays * k < wave) k *= 2;
  return k;
}

// `split` lanes a ray: 1, 2, 4, 8, 16 or 32 (the wrapper checks it)
extern "C" int rtt_scalar_hit(const float* tab, int ns, const float* ox,
                              const float* oy, const float* oz,
                              const float* dx, const float* dy,
                              const float* dz, int iters, int split,
                              float* bt_out, int* bi_out, int n_rays,
                              void* stream) {
  if (n_rays > 0) {
    const cudaStream_t st = (cudaStream_t)stream;
#define RTT_SCALAR_CASE(K)                                                \
  case K:                                                                 \
    scalar_launch<K>(tab, ns, ox, oy, oz, dx, dy, dz, iters, bt_out,      \
                     bi_out, n_rays, st);                                 \
    break;
    switch (split) {
      RTT_SCALAR_CASE(1)
      RTT_SCALAR_CASE(2)
      RTT_SCALAR_CASE(4)
      RTT_SCALAR_CASE(8)
      RTT_SCALAR_CASE(16)
      RTT_SCALAR_CASE(32)
      default:
        return (int)cudaErrorInvalidValue;
    }
#undef RTT_SCALAR_CASE
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
