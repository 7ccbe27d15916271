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
// dense_hit_kernel: the expanded quadric, whose two K=4 products
// dC = C . [d; 0] and m = C . [o; -1] (C the dense table's rows cx, cy, cz,
// (C^2 - r^2) / 2) run on the tensor cores, then an FP32 epilogue
// (h = dC - d.o, c0 = |o|^2 - 2m, disc = h^2 - a c0, the roots).  What
// bounds it on this card: the epilogue's FP32 work, 6 operations a pair
// whose discriminant is not positive (99.7% of pairs at the spike's shape;
// c0's fused multiply-add counted as 2) and ~22 where it is; the products
// are ~1/8 of the tensor cores' TF32 rate.  The design answers the four
// faults of the first port (a warp for 8 rays, so 128 blocks for the
// spike's 4,096 rays; every root taken; the table re-read and re-split by
// every warp each iteration; K padded from 4 to 8):
//
// * The sphere axis is split into `split` contiguous ranges (grid.y), so
//   the grid covers the card whatever the ray count (the wrapper picks the
//   least power of two whose grid covers one resident wave,
//   rtt_dense_wave).  Each range keeps its first strict minimum in index
//   order; a second small kernel, launched after it when split > 1
//   (dense_merge_kernel, rtt_dense_merge), takes the least t over the
//   ranges in range order, which is the lexicographic (t, index) minimum:
//   the first index of the least root, for every split.
// * A block is 2 warpgroups of 64 rays each, on the same range.  The
//   range is brought into shared memory DTILE spheres at a time by bulk
//   copies (cp.async.bulk on an mbarrier, double-buffered), split once
//   into TF32 big and residual parts as it is staged, and kept for all
//   `iters` scans (the repeats run inside the tile; each thread still sees
//   its spheres in increasing index order).
// * The products are wgmma.mma_async m64n32k8 TF32 (32 spheres), both
//   operands K-major in shared memory: rays are M (each warpgroup's [d; 0]
//   and [o; -1] parts, written once), spheres N.  HIGHEST (3xTF32) packs
//   the residual terms along K, [d_lo | d_hi] . [c_hi ; c_lo], then adds
//   the big term [d_hi | 0] . [c_hi ; c_lo] last: 2 instructions a
//   product.  DEFAULT (one TF32 pass) is the second alone.  Rays as M keep
//   2 rays' constants in a thread (spheres as M would need 16 at N = 64),
//   and N = 32 with A in shared memory keeps the kernel at 61 registers, 4
//   blocks an SM (N = 64 took 94 registers and was slower).
//   -DRTT_DENSE_WGMMA=0 builds the same kernel with mma.sync m16n8k4
//   products instead (3 a product at HIGHEST, no K padding; A in
//   registers), for chip_measure.py's sweep.
// * The epilogue runs on the accumulator fragments (a thread: 2 rays x 8
//   spheres a product) and takes the square root, the roots and the
//   selects only where disc > 0, which the take needs anyway: the same
//   (t, index), bit for bit (-DRTT_DENSE_SKIP_MISS=0 computes every root).
//   One branch covers 2 pairs, so the warp's miss path has two pairs'
//   independent arithmetic between branches (a branch a pair was slower).  c0 is one
//   fused multiply-add, equal to the twin's o2 - 2m (2m is exact); disc
//   is not fused, as the twin rounds it.
#include <cstdint>
#include <cuda_runtime.h>

#include "rtt_common.cuh"

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

// ---- dense_hit_kernel ----

#ifndef RTT_DENSE_WGMMA
#define RTT_DENSE_WGMMA 1
#endif
#ifndef RTT_DENSE_SKIP_MISS
#define RTT_DENSE_SKIP_MISS 1
#endif
constexpr int DWG = 2;       // warpgroups a block
constexpr int DBLOCK = 128 * DWG;
constexpr int DRAYS = 64;    // rays a warpgroup: the products' M
constexpr int DN = 32;       // spheres a product: its N
constexpr int DACC = DN / 2;  // accumulators a thread, a product
constexpr int DTILE = 256;   // spheres staged in shared memory at a time
constexpr int DALIGN = 16;   // a range starts at a multiple of 16 spheres
constexpr int MAX_SPLIT = 64;

// round to TF32, nearest with ties away (the tensor cores read the top 19
// bits of the register)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// the operand layout in shared memory (K-major, unswizzled): for each
// group of 8 rows (rays or spheres), 8 x 16-byte rows of K 0-3, then 8 of
// K 4-7, so row j's K k is at float (j / 8) * 64 + (k / 4) * 32 +
// (j % 8) * 4 + k % 4
__device__ __forceinline__ int kmajor_at(int j, int k) {
  return (j >> 3) * 64 + (k >> 2) * 32 + (j & 7) * 4 + (k & 3);
}

#if RTT_DENSE_WGMMA
// keep the compiler from moving reads of an accumulator above the wait
__device__ __forceinline__ void fence_operand(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}

// wgmma descriptor of that layout: the two core matrices along K 128 bytes
// apart (leading byte offset), groups of 8 rows 256 bytes apart (stride
// byte offset), both in units of 16 bytes; no swizzle
__device__ __forceinline__ uint64_t kmajor_desc(const float* p) {
  const uint64_t a = rtt::smem_addr(p);
  return ((a & 0x3FFFFu) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// d (+)= A (64 rays x K 8) * B (K 8 x 32 spheres), both in shared memory,
// TF32 in, FP32 accumulate; accumulate == 0 ignores d
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], uint64_t adesc,
                                           uint64_t bdesc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(adesc), "l"(bdesc), "r"(accumulate));
}
#else
// d = A (16 rays x K 4) * B (K 4 x 8 spheres) (+ d), mma.sync TF32
__device__ __forceinline__ void mma_k4(float& d0, float& d1, float& d2,
                                       float& d3, uint32_t a0, uint32_t a1,
                                       uint32_t b, bool accumulate) {
  if (accumulate) {
    asm volatile(
        "mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
        : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
        : "r"(a0), "r"(a1), "r"(b));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%7,%7,%7,%7};\n"
        : "=f"(d0), "=f"(d1), "=f"(d2), "=f"(d3)
        : "r"(a0), "r"(a1), "r"(b), "f"(0.0f));
  }
}
#endif

// the epilogue of one product: spheres sb + 8 (k / 4) + (k & 1) for
// accumulator k, in increasing order for each ray, one branch for 2
// pairs
__device__ __forceinline__ void epilogue(const float (&dc)[DACC],
                                         const float (&mm)[DACC], int sb,
                                         int s_hi, const float (&ra)[2],
                                         const float (&rinv)[2],
                                         const float (&rdo)[2],
                                         const float (&ro2)[2],
                                         float (&best)[2], int (&bidx)[2]) {
#pragma unroll
  for (int k0 = 0; k0 < DACC; k0 += 2) {
    float hv[2], hh[2], ac[2];
    bool any = false;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int k = k0 + i, r = (k >> 1) & 1;
      hv[i] = dc[k] - rdo[r];
      // o2 - 2m in one rounding, as the twin's (2m is exact)
      const float c0 = __fmaf_rn(-2.0f, mm[k], ro2[r]);
      hh[i] = hv[i] * hv[i];
      ac[i] = ra[r] * c0;
      // disc = hh - ac > 0 exactly when hh > ac (two unequal floats never
      // differ by 0), so a miss takes no subtraction
      any |= hh[i] > ac[i];
    }
    if (RTT_DENSE_SKIP_MISS && !any) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int k = k0 + i, r = (k >> 1) & 1;
      if (RTT_DENSE_SKIP_MISS && !(hh[i] > ac[i])) continue;
      const float h = hv[i], disc = hh[i] - ac[i];
      const float sq = sqrtf(fmaxf(disc, 0.0f));
      const float tn = (h - sq) * rinv[r];
      const float tf = (h + sq) * rinv[r];
      const float root = (tn > T_MIN && tn < T_MAX) ? tn : tf;
      const int s = sb + 8 * (k >> 2) + (k & 1);
      if (disc > 0.0f && root > T_MIN && root < T_MAX && root < best[r] &&
          s < s_hi) {
        best[r] = root;
        bidx[r] = s;
      }
    }
  }
}

// Fragments (PTX ISA; lane = 4 g + q, warp w of the warpgroup): the
// accumulator d[4j + e] is ray 16w + g + 8 (e >> 1), sphere 8j + 2q +
// (e & 1) of the product's N, so every thread sees its spheres in
// increasing order; mma.sync's A holds ray 16w + g (+ 8), K q.
template <bool HIGHEST>
__global__ void __launch_bounds__(DBLOCK) dense_hit_kernel(
    const float* __restrict__ dtab, int ns, int part,
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz, int iters,
    float* __restrict__ bt_out, int* __restrict__ bi_out, int n_rays) {
  // the staged tile: sphere j's big parts at K 0-3, residual parts at 4-7
  __shared__ __align__(128) float conv[DTILE * 8];
  __shared__ __align__(128) float raw[2][4][DTILE];
  __shared__ __align__(8) uint64_t bar[2];
#if RTT_DENSE_WGMMA
  // each warpgroup's A operands, in conv's layout: [d_lo | d_hi],
  // [d_hi | 0], [o_lo | o_hi], [o_hi | 0] for its 64 rays
  __shared__ __align__(128) float aop[DWG][4][DRAYS * 8];
#endif
  const int tid = threadIdx.x;
  const int lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int w = (tid >> 5) & 3, wg = tid >> 7;
  // this block's range of spheres
  const int s_lo = min(ns, (int)blockIdx.y * part);
  const int s_hi = min(ns, s_lo + part);
  const int n_tiles = (s_hi - s_lo + DTILE - 1) / DTILE;
  // rows 0-3 of tile t into raw[t & 1], completing on bar[t & 1] (rows 4-7
  // of the table are its zero padding, which the products leave out)
  auto stage = [&](int t) {
    const int s0 = s_lo + t * DTILE;
    const uint32_t bytes = 4u * (uint32_t)min(DTILE, s_hi - s0);
    rtt::mbar_expect_tx(&bar[t & 1], 4u * bytes);
    for (int k = 0; k < 4; ++k)
      rtt::bulk_g2s(raw[t & 1][k], dtab + (size_t)k * ns + s0, bytes,
                    &bar[t & 1]);
  };
  if (tid == 0) {
    rtt::mbar_init(&bar[0], 1);
    rtt::mbar_init(&bar[1], 1);
  }
  __syncthreads();
  if (tid == 0)
    for (int t = 0; t < min(2, n_tiles); ++t) stage(t);

  // the thread's two rays (n_rays is a multiple of a block's rays) and
  // component q of their [d; 0] and [o; -1], big and residual parts
  const int r_base = ((int)blockIdx.x * DWG + wg) * DRAYS + 16 * w + g;
  const int rr[2] = {r_base, r_base + 8};
  uint32_t d_hi[2], d_lo[2], o_hi[2], o_lo[2];
  float ra[2], rinv[2], rdo[2], ro2[2], best[2];
  int bidx[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = rr[j];
    const float x = ox[r], y = oy[r], z = oz[r];
    const float ddx = dx[r], ddy = dy[r], ddz = dz[r];
    const float dv = q == 0 ? ddx : q == 1 ? ddy : q == 2 ? ddz : 0.0f;
    const float ov = q == 0 ? x : q == 1 ? y : q == 2 ? z : -1.0f;
    d_hi[j] = to_tf32(dv);
    o_hi[j] = to_tf32(ov);
    d_lo[j] = to_tf32(dv - __uint_as_float(d_hi[j]));
    o_lo[j] = to_tf32(ov - __uint_as_float(o_hi[j]));
#if RTT_DENSE_WGMMA
    const int row = 16 * w + g + 8 * j;  // the ray's row of A
    float* a = aop[wg][0];
    a[kmajor_at(row, q)] = __uint_as_float(d_lo[j]);
    a[kmajor_at(row, q + 4)] = __uint_as_float(d_hi[j]);
    a += DRAYS * 8;
    a[kmajor_at(row, q)] = __uint_as_float(d_hi[j]);
    a[kmajor_at(row, q + 4)] = 0.0f;
    a += DRAYS * 8;
    a[kmajor_at(row, q)] = __uint_as_float(o_lo[j]);
    a[kmajor_at(row, q + 4)] = __uint_as_float(o_hi[j]);
    a += DRAYS * 8;
    a[kmajor_at(row, q)] = __uint_as_float(o_hi[j]);
    a[kmajor_at(row, q + 4)] = 0.0f;
#endif
    // the epilogue's per-ray terms, as the twin computes them
    ra[j] = ddx * ddx + ddy * ddy + ddz * ddz;
    rinv[j] = 1.0f / ra[j];
    rdo[j] = ddx * x + ddy * y + ddz * z;
    ro2[j] = x * x + y * y + z * z;
    best[j] = BIG;
    bidx[j] = NO_ROW;
  }
  float dc[DACC], mm[DACC];
#pragma unroll
  for (int k = 0; k < DACC; ++k) dc[k] = mm[k] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const int s0 = s_lo + t * DTILE;
    const int m = min(DTILE, s_hi - s0);
    const int mc = (m + DN - 1) / DN * DN;  // padded to whole products
    rtt::mbar_wait(&bar[t & 1], (t >> 1) & 1);
    for (int j = tid; j < mc; j += DBLOCK) {
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (j < m) {
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = raw[t & 1][k][j];
      }
      float hi[4], lo[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        hi[k] = __uint_as_float(to_tf32(v[k]));
        lo[k] = __uint_as_float(to_tf32(v[k] - hi[k]));
      }
      *reinterpret_cast<float4*>(conv + kmajor_at(j, 0)) =
          make_float4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<float4*>(conv + kmajor_at(j, 4)) =
          make_float4(lo[0], lo[1], lo[2], lo[3]);
    }
    // the generic-proxy stores above (and the A operands), before the
    // tensor cores read them
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid == 0 && t + 2 < n_tiles) stage(t + 2);  // raw[t & 1] is free

    for (int it = 0; it < iters; ++it) {
      for (int c = 0; c < mc; c += DN) {
#if RTT_DENSE_WGMMA
        const uint64_t b = kmajor_desc(conv + c * 8);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        if (HIGHEST) {  // the residual terms first, the big one last
          wgmma_tf32(dc, kmajor_desc(aop[wg][0]), b, 0);
          wgmma_tf32(dc, kmajor_desc(aop[wg][1]), b, 1);
          wgmma_tf32(mm, kmajor_desc(aop[wg][2]), b, 0);
          wgmma_tf32(mm, kmajor_desc(aop[wg][3]), b, 1);
        } else {
          wgmma_tf32(dc, kmajor_desc(aop[wg][1]), b, 0);
          wgmma_tf32(mm, kmajor_desc(aop[wg][3]), b, 0);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
        for (int k = 0; k < DACC; ++k) {
          fence_operand(dc[k]);
          fence_operand(mm[k]);
        }
#else
#pragma unroll
        for (int j = 0; j < DN / 8; ++j) {
          const float* b = conv + kmajor_at(c + 8 * j + g, q);
          const uint32_t bh = __float_as_uint(b[0]);
          const uint32_t bl = __float_as_uint(b[32]);
          float* e = dc + 4 * j;
          float* f = mm + 4 * j;
          if (HIGHEST) {  // d_hi c_lo + d_lo c_hi, then d_hi c_hi
            mma_k4(e[0], e[1], e[2], e[3], d_hi[0], d_hi[1], bl, false);
            mma_k4(e[0], e[1], e[2], e[3], d_lo[0], d_lo[1], bh, true);
            mma_k4(e[0], e[1], e[2], e[3], d_hi[0], d_hi[1], bh, true);
            mma_k4(f[0], f[1], f[2], f[3], o_hi[0], o_hi[1], bl, false);
            mma_k4(f[0], f[1], f[2], f[3], o_lo[0], o_lo[1], bh, true);
            mma_k4(f[0], f[1], f[2], f[3], o_hi[0], o_hi[1], bh, true);
          } else {
            mma_k4(e[0], e[1], e[2], e[3], d_hi[0], d_hi[1], bh, false);
            mma_k4(f[0], f[1], f[2], f[3], o_hi[0], o_hi[1], bh, false);
          }
        }
#endif
        epilogue(dc, mm, s0 + c + 2 * q, s_hi, ra, rinv, rdo, ro2, best,
                 bidx);
      }
    }
    __syncthreads();  // every warpgroup is done with conv
  }
  // the lexicographic minimum of (t, index) over the 4 lanes of a ray
  // (same g), then this range's result for the ray
  const size_t o = (size_t)blockIdx.y * n_rays;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float ot = __shfl_xor_sync(FULL_MASK, best[j], off);
      const int oi = __shfl_xor_sync(FULL_MASK, bidx[j], off);
      if (ot < best[j] || (ot == best[j] && oi < bidx[j])) {
        best[j] = ot;
        bidx[j] = oi;
      }
    }
    if (q == 0) {
      bt_out[o + rr[j]] = best[j];
      bi_out[o + rr[j]] = bidx[j] == NO_ROW ? -1 : bidx[j];
    }
  }
}

// the ranges' results [split, n] in range order, a strict "<": the least t
// at the lowest index, since every index of a range is below the next's
__global__ void dense_merge_kernel(const float* __restrict__ pt,
                                   const int* __restrict__ pi, int split,
                                   int n, float* __restrict__ bt_out,
                                   int* __restrict__ bi_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  float bt = pt[r];
  int bi = pi[r];
  for (int p = 1; p < split; ++p) {
    const float t = pt[(size_t)p * n + r];
    if (t < bt) {
      bt = t;
      bi = pi[(size_t)p * n + r];
    }
  }
  bt_out[r] = bt;
  bi_out[r] = bi;
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

// Rays of one resident wave of dense_hit_kernel<highest> (the SMs times
// the blocks an SM holds times the rays a block), from which the wrapper
// picks the split; negative on a CUDA error.
extern "C" int rtt_dense_wave(int highest) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm,
        highest ? dense_hit_kernel<true> : dense_hit_kernel<false>, DBLOCK,
        0);
  if (e != cudaSuccess) return -(int)e;
  return sms * per_sm * DWG * DRAYS;
}

// `split` ranges of the sphere axis (a power of two up to MAX_SPLIT);
// range p writes its (t, index) to row p of bt / bi [split, n_rays], which
// rtt_dense_merge reduces when split > 1
extern "C" int rtt_dense_hit(const float* dtab, int ns, const float* ox,
                             const float* oy, const float* oz,
                             const float* dx, const float* dy,
                             const float* dz, int iters, int highest,
                             int split, float* bt_out, int* bi_out,
                             int n_rays, void* stream) {
  if (n_rays > 0) {
    if (split < 1 || split > MAX_SPLIT || (split & (split - 1)) ||
        n_rays % (DWG * DRAYS) || ns % DALIGN || iters < 1)
      return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const int part =
        ((ns + split - 1) / split + DALIGN - 1) / DALIGN * DALIGN;
    const dim3 grid(n_rays / (DWG * DRAYS), split);
    if (highest) {
      dense_hit_kernel<true><<<grid, DBLOCK, 0, st>>>(
          dtab, ns, part, ox, oy, oz, dx, dy, dz, iters, bt_out, bi_out,
          n_rays);
    } else {
      dense_hit_kernel<false><<<grid, DBLOCK, 0, st>>>(
          dtab, ns, part, ox, oy, oz, dx, dy, dz, iters, bt_out, bi_out,
          n_rays);
    }
  }
  return (int)cudaGetLastError();
}

// the ranges' results pt / pi [split, n_rays] -> bt / bi [n_rays]
extern "C" int rtt_dense_merge(const float* pt, const int* pi, int split,
                               float* bt_out, int* bi_out, int n_rays,
                               void* stream) {
  if (n_rays > 0) {
    if (split < 1) return (int)cudaErrorInvalidValue;
    dense_merge_kernel<<<(n_rays + 255) / 256, 256, 0,
                         (cudaStream_t)stream>>>(pt, pi, split, n_rays,
                                                 bt_out, bi_out);
  }
  return (int)cudaGetLastError();
}
