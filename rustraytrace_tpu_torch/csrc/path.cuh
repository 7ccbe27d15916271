// The path tracer's device side, shared by the persist kernel (K2,
// persist.cu), the respawn megakernel (K3, megakernel.cu), the monolithic
// megakernel (K4, mono.cu) and the per-bounce segment kernel (K5,
// segment.cu): closest hit over spheres (SAH cluster cull), then boxes
// (box-cluster cull), then quads (SAH quad-cluster cull from 32 quads),
// then constant media; one bounce of the path or the NEE/MIS estimator;
// the camera spawn; and the per-lane step {bank a finished path, respawn
// the next camera ray, one bounce}.
//
// Counterparts: intersect / bounce_body / spawn_rays / pbody of _make_kernel,
// rustraytrace_tpu/ops/pallas_megakernel.py:714-1991.  Plain twin:
// ops/wavefront.py (_intersect_plain, _bounce_plain, spawn_rays,
// _iteration_plain); every expression is written in the twin's order (see
// rtt_common.cuh), so kernel and twin are bitwise equal.
//
// Every function is templated on BOOK2: the Book-2 features (motion blur,
// boxes, constant media, checker, Perlin-marble and image textures) are
// compiled only into the BOOK2 instances, so the Book-1 and Book-3 scenes
// run the code they ran before those features existed.  Image texels are
// fetched in the kernel (a global load), and the texel multiplies the
// albedo before Russian roulette, as the JAX package's XLA trace_path does;
// its Pallas kernel deferred the texel past the roulette (same estimator,
// other variance).
//
// Random numbers are Philox keyed by (slot, absolute sample index, bounce,
// stream): a lane's path does not depend on the launch, the sorted position
// or the kernel (K2, K3, K4 or K5) that runs it.
#pragma once

#include "rtt_common.cuh"

namespace rtt {

// joined sphere table columns (ops/megakernel.py J_*)
constexpr int J_COLS = 24;
constexpr int J_CX = 0, J_VX = 4, J_INVR = 7, J_KIND = 8, J_AR = 9,
              J_FUZZ = 12, J_IOR = 13, J_TEXK = 14, J_C2R = 15, J_INVS = 18,
              J_IMG = 19;
// quad texture columns (ops/hit.py Q_*)
constexpr int Q_TEXK = 22, Q_C2R = 23, Q_INVS = 26, Q_IMG = 27;
// box winner attributes (ops/megakernel.py BA_*)
constexpr int BA_COLS = 12;
constexpr int BA_KIND = 0, BA_AR = 1, BA_FUZZ = 4, BA_IOR = 5, BA_TEXK = 6,
              BA_C2R = 7, BA_INVS = 10;
// constant-media table columns (ops/megakernel.py M_*)
constexpr int M_COLS = 24;
constexpr int M_KIND = 0, M_CX = 1, M_R2 = 4, M_NID = 5, M_AR = 6,
              M_COS = 9, M_SIN = 10, M_LOX = 11, M_HIX = 14;
// light table columns (ops/megakernel.py L_*)
constexpr int L_COLS = 24;
constexpr int L_KIND = 0, L_QX = 1, L_UX = 4, L_VX = 7, L_WX = 10,
              L_NX = 13, L_DP = 16, L_AREA = 17, L_CX = 18, L_RAD = 21;
constexpr int BLK = 32;  // screen swizzle block
constexpr int RR_START_BOUNCE = 5;
constexpr float INV_PI = 0.3183098861837907f;
// sphere UV constants as the JAX XLA sphere_uv rounds them to f32
constexpr float UV_PI = 3.1415927f, UV_TWO_PI = 6.2831855f;

// Everything a launch reads besides the lane state.  The layout is mirrored
// by ops/_cuda.py PathParams (checked against rtt_params_size at load).
struct Params {
  const float4* geom;  // [N] cx, cy, cz, r2 in cluster order
  const float4* gvel;  // [N] vx, vy, vz, 0 (read for moving spheres)
  const float* tab;    // [N, 24] joined sphere + material table
  int n_rows;
  const float* clb;  // [C, 8] cluster lo3, hi3
  const int* cls;    // [C+1] cluster starts / unroll
  int n_clusters;
  const float* sclb;  // [S, 8] super-cluster bounds
  const int* scls;    // [S+1] super-cluster starts (in clusters)
  int n_sclusters;
  int n_ssc_static;  // leading super-clusters of static spheres (split)
  int unroll;
  // [Q + QC, 32] quad frames + materials; with n_qclusters > 1 the rows
  // are in quad-cluster order and QC metadata rows [lo3, hi3, start, end]
  // follow the Q quad rows
  const float* qtab;
  int n_quads, n_qclusters;
  const float* ltab;  // [L, 24] NEE light table
  int n_lights;
  const float* btab;  // [NB, 8] box lo3, hi3 in box-cluster order
  const float* batt;  // [NB, 12] box winner attributes
  const float* bclb;  // [CB, 8] box-cluster bounds
  const int* bcls;    // [CB+1] box-cluster starts / b_unroll
  int n_boxes, n_bclusters, b_unroll;
  const float* mtab;  // [M, 24] constant media
  int n_media;
  const int* perm;       // [3, 256] Perlin permutations
  const float* randvec;  // [256, 3] Perlin lattice vectors
  const float* texels;   // [T, 3] image texels, image-major
  const int* img_meta;   // [NI, 3] base, w, h of each image
  int n_images;
  const float* cam;  // [20] center, pixel00, du, dv, disk u, v
  const float* bg;   // [4] flat background
  int sky_bg, defocus, width, height, spp, max_depth, stratified, sqrt_spp;
  int moving, has_checker, has_noise, has_image;
  uint32_t k0, k1;
  int sample_offset;
  // [11] work counters (ops/megakernel.py WORK_NAMES), read by the COUNT
  // instances only; null otherwise
  unsigned long long* work;
  // [n_warps, 2] each warp's first start and last finish (globaltimer ns),
  // kept by atomicMin / atomicMax: read by the COUNT instances only, where
  // not null; the caller fills the starts with ~0 and the finishes with 0
  unsigned long long* warp_t;
};

constexpr int N_WORK = 11;

// The cooperative leaf scan's T (intersect<BOOK2, true>; K2, K3, K4): a
// cluster that at most this many lanes of a warp need is scanned by the
// whole warp for each of them in turn.  Fixed from sweeps on the H100
// (chip_measure.py --kernels for K2 and --mega-sweep for K3 and K4, which
// build with -DRTT_COOP_LANES=T): 12 is the best of those measured for
// both.
#ifndef RTT_COOP_LANES
#define RTT_COOP_LANES 12
#endif
constexpr int COOP_LANES = RTT_COOP_LANES;

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Per-thread work counts, added to Params::work once at the end.  The
// kernels are instantiated with COUNT = false for every timed launch, where
// each count is a no-op and the compiler drops the fields; COUNT = true only
// where a caller passes Params::work.
template <bool COUNT>
struct Work {
  uint32_t n[N_WORK] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  unsigned long long t0 = 0;  // the thread's start (COUNT)
  __device__ Work() {
    if constexpr (COUNT) t0 = globaltimer();
  }
  __device__ __forceinline__ void add(int k, int v) {
    if constexpr (COUNT) n[k] += (uint32_t)v;
  }
  __device__ __forceinline__ void bounce() { add(0, 1); }
  __device__ __forceinline__ void sphere_rows(int v) { add(1, v); }
  __device__ __forceinline__ void box() { add(2, 1); }
  __device__ __forceinline__ void box_rows(int v) { add(3, v); }
  __device__ __forceinline__ void medium() { add(4, 1); }
  __device__ __forceinline__ void noise() { add(5, 1); }
  __device__ __forceinline__ void texel() { add(6, 1); }
  __device__ __forceinline__ void quad_rows(int v) { add(7, v); }
  // sphere rows as the warp issues them: a cluster's rows once for the
  // lanes that run its scan together (those of the active mask whose box
  // test passed), added by one of them; sphere_rows / (32 x this) is the
  // SIMT efficiency of the leaf scans
  __device__ __forceinline__ void warp_rows(bool need, int rows) {
    if constexpr (COUNT) {
      const unsigned m = __activemask();
      if (__ballot_sync(m, need) && (threadIdx.x & 31) == __ffs(m) - 1)
        add(8, rows);
    }
  }
  // the same count where the whole warp takes the decision together (K2):
  // one lane adds the row steps the warp issues for a cluster
  __device__ __forceinline__ void warp_steps(int v) {
    if ((threadIdx.x & 31) == 0) add(8, v);
  }
  // the lane-use share of a megakernel: lane_steps / (32 x warp_steps), the
  // iterations in which a lane had work over the lanes the warp's
  // iterations carried
  __device__ __forceinline__ void lane_step(bool act) { add(9, act ? 1 : 0); }
  __device__ __forceinline__ void warp_iters(int v) {
    if ((threadIdx.x & 31) == 0) add(10, v);
  }
  __device__ __forceinline__ void flush(const Params& P) const {
    if constexpr (COUNT) {
#pragma unroll
      for (int k = 0; k < N_WORK; ++k)
        atomicAdd(P.work + k, (unsigned long long)n[k]);
      if (P.warp_t != nullptr) {
        const size_t w = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) / 32;
        atomicMin(P.warp_t + 2 * w, t0);
        atomicMax(P.warp_t + 2 * w + 1, globaltimer());
      }
    }
  }
};

// slab entry and exit of an AABB b = [lo3, hi3]
__device__ __forceinline__ void slab(const float* b, float ox, float oy,
                                     float oz, float ivx, float ivy,
                                     float ivz, float* t1, float* t2) {
  const float tx1 = (b[0] - ox) * ivx;
  const float tx2 = (b[3] - ox) * ivx;
  const float ty1 = (b[1] - oy) * ivy;
  const float ty2 = (b[4] - oy) * ivy;
  const float tz1 = (b[2] - oz) * ivz;
  const float tz2 = (b[5] - oz) * ivz;
  *t1 = fmaxf(fmaxf(fminf(tx1, tx2), fminf(ty1, ty2)), fminf(tz1, tz2));
  *t2 = fminf(fminf(fmaxf(tx1, tx2), fmaxf(ty1, ty2)), fmaxf(tz1, tz2));
}

// slab test of an AABB [lo3, hi3] against the ray, entry before best t
__device__ __forceinline__ bool box_hit(const float* b, float ox, float oy,
                                        float oz, float ivx, float ivy,
                                        float ivz, float bt) {
  float t1, t2;
  slab(b, ox, oy, oz, ivx, ivy, ivz, &t1, &t2);
  return (t1 <= t2) && (t2 > T_MIN) && (t1 < bt);
}

template <bool MV, class WorkT>
__device__ __forceinline__ void scan_spheres(const Params& P, int lo, int hi,
                                             float tm, float ox, float oy,
                                             float oz, float dx, float dy,
                                             float dz, float a, float inv_a,
                                             float* bt, int* bi, WorkT& W) {
  W.sphere_rows(hi - lo);
  for (int s = lo; s < hi; ++s) {
    const float4 g = P.geom[s];
    float cx = g.x, cy = g.y, cz = g.z;
    if constexpr (MV) {
      // center at the ray's time (sphere.rs:30-35)
      const float4 v = P.gvel[s];
      cx = cx + tm * v.x;
      cy = cy + tm * v.y;
      cz = cz + tm * v.z;
    }
    bool ok;
    const float root = sphere_root(cx, cy, cz, g.w, ox, oy, oz, dx, dy, dz,
                                   a, inv_a, &ok);
    if (ok && root < *bt) {
      *bt = root;
      *bi = s;
    }
  }
}

// one SAH cluster's sphere rows, with or without the motion reads
template <bool BOOK2, class WorkT>
__device__ __forceinline__ void scan_cluster(const Params& P, int c, bool mv,
                                             float tm, float ox, float oy,
                                             float oz, float dx, float dy,
                                             float dz, float a, float inv_a,
                                             float* bt, int* bi, WorkT& W) {
  const int lo = P.cls[c] * P.unroll, hi = P.cls[c + 1] * P.unroll;
  if (BOOK2 && mv)
    scan_spheres<true>(P, lo, hi, tm, ox, oy, oz, dx, dy, dz, a, inv_a, bt,
                       bi, W);
  else
    scan_spheres<false>(P, lo, hi, tm, ox, oy, oz, dx, dy, dz, a, inv_a, bt,
                        bi, W);
}

// 1 / d with |d| raised to 1e-20, its sign kept (slab tests)
__device__ __forceinline__ float safe_inv(float d) {
  const float sg = d < 0.0f ? -1e-20f : 1e-20f;
  return 1.0f / (fabsf(d) < 1e-20f ? sg : d);
}

// box primitives [lo, hi) of the box table (pallas_megakernel.py:843-871):
// the entry face if its t is in (T_MIN, T_MAX), else the exit face
template <class WorkT>
__device__ __forceinline__ void scan_boxes(const Params& P, int lo, int hi,
                                           float ox, float oy, float oz,
                                           float ivx, float ivy, float ivz,
                                           float* bt, int* bi, WorkT& W) {
  W.box_rows(hi - lo);
  for (int k = lo; k < hi; ++k) {
    float t1, t2;
    slab(P.btab + 8 * k, ox, oy, oz, ivx, ivy, ivz, &t1, &t2);
    const bool near_ok = t1 > T_MIN && t1 < T_MAX;
    const float root = near_ok ? t1 : t2;
    if (t1 < t2 && root > T_MIN && root < T_MAX && root < *bt) {
      *bt = root;
      *bi = k;
    }
  }
}

// quad rows [lo, hi) of the quad table, strict "<" in table order
template <class WorkT>
__device__ __forceinline__ void scan_quads(const Params& P, int lo, int hi,
                                           float ox, float oy, float oz,
                                           float dx, float dy, float dz,
                                           float* bt, int* bi, WorkT& W) {
  W.quad_rows(hi - lo);
  for (int q = lo; q < hi; ++q) {
    bool ok;
    const float tq = quad_hit(P.qtab + q * Q_COLS, ox, oy, oz, dx, dy, dz,
                              &ok);
    if (ok && tq < *bt) {
      *bt = tq;
      *bi = q;
    }
  }
}

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int NO_ROW = 0x7fffffff;

// The warp's lexicographic minimum of (t, row), in every lane: the least t
// and the lowest row at it (an xor butterfly of five steps).
__device__ __forceinline__ void warp_min_lex(float* t, int* row) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ot = __shfl_xor_sync(FULL_MASK, *t, off);
    const int orow = __shfl_xor_sync(FULL_MASK, *row, off);
    if (ot < *t || (ot == *t && orow < *row)) {
      *t = ot;
      *row = orow;
    }
  }
}

// The warp-cooperative scan of sphere rows [lo, hi) for the lanes of
// `need` (a ballot; the whole warp calls it): the ray of each needing lane
// in turn is broadcast, lane k tests rows lo + k, lo + k + 32, ... with the
// same sphere_root, keeping its first strict minimum, and the warp's
// lexicographic minimum of (root, row) goes back to the needing lane, which
// takes it if it is below its best t.  That minimum is the first row at the
// least root, so the result is scan_spheres's bitwise.
template <bool MV>
__device__ __forceinline__ void scan_spheres_warp(
    const Params& P, int lo, int hi, unsigned need, float tm, float ox,
    float oy, float oz, float dx, float dy, float dz, float a, float inv_a,
    float* bt, int* bi) {
  const int lane = threadIdx.x & 31;
  while (need) {
    const int src = __ffs(need) - 1;
    need &= need - 1;
    const float rtm = MV ? __shfl_sync(FULL_MASK, tm, src) : 0.0f;
    const float rox = __shfl_sync(FULL_MASK, ox, src);
    const float roy = __shfl_sync(FULL_MASK, oy, src);
    const float roz = __shfl_sync(FULL_MASK, oz, src);
    const float rdx = __shfl_sync(FULL_MASK, dx, src);
    const float rdy = __shfl_sync(FULL_MASK, dy, src);
    const float rdz = __shfl_sync(FULL_MASK, dz, src);
    const float ra = __shfl_sync(FULL_MASK, a, src);
    const float rinv = __shfl_sync(FULL_MASK, inv_a, src);
    float best = BIG;
    int row = NO_ROW;
    for (int s = lo + lane; s < hi; s += 32) {
      const float4 g = P.geom[s];
      float cx = g.x, cy = g.y, cz = g.z;
      if constexpr (MV) {
        const float4 v = P.gvel[s];
        cx = cx + rtm * v.x;
        cy = cy + rtm * v.y;
        cz = cz + rtm * v.z;
      }
      bool ok;
      const float root = sphere_root(cx, cy, cz, g.w, rox, roy, roz, rdx,
                                     rdy, rdz, ra, rinv, &ok);
      if (ok && root < best) {
        best = root;
        row = s;
      }
    }
    warp_min_lex(&best, &row);
    if (lane == src && best < *bt) {
      *bt = best;
      *bi = row;
    }
  }
}

// The same for box rows [lo, hi) (scan_boxes's test)
__device__ __forceinline__ void scan_boxes_warp(const Params& P, int lo,
                                                int hi, unsigned need,
                                                float ox, float oy, float oz,
                                                float ivx, float ivy,
                                                float ivz, float* bt,
                                                int* bi) {
  const int lane = threadIdx.x & 31;
  while (need) {
    const int src = __ffs(need) - 1;
    need &= need - 1;
    const float rox = __shfl_sync(FULL_MASK, ox, src);
    const float roy = __shfl_sync(FULL_MASK, oy, src);
    const float roz = __shfl_sync(FULL_MASK, oz, src);
    const float rix = __shfl_sync(FULL_MASK, ivx, src);
    const float riy = __shfl_sync(FULL_MASK, ivy, src);
    const float riz = __shfl_sync(FULL_MASK, ivz, src);
    float best = BIG;
    int row = NO_ROW;
    for (int k = lo + lane; k < hi; k += 32) {
      float t1, t2;
      slab(P.btab + 8 * k, rox, roy, roz, rix, riy, riz, &t1, &t2);
      const bool near_ok = t1 > T_MIN && t1 < T_MAX;
      const float root = near_ok ? t1 : t2;
      if (t1 < t2 && root > T_MIN && root < T_MAX && root < best) {
        best = root;
        row = k;
      }
    }
    warp_min_lex(&best, &row);
    if (lane == src && best < *bt) {
      *bt = best;
      *bi = row;
    }
  }
}

// One sphere cluster for the lanes of `need` (the warp's ballot of box
// hits; `in_c` is this lane's bit): cooperatively when at most
// COOP_LANES lanes need it, else each needing lane scans the rows itself
// while the rest wait (the warp issues them once for all).  The branch is
// uniform across the warp.
template <bool BOOK2, class WorkT>
__device__ __forceinline__ void cluster_warp(const Params& P, int c, bool mv,
                                             bool in_c, unsigned need,
                                             float tm, float ox, float oy,
                                             float oz, float dx, float dy,
                                             float dz, float a, float inv_a,
                                             float* bt, int* bi, WorkT& W) {
  const int lo = P.cls[c] * P.unroll, hi = P.cls[c + 1] * P.unroll;
  const int k = __popc(need);
  if (k <= COOP_LANES) {
    if (in_c) W.sphere_rows(hi - lo);
    W.warp_steps(k * ((hi - lo + 31) / 32));
    if (BOOK2 && mv)
      scan_spheres_warp<true>(P, lo, hi, need, tm, ox, oy, oz, dx, dy, dz, a,
                              inv_a, bt, bi);
    else
      scan_spheres_warp<false>(P, lo, hi, need, tm, ox, oy, oz, dx, dy, dz,
                               a, inv_a, bt, bi);
  } else {
    W.warp_steps(hi - lo);
    if (in_c)
      scan_cluster<BOOK2>(P, c, mv, tm, ox, oy, oz, dx, dy, dz, a, inv_a, bt,
                          bi, W);
  }
}

// One box cluster, as cluster_warp
template <class WorkT>
__device__ __forceinline__ void box_cluster_warp(const Params& P, int c,
                                                 bool in_c, unsigned need,
                                                 float ox, float oy, float oz,
                                                 float ivx, float ivy,
                                                 float ivz, float* bt,
                                                 int* bi, WorkT& W) {
  const int U = P.b_unroll;
  const int lo = P.bcls[c] * U, hi = P.bcls[c + 1] * U;
  if (__popc(need) <= COOP_LANES) {
    if (in_c) W.box_rows(hi - lo);
    scan_boxes_warp(P, lo, hi, need, ox, oy, oz, ivx, ivy, ivz, bt, bi);
  } else if (in_c) {
    scan_boxes(P, lo, hi, ox, oy, oz, ivx, ivy, ivz, bt, bi, W);
  }
}

struct Hit {
  float t;  // best t, or BIG on a miss
  int si;   // sphere winner row, or -1
  int qi;   // quad winner row, or -1
  int bi;   // box winner row, or -1 (BOOK2 only)
  int mi;   // medium winner, or -1 (BOOK2 only)
  // the final winner is the last class that set its row: medium, quad, box,
  // then sphere
};

// Closest hit: spheres first (a per-thread cull over the two-level SAH
// cluster hierarchy, the box test of pallas_megakernel.py:797), then the
// boxes (the same cull over box clusters), then the quads (every row, or
// with two or more quad clusters the same cull over their metadata rows,
// pallas_megakernel.py:1063-1098), each with a
// strict "<" in table order, so an earlier class wins a tie; then the
// constant media in table order, each free flight clipped by the running
// closest hit (pallas_megakernel.py:1100-1199).  The cull is not exactly a
// full scan: an f32 root can lie past its cluster's box (the ground
// sphere's, near its surface), and the box test then drops that hit.  The
// plain twin runs the same cull.  (s, sample, b) key the media draws.
//
// COOP (K2, K3, K4) is the warp-level form, the counterpart of the TPU
// kernel's tile-wide cull: the whole warp calls it, `live` says whether
// this lane has a ray, and each sphere or box cluster's leaf rows go
// through cluster_warp / box_cluster_warp on the warp's ballot of box
// hits.  The cluster order and every lane's box tests and
// best t are those of the per-lane form, so both give the same hit
// bitwise.  Without COOP (K5), `live` is true.
template <bool BOOK2, bool COOP, class WorkT>
__device__ inline Hit intersect(const Params& P, float tm, float ox,
                                float oy, float oz, float dx, float dy,
                                float dz, float a, float inv_a, uint32_t s,
                                uint32_t sample, uint32_t b, bool live,
                                WorkT& W) {
  float bt = BIG;
  int bi = -1;
  // moving spheres: every cluster of a moving scene, except the leading
  // static super-clusters of a split one (pallas_megakernel.py:815-827)
  const bool moving = BOOK2 && P.moving;
  const bool split =
      moving && P.n_ssc_static > 0 && P.n_ssc_static < P.n_sclusters;
  float ivx = 0.0f, ivy = 0.0f, ivz = 0.0f;
  if (P.n_clusters > 0 || (BOOK2 && P.n_boxes > 0) || P.n_qclusters > 1) {
    ivx = safe_inv(dx);
    ivy = safe_inv(dy);
    ivz = safe_inv(dz);
  }
  if (P.n_clusters > 0) {
    if (P.n_sclusters > 1) {
      for (int sc = 0; sc < P.n_sclusters; ++sc) {
        bool in_s = false;
        if (live) {
          W.box();
          in_s = box_hit(P.sclb + 8 * sc, ox, oy, oz, ivx, ivy, ivz, bt);
        }
        if constexpr (COOP) {
          if (!__any_sync(FULL_MASK, in_s)) continue;
        } else if (!in_s) {
          continue;
        }
        const bool mv = moving && !(split && sc < P.n_ssc_static);
        for (int c = P.scls[sc]; c < P.scls[sc + 1]; ++c) {
          bool in_c = false;
          if (in_s) {
            W.box();
            in_c = box_hit(P.clb + 8 * c, ox, oy, oz, ivx, ivy, ivz, bt);
          }
          if constexpr (COOP) {
            const unsigned need = __ballot_sync(FULL_MASK, in_c);
            if (need)
              cluster_warp<BOOK2>(P, c, mv, in_c, need, tm, ox, oy, oz, dx,
                                  dy, dz, a, inv_a, &bt, &bi, W);
          } else {
            W.warp_rows(in_c, (P.cls[c + 1] - P.cls[c]) * P.unroll);
            if (in_c)
              scan_cluster<BOOK2>(P, c, mv, tm, ox, oy, oz, dx, dy, dz, a,
                                  inv_a, &bt, &bi, W);
          }
        }
      }
    } else {
      for (int c = 0; c < P.n_clusters; ++c) {
        bool in_c = false;
        if (live) {
          W.box();
          in_c = box_hit(P.clb + 8 * c, ox, oy, oz, ivx, ivy, ivz, bt);
        }
        if constexpr (COOP) {
          const unsigned need = __ballot_sync(FULL_MASK, in_c);
          if (need)
            cluster_warp<BOOK2>(P, c, moving, in_c, need, tm, ox, oy, oz, dx,
                                dy, dz, a, inv_a, &bt, &bi, W);
        } else {
          W.warp_rows(in_c, (P.cls[c + 1] - P.cls[c]) * P.unroll);
          if (in_c)
            scan_cluster<BOOK2>(P, c, moving, tm, ox, oy, oz, dx, dy, dz, a,
                                inv_a, &bt, &bi, W);
        }
      }
    }
  } else if (live) {
    if (moving)
      scan_spheres<true>(P, 0, P.n_rows, tm, ox, oy, oz, dx, dy, dz, a,
                         inv_a, &bt, &bi, W);
    else
      scan_spheres<false>(P, 0, P.n_rows, tm, ox, oy, oz, dx, dy, dz, a,
                          inv_a, &bt, &bi, W);
  }
  int boxi = -1;
  if constexpr (BOOK2) {
    if (P.n_boxes > 0) {
      const int U = P.b_unroll;
      if (P.n_bclusters > 1) {
        for (int c = 0; c < P.n_bclusters; ++c) {
          bool in_c = false;
          if (live) {
            W.box();
            in_c = box_hit(P.bclb + 8 * c, ox, oy, oz, ivx, ivy, ivz, bt);
          }
          if constexpr (COOP) {
            const unsigned need = __ballot_sync(FULL_MASK, in_c);
            if (need)
              box_cluster_warp(P, c, in_c, need, ox, oy, oz, ivx, ivy, ivz,
                               &bt, &boxi, W);
          } else if (in_c) {
            scan_boxes(P, P.bcls[c] * U, P.bcls[c + 1] * U, ox, oy, oz, ivx,
                       ivy, ivz, &bt, &boxi, W);
          }
        }
      } else if (live) {
        scan_boxes(P, 0, P.n_boxes, ox, oy, oz, ivx, ivy, ivz, &bt, &boxi,
                   W);
      }
    }
  }
  int qi = -1;
  if (!live) return Hit{bt, bi, -1, boxi, -1};
  if (P.n_qclusters > 1) {
    for (int c = 0; c < P.n_qclusters; ++c) {
      W.box();
      const float* m = P.qtab + (P.n_quads + c) * Q_COLS;
      if (!box_hit(m, ox, oy, oz, ivx, ivy, ivz, bt)) continue;
      scan_quads(P, (int)m[6], (int)m[7], ox, oy, oz, dx, dy, dz, &bt, &qi,
                 W);
    }
  } else {
    scan_quads(P, 0, P.n_quads, ox, oy, oz, dx, dy, dz, &bt, &qi, W);
  }
  int mi = -1;
  if constexpr (BOOK2) {
    float4 um4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int m = 0; m < P.n_media; ++m) {
      W.medium();
      const float* mr = P.mtab + m * M_COLS;
      float t1, t2;
      bool in_ok;
      if (mr[M_KIND] < 0.5f) {
        // sphere boundary roots over (-inf, inf)
        const float ocx = mr[M_CX] - ox;
        const float ocy = mr[M_CX + 1] - oy;
        const float ocz = mr[M_CX + 2] - oz;
        const float hh = dx * ocx + dy * ocy + dz * ocz;
        const float cc = ocx * ocx + ocy * ocy + ocz * ocz - mr[M_R2];
        const float disc = hh * hh - a * cc;
        const float sqd = sqrtf(fmaxf(disc, 0.0f));
        t1 = (hh - sqd) * inv_a;
        t2 = (hh + sqd) * inv_a;
        in_ok = disc > 0.0f;
      } else {
        // oriented box: world -> local (offset, then rotate by -theta)
        const float cth = mr[M_COS], sth = mr[M_SIN];
        const float rox = ox - mr[M_CX];
        const float roz = oz - mr[M_CX + 2];
        const float lo3[3] = {cth * rox - sth * roz, oy - mr[M_CX + 1],
                              sth * rox + cth * roz};
        const float ilx = safe_inv(cth * dx - sth * dz);
        const float ily = safe_inv(dy);
        const float ilz = safe_inv(sth * dx + cth * dz);
        slab(mr + M_LOX, lo3[0], lo3[1], lo3[2], ilx, ily, ilz, &t1, &t2);
        in_ok = t1 < t2;
      }
      float t1c = fmaxf(t1, T_MIN);
      const float t2c = fminf(t2, bt);
      bool ok = in_ok && t1c < t2c;
      t1c = fmaxf(t1c, 0.0f);
      const float inv_len_m = 1.0f / sqrtf(a);
      const float dlen = a * inv_len_m;
      const float dist_inside = (t2c - t1c) * dlen;
      if ((m & 3) == 0)
        um4 = uniforms4(s, sample, b, STREAM_MEDIA + (uint32_t)(m >> 2),
                        P.k0, P.k1);
      const int w = m & 3;
      const float um = w == 0 ? um4.x : (w == 1 ? um4.y
                                                : (w == 2 ? um4.z : um4.w));
      const float hitd = mr[M_NID] * logf(fmaxf(um, 1e-12f));
      ok = ok && hitd <= dist_inside;
      const float t_med = t1c + hitd * inv_len_m;
      if (ok && t_med < bt) {
        bt = t_med;
        mi = m;
      }
    }
  }
  return Hit{bt, bi, qi, boxi, mi};
}

struct Lane {
  float tm, ox, oy, oz, dx, dy, dz, ax, ay, az, rx, ry, rz, alive, b, done,
      sx, sy, sz, mid;
};

// orthonormal basis (u, v) around unit w (onb.rs:8-18, branchless helper
// axis by |w.x| > 0.9; pallas_megakernel.py:1590-1606)
__device__ __forceinline__ void onb(float wx, float wy, float wz, float* ux,
                                    float* uy, float* uz, float* vx,
                                    float* vy, float* vz) {
  const bool big = fabsf(wx) > 0.9f;
  const float hx = big ? 0.0f : 1.0f;
  const float hy = big ? 1.0f : 0.0f;
  const float cx = -wz * hy;
  const float cy = wz * hx;
  const float cz = wx * hy - wy * hx;
  const float inv = 1.0f / sqrtf(fmaxf(cx * cx + cy * cy + cz * cz, 1e-30f));
  *vx = cx * inv;
  *vy = cy * inv;
  *vz = cz * inv;
  *ux = wy * *vz - wz * *vy;
  *uy = wz * *vx - wx * *vz;
  *uz = wx * *vy - wy * *vx;
}

// ---- Book-2 textures (texture.rs; pallas_megakernel.py:1236-1325) ----

// Perlin lattice noise at q (perlin.rs:25-98): trilinear Hermite-smoothed
// blend of the 8 corner gradients, corner indices xor-combined from the three
// permutations with "& 255" wrapping (two's complement for negative floors)
__device__ __forceinline__ float noise_at(const Params& P, float qx, float qy,
                                          float qz) {
  const float fx = floorf(qx), fy = floorf(qy), fz = floorf(qz);
  const float ux = qx - fx, uy = qy - fy, uz = qz - fz;
  const int iq = (int)fx, jq = (int)fy, kq = (int)fz;
  const float sx = ux * ux * (3.0f - 2.0f * ux);
  const float sy = uy * uy * (3.0f - 2.0f * uy);
  const float sz = uz * uz * (3.0f - 2.0f * uz);
  float acc = 0.0f;
#pragma unroll
  for (int di = 0; di < 2; ++di) {
    const int pi = P.perm[(iq + di) & 255];
    const float wxf = di ? sx : (1.0f - sx);
#pragma unroll
    for (int dj = 0; dj < 2; ++dj) {
      const int pj = P.perm[256 + ((jq + dj) & 255)];
      const float wyf = dj ? sy : (1.0f - sy);
#pragma unroll
      for (int dk = 0; dk < 2; ++dk) {
        const int pk = P.perm[512 + ((kq + dk) & 255)];
        const float* c = P.randvec + 3 * (pi ^ pj ^ pk);
        const float dot = c[0] * (ux - (float)di) + c[1] * (uy - (float)dj) +
                          c[2] * (uz - (float)dk);
        const float wzf = dk ? sz : (1.0f - sz);
        acc = acc + wxf * wyf * wzf * dot;
      }
    }
  }
  return acc;
}

// marble: 0.5 (1 + sin(scale z + 10 turb(p, 7))) (texture.rs:122-126,
// perlin.rs:50-62)
template <class WorkT>
__device__ float marble(const Params& P, float scale, float px, float py,
                        float pz, WorkT& W) {
  float tacc = 0.0f, wgt = 1.0f, qx = px, qy = py, qz = pz;
  for (int o = 0; o < 7; ++o) {
    W.noise();
    tacc = tacc + wgt * noise_at(P, qx, qy, qz);
    wgt = wgt * 0.5f;
    qx = qx * 2.0f;
    qy = qy * 2.0f;
    qz = qz * 2.0f;
  }
  return 0.5f * (1.0f + sinf(scale * pz + 10.0f * fabsf(tacc)));
}

// sphere (u, v) from the pre-flip outward normal, with the pole guards of
// the XLA sphere_uv (ops/intersect.py:309-328; sphere.rs:47-53)
__device__ __forceinline__ void sphere_uv(float owx, float owy, float owz,
                                          float* u, float* v) {
  const float y = fminf(fmaxf(-owy, -1.0f), 1.0f);
  const bool safe = fabsf(y) < 0.999999f;
  float theta = acosf(safe ? y : 0.0f);
  theta = safe ? theta : (y > 0.0f ? 0.0f : UV_PI);
  const bool deg = fabsf(owx) < 1e-12f && fabsf(owz) < 1e-12f;
  const float phi = atan2f(deg ? 0.0f : -owz, deg ? 1.0f : owx) + UV_PI;
  *u = phi / UV_TWO_PI;
  *v = theta / UV_PI;
}

// a quad's (u, v): its planar coordinates alpha, beta at the hit, in the
// order of quad_hit (quad.rs:84-86)
__device__ __forceinline__ void quad_uv(const float* q, float ox, float oy,
                                        float oz, float dx, float dy,
                                        float dz, float* u, float* v) {
  const float nqx = q[Q_NX], nqy = q[Q_NX + 1], nqz = q[Q_NX + 2];
  const float denom = dx * nqx + dy * nqy + dz * nqz;
  const float safe = fabsf(denom) < 1e-8f ? 1.0f : denom;
  const float tq = (q[Q_DP] - (ox * nqx + oy * nqy + oz * nqz)) / safe;
  const float relx = ox + tq * dx - q[Q_QX];
  const float rely = oy + tq * dy - q[Q_QX + 1];
  const float relz = oz + tq * dz - q[Q_QX + 2];
  const float ux = q[Q_UX], uy = q[Q_UX + 1], uz = q[Q_UX + 2];
  const float vx = q[Q_VX], vy = q[Q_VX + 1], vz = q[Q_VX + 2];
  const float wx = q[Q_WX], wy = q[Q_WX + 1], wz = q[Q_WX + 2];
  *u = wx * (rely * vz - relz * vy) + wy * (relz * vx - relx * vz) +
       wz * (relx * vy - rely * vx);
  *v = wx * (uy * relz - uz * rely) + wy * (uz * relx - ux * relz) +
       wz * (ux * rely - uy * relx);
}

// nearest texel of image `img` at clamped (u, v), v flipped
// (texture.rs:89-109; ops/textures.py image_texel): a global load
__device__ __forceinline__ void image_texel(const Params& P, float img,
                                            float u, float v, float* r,
                                            float* g, float* b) {
  const int k = min(max((int)img, 0), P.n_images - 1);
  const int base = P.img_meta[3 * k], w = P.img_meta[3 * k + 1],
            h = P.img_meta[3 * k + 2];
  const float uc = fminf(fmaxf(u, 0.0f), 1.0f);
  const float vc = 1.0f - fminf(fmaxf(v, 0.0f), 1.0f);
  const int i = min((int)(uc * (float)w), w - 1);
  const int j = min((int)(vc * (float)h), h - 1);
  const float* tx = P.texels + 3 * ((size_t)base + (size_t)j * w + i);
  *r = tx[0];
  *g = tx[1];
  *b = tx[2];
}

// The shading half of one bounce of a live lane (bounce_body,
// pallas_megakernel.py:1202-1771) given its closest hit H and a = |d|^2:
// the path integrator, or with MIS the book-3 NEE/MIS estimator
// (the_rest_of_your_life/camera.rs:184-254), whose isotropic lanes (a
// medium's scatter or an Isotropic material) sample the uniform sphere.
// `s` and `sample` key the draws.
template <bool MIS, bool BOOK2, class WorkT>
__device__ __forceinline__ void shade(Lane& L, const Params& P, uint32_t s,
                                      uint32_t sample, const Hit& H, float a,
                                      WorkT& W) {
  const float ox = L.ox, oy = L.oy, oz = L.oz;
  const float dx = L.dx, dy = L.dy, dz = L.dz;
  float ax = L.ax, ay = L.ay, az = L.az;
  float rx = L.rx, ry = L.ry, rz = L.rz;
  float alive = L.alive;
  const float b = L.b;
  const float4 u = uniforms4(s, sample, (uint32_t)b, STREAM_BOUNCE, P.k0,
                             P.k1);
  const float t = H.t;
  const bool hit = t < BIG;
  // the final winner (see Hit)
  const bool mwin = BOOK2 && H.mi >= 0;
  const bool qwin = !mwin && H.qi >= 0;
  const bool bwin = BOOK2 && !mwin && !qwin && H.bi >= 0;
  float kind, car, cag, cab, fz, io, owx, owy, owz;
  // texture of the winner (BOOK2): kind, second color, scale, image
  float tk = 0.0f, c2r = 0.0f, c2g = 0.0f, c2b = 0.0f, ivs = 0.0f,
        img = 0.0f;
  if (mwin) {
    // a medium scatters isotropically with a fixed normal
    // (constant_medium.rs:70-78); fuzz and ior are never read for it
    const float* mr = P.mtab + H.mi * M_COLS;
    kind = 4.0f;
    car = mr[M_AR];
    cag = mr[M_AR + 1];
    cab = mr[M_AR + 2];
    fz = 0.0f;
    io = 1.0f;
    owx = 1.0f;
    owy = 0.0f;
    owz = 0.0f;
  } else if (qwin) {
    // a quad's outward normal is its unit plane normal
    const float* q = P.qtab + H.qi * Q_COLS;
    kind = q[Q_KIND];
    car = q[Q_AR];
    cag = q[Q_AR + 1];
    cab = q[Q_AR + 2];
    fz = q[Q_FUZZ];
    io = q[Q_IOR];
    owx = q[Q_NX];
    owy = q[Q_NX + 1];
    owz = q[Q_NX + 2];
    if constexpr (BOOK2) {
      tk = q[Q_TEXK];
      c2r = q[Q_C2R];
      c2g = q[Q_C2R + 1];
      c2b = q[Q_C2R + 2];
      ivs = q[Q_INVS];
      img = q[Q_IMG];
    }
  } else if (bwin) {
    // the box face the ray enters, or leaves from inside: entry -> the
    // last slab entry, exit -> the first slab exit, with the >= / <= tie
    // breaks of pallas_megakernel.py:996-1036
    const float* at = P.batt + H.bi * BA_COLS;
    const float* bb = P.btab + 8 * H.bi;
    kind = at[BA_KIND];
    car = at[BA_AR];
    cag = at[BA_AR + 1];
    cab = at[BA_AR + 2];
    fz = at[BA_FUZZ];
    io = at[BA_IOR];
    tk = at[BA_TEXK];
    c2r = at[BA_C2R];
    c2g = at[BA_C2R + 1];
    c2b = at[BA_C2R + 2];
    ivs = at[BA_INVS];
    const float ivx = safe_inv(dx), ivy = safe_inv(dy), ivz = safe_inv(dz);
    const float tx1 = (bb[0] - ox) * ivx;
    const float tx2 = (bb[3] - ox) * ivx;
    const float ty1 = (bb[1] - oy) * ivy;
    const float ty2 = (bb[4] - oy) * ivy;
    const float tz1 = (bb[2] - oz) * ivz;
    const float tz2 = (bb[5] - oz) * ivz;
    const float txn = fminf(tx1, tx2), txf = fmaxf(tx1, tx2);
    const float tyn = fminf(ty1, ty2), tyf = fmaxf(ty1, ty2);
    const float tzn = fminf(tz1, tz2), tzf = fmaxf(tz1, tz2);
    const float t1b = fmaxf(fmaxf(txn, tyn), tzn);
    const bool entry = t1b > T_MIN && t1b < T_MAX;
    const bool ex_ = txn >= tyn && txn >= tzn;
    const bool ey_ = !ex_ && tyn >= tzn;
    const bool xx_ = txf <= tyf && txf <= tzf;
    const bool xy_ = !xx_ && tyf <= tzf;
    const bool usex = (entry && ex_) || (!entry && xx_);
    const bool usey = (entry && ey_) || (!entry && xy_);
    const float s_e = entry ? -1.0f : 1.0f;
    owx = usex ? s_e * (dx >= 0.0f ? 1.0f : -1.0f) : 0.0f;
    owy = usey ? s_e * (dy >= 0.0f ? 1.0f : -1.0f) : 0.0f;
    owz = (usex || usey) ? 0.0f : s_e * (dz >= 0.0f ? 1.0f : -1.0f);
  } else {
    const float* row = P.tab + (hit ? H.si : 0) * J_COLS;
    kind = hit ? row[J_KIND] : 0.0f;
    car = row[J_AR];
    cag = row[J_AR + 1];
    cab = row[J_AR + 2];
    fz = row[J_FUZZ];
    io = row[J_IOR];
    const float invr = row[J_INVR];
    float cxw = row[J_CX], cyw = row[J_CX + 1], czw = row[J_CX + 2];
    if (BOOK2 && P.moving) {
      cxw = cxw + L.tm * row[J_VX];
      cyw = cyw + L.tm * row[J_VX + 1];
      czw = czw + L.tm * row[J_VX + 2];
    }
    owx = hit ? (t * dx - (cxw - ox)) * invr : 0.0f;
    owy = hit ? (t * dy - (cyw - oy)) * invr : 0.0f;
    owz = hit ? (t * dz - (czw - oz)) * invr : 1.0f;
    if constexpr (BOOK2) {
      tk = hit ? row[J_TEXK] : 0.0f;
      c2r = row[J_C2R];
      c2g = row[J_C2R + 1];
      c2b = row[J_C2R + 2];
      ivs = row[J_INVS];
      img = hit ? row[J_IMG] : 0.0f;
    }
  }

  // background on a miss (renderer.wgsl:233-239)
  const float inv_len = 1.0f / sqrtf(a);
  float bgr, bgg, bgb;
  if (P.sky_bg) {
    const float sa = 0.5f * (dy * inv_len + 1.0f);
    bgr = (1.0f - sa) + sa * 0.5f;
    bgg = (1.0f - sa) + sa * 0.7f;
    bgb = (1.0f - sa) + sa * 1.0f;
  } else {
    bgr = P.bg[0];
    bgg = P.bg[1];
    bgb = P.bg[2];
  }
  const float missf = alive * (hit ? 0.0f : 1.0f);
  rx = rx + missf * ax * bgr;
  ry = ry + missf * ay * bgg;
  rz = rz + missf * az * bgb;
  alive = alive * (hit ? 1.0f : 0.0f);
  const float px_ = ox + t * dx;
  const float py_ = oy + t * dy;
  const float pz_ = oz + t * dz;

  if constexpr (BOOK2) {
    // the winner's texture replaces its albedo (TEX_CHECKER 1, TEX_IMAGE 2,
    // TEX_NOISE 3; a medium's is solid)
    if (P.has_checker && tk == 1.0f) {
      // 3-D lattice parity: odd cells take the second color
      const int csum = (int)floorf(ivs * px_) + (int)floorf(ivs * py_) +
                       (int)floorf(ivs * pz_);
      if (csum % 2 != 0) {
        car = c2r;
        cag = c2g;
        cab = c2b;
      }
    }
    if (P.has_noise && tk == 3.0f) {
      const float mv = marble(P, ivs, px_, py_, pz_, W);
      car = mv;
      cag = mv;
      cab = mv;
    }
    if (P.has_image && tk == 2.0f) {
      float tu, tv;
      if (qwin)
        quad_uv(P.qtab + H.qi * Q_COLS, ox, oy, oz, dx, dy, dz, &tu, &tv);
      else
        sphere_uv(owx, owy, owz, &tu, &tv);
      W.texel();
      image_texel(P, img, tu, tv, &car, &cag, &cab);
    }
  }

  const float d_dot_ow = dx * owx + dy * owy + dz * owz;
  const bool front = d_dot_ow < 0.0f;
  const float sgn = front ? 1.0f : -1.0f;
  const float nx = sgn * owx;
  const float ny = sgn * owy;
  const float nz = sgn * owz;

  // emission (DiffuseLight adds, then dies); book 3 counts the front face
  // only (the_rest_of_your_life/material.rs:154-161)
  const bool is_light = kind == 3.0f;
  const bool emit = MIS ? (is_light && front) : is_light;
  const float lf = alive * (emit ? 1.0f : 0.0f);
  rx = rx + lf * ax * car;
  ry = ry + lf * ay * cag;
  rz = rz + lf * az * cab;
  alive = alive * (is_light ? 0.0f : 1.0f);

  // shared random unit vector (renderer.wgsl:78-83)
  const float rz_ = u.y * 2.0f - 1.0f;
  const float rr_ = sqrtf(fmaxf(1.0f - rz_ * rz_, 0.0f));
  const float phi = u.x * TWO_PI;
  const float rvx = rr_ * cosf(phi);
  const float rvy = rr_ * sinf(phi);
  const float rvz = rz_;
  // lambertian: n + ruv with degenerate guard
  float lx = nx + rvx;
  float ly = ny + rvy;
  float lz = nz + rvz;
  if ((lx * lx + ly * ly + lz * lz) < 1e-16f) {
    lx = nx;
    ly = ny;
    lz = nz;
  }
  // metal: reflect(unit d, n) + fuzz * ruv
  const float ux = dx * inv_len;
  const float uy = dy * inv_len;
  const float uz = dz * inv_len;
  const float udn = ux * nx + uy * ny + uz * nz;
  const float mx = ux - 2.0f * udn * nx + fz * rvx;
  const float my = uy - 2.0f * udn * ny + fz * rvy;
  const float mz = uz - 2.0f * udn * nz + fz * rvz;
  const bool met_ok = (mx * nx + my * ny + mz * nz) > 0.0f;
  // dielectric: Snell / total internal reflection / Schlick choice
  const float ri = front ? 1.0f / io : io;
  const float cos_t = fminf(-udn, 1.0f);
  const float sin2 = fmaxf(1.0f - cos_t * cos_t, 0.0f);
  const bool cannot = ri * ri * sin2 > 1.0f;
  float r0 = (1.0f - ri) / (1.0f + ri);
  r0 = r0 * r0;
  const float one_m = 1.0f - cos_t;
  const float om2 = one_m * one_m;
  const float schl = r0 + (1.0f - r0) * om2 * om2 * one_m;
  const bool refl_choice = cannot || (schl > u.z);
  const float ppx = ri * (ux + cos_t * nx);
  const float ppy = ri * (uy + cos_t * ny);
  const float ppz = ri * (uz + cos_t * nz);
  const float pp2 = ppx * ppx + ppy * ppy + ppz * ppz;
  const float par = -sqrtf(fmaxf(fabsf(1.0f - pp2), 1e-12f));
  const float ex = refl_choice ? ux - 2.0f * udn * nx : ppx + par * nx;
  const float ey = refl_choice ? uy - 2.0f * udn * ny : ppy + par * ny;
  const float ez = refl_choice ? uz - 2.0f * udn * nz : ppz + par * nz;

  const bool is_met = kind == 1.0f;
  const bool is_die = kind == 2.0f;
  const bool is_iso = kind == 4.0f;
  float ndx, ndy, ndz;
  if constexpr (!MIS) {
    ndx = is_met ? mx : (is_die ? ex : (is_iso ? rvx : lx));
    ndy = is_met ? my : (is_die ? ey : (is_iso ? rvy : ly));
    ndz = is_met ? mz : (is_die ? ez : (is_iso ? rvz : lz));
    const float atr = is_die ? 1.0f : car;
    const float atg = is_die ? 1.0f : cag;
    const float atb = is_die ? 1.0f : cab;
    alive = alive * ((is_met && !met_ok) ? 0.0f : 1.0f);
    const bool live = alive > 0.0f;
    ax = ax * (live ? atr : 1.0f);
    ay = ay * (live ? atg : 1.0f);
    az = az * (live ? atb : 1.0f);
    // Russian roulette from bounce 5 (renderer.wgsl:225-231)
    if (P.max_depth > RR_START_BOUNCE) {
      const bool do_rr = b >= (float)RR_START_BOUNCE;
      const float pmax = fmaxf(ax, fmaxf(ay, az));
      const float p = fminf(fmaxf(pmax, 0.05f), 0.95f);
      const bool killed = do_rr && !(u.w <= p);
      alive = alive * (killed ? 0.0f : 1.0f);
      const float scale = (do_rr && alive > 0.0f) ? 1.0f / p : 1.0f;
      ax = ax * scale;
      ay = ay * scale;
      az = az * scale;
    }
  } else {
    // Russian roulette from the per-hit albedo, folded into both branches'
    // weights (camera.rs:223-237; pallas_megakernel.py:1565-1581)
    float rr_prob = 1.0f;
    if (P.max_depth > RR_START_BOUNCE) {
      const bool do_rr = b >= (float)RR_START_BOUNCE;
      const float pmax = fmaxf(car, fmaxf(cag, cab));
      const float prr = fminf(fmaxf(pmax, 0.05f), 0.95f);
      rr_prob = do_rr ? prr : 1.0f;
      alive = alive * ((do_rr && u.w > prr) ? 0.0f : 1.0f);
    }
    const bool spec = is_met || is_die;
    const float sdx = is_met ? mx : ex;
    const float sdy = is_met ? my : ey;
    const float sdz = is_met ? mz : ez;
    const float inv_rr = 1.0f / rr_prob;
    const float swr = (is_die ? 1.0f : car) * inv_rr;
    const float swg = (is_die ? 1.0f : cag) * inv_rr;
    const float swb = (is_die ? 1.0f : cab) * inv_rr;

    const float4 ua = uniforms4(s, sample, (uint32_t)b, STREAM_MIS_A, P.k0,
                                P.k1);
    const float4 ub = uniforms4(s, sample, (uint32_t)b, STREAM_MIS_B, P.k0,
                                P.k1);
    const float u5 = ua.x, u6 = ua.y, u7 = ua.z, u8 = ua.w;
    const float u9 = ub.x, u10 = ub.y;

    // cosine-weighted material direction (vec3.rs:212-221)
    float bux, buy, buz, bvx, bvy, bvz;
    onb(nx, ny, nz, &bux, &buy, &buz, &bvx, &bvy, &bvz);
    const float phi2 = TWO_PI * u5;
    const float cph = cosf(phi2), sph = sinf(phi2);
    const float sq6 = sqrtf(u6);
    const float clx = cph * sq6;
    const float cly = sph * sq6;
    const float clz = sqrtf(fmaxf(1.0f - u6, 0.0f));
    // isotropic lanes: the uniform sphere from the same u5, u6
    // (material.rs:177-190, pdf.rs:19-29; pallas_megakernel.py:1618-1627)
    const float z_i = u6 * 2.0f - 1.0f;
    const float r_i = sqrtf(fmaxf(1.0f - z_i * z_i, 0.0f));
    const float mdx = is_iso ? cph * r_i : clx * bux + cly * bvx + clz * nx;
    const float mdy = is_iso ? sph * r_i : clx * buy + cly * bvy + clz * ny;
    const float mdz = is_iso ? z_i : clx * buz + cly * bvz + clz * nz;

    // the picked light's sampled direction (HittableList::random,
    // hittable_list.rs:71-75): light l is picked when u9 * n >= l
    float ldx = 0.0f, ldy = 0.0f, ldz = 0.0f;
    for (int l = 0; l < P.n_lights; ++l) {
      const float* lt = P.ltab + l * L_COLS;
      float qx, qy, qz;
      if (lt[L_KIND] < 0.5f) {
        // quad: q + u7 u + u8 v - p (quad.rs:104-107)
        qx = lt[L_QX] + u7 * lt[L_UX] + u8 * lt[L_VX] - px_;
        qy = lt[L_QX + 1] + u7 * lt[L_UX + 1] + u8 * lt[L_VX + 1] - py_;
        qz = lt[L_QX + 2] + u7 * lt[L_UX + 2] + u8 * lt[L_VX + 2] - pz_;
      } else {
        // sphere: uniform direction in the cone it subtends (sphere.rs:55-65)
        const float tcx = lt[L_CX] - px_;
        const float tcy = lt[L_CX + 1] - py_;
        const float tcz = lt[L_CX + 2] - pz_;
        const float d2 = fmaxf(tcx * tcx + tcy * tcy + tcz * tcz, 1e-30f);
        const float rl = lt[L_RAD];
        const float cmax = sqrtf(fmaxf(1.0f - rl * rl / d2, 0.0f));
        const float zc = 1.0f + u8 * (cmax - 1.0f);
        const float phl = TWO_PI * u7;
        const float sc = sqrtf(fmaxf(1.0f - zc * zc, 0.0f));
        const float idl = 1.0f / sqrtf(d2);
        const float w2x = tcx * idl, w2y = tcy * idl, w2z = tcz * idl;
        float sux, suy, suz, svx, svy, svz;
        onb(w2x, w2y, w2z, &sux, &suy, &suz, &svx, &svy, &svz);
        const float csl = cosf(phl) * sc;
        const float snl = sinf(phl) * sc;
        qx = csl * sux + snl * svx + zc * w2x;
        qy = csl * suy + snl * svy + zc * w2y;
        qz = csl * suz + snl * svz + zc * w2z;
      }
      if (l == 0 || u9 * (float)P.n_lights >= (float)l) {
        ldx = qx;
        ldy = qy;
        ldz = qz;
      }
    }

    // 50/50 mixture (MixturePdf::generate, pdf.rs:93-99)
    const bool use_l = u10 < 0.5f;
    const float gdx = use_l ? ldx : mdx;
    const float gdy = use_l ? ldy : mdy;
    const float gdz = use_l ? ldz : mdz;
    const float g2 = fmaxf(gdx * gdx + gdy * gdy + gdz * gdz, 1e-30f);
    const float ginv = 1.0f / sqrtf(g2);
    const float cos_th = (nx * gdx + ny * gdy + nz * gdz) * ginv;
    // cosine pdf (pdf.rs:41-49); an isotropic lane's mixture and
    // scattering pdf are both the uniform sphere's 1/4pi
    // (material.rs:187-189; pallas_megakernel.py:1678-1681)
    const float cpdf =
        is_iso ? 0.25f * INV_PI : fmaxf(cos_th, 0.0f) * INV_PI;

    // mixture's light pdf: the mean over lights (hittable_list.rs:60-69)
    float lp = 0.0f;
    for (int l = 0; l < P.n_lights; ++l) {
      const float* lt = P.ltab + l * L_COLS;
      float pdf;
      if (lt[L_KIND] < 0.5f) {
        // quad area pdf (quad.rs:92-102)
        const float lnx = lt[L_NX], lny = lt[L_NX + 1], lnz = lt[L_NX + 2];
        const float dn = lnx * gdx + lny * gdy + lnz * gdz;
        const float safe = fabsf(dn) < 1e-8f ? 1.0f : dn;
        const float ndp = lnx * px_ + lny * py_ + lnz * pz_;
        const float tq = (lt[L_DP] - ndp) / safe;
        const float hx = px_ + tq * gdx - lt[L_QX];
        const float hy = py_ + tq * gdy - lt[L_QX + 1];
        const float hz = pz_ + tq * gdz - lt[L_QX + 2];
        const float lux = lt[L_UX], luy = lt[L_UX + 1], luz = lt[L_UX + 2];
        const float lvx = lt[L_VX], lvy = lt[L_VX + 1], lvz = lt[L_VX + 2];
        const float lwx = lt[L_WX], lwy = lt[L_WX + 1], lwz = lt[L_WX + 2];
        const float alp = lwx * (hy * lvz - hz * lvy) +
                          lwy * (hz * lvx - hx * lvz) +
                          lwz * (hx * lvy - hy * lvx);
        const float bet = lwx * (luy * hz - luz * hy) +
                          lwy * (luz * hx - lux * hz) +
                          lwz * (lux * hy - luy * hx);
        const bool okq = fabsf(dn) >= 1e-8f && tq > T_MIN && tq < T_MAX &&
                         alp >= 0.0f && alp <= 1.0f && bet >= 0.0f &&
                         bet <= 1.0f;
        const float cosq = fabsf(dn) * ginv;
        pdf = okq ? tq * tq * g2 / fmaxf(cosq * lt[L_AREA], 1e-30f) : 0.0f;
      } else {
        // sphere solid-angle pdf (sphere.rs:102-115)
        const float ocx = lt[L_CX] - px_;
        const float ocy = lt[L_CX + 1] - py_;
        const float ocz = lt[L_CX + 2] - pz_;
        const float hq = gdx * ocx + gdy * ocy + gdz * ocz;
        const float rl = lt[L_RAD];
        const float cq = ocx * ocx + ocy * ocy + ocz * ocz - rl * rl;
        const float disc = hq * hq - g2 * cq;
        const float sq = sqrtf(fmaxf(disc, 0.0f));
        const float inv_g2 = 1.0f / g2;
        const float tn = (hq - sq) * inv_g2;
        const float tf = (hq + sq) * inv_g2;
        const float rt = (tn > T_MIN && tn < T_MAX) ? tn : tf;
        const bool oks = disc > 0.0f && rt > T_MIN && rt < T_MAX;
        const float d2 = fmaxf(ocx * ocx + ocy * ocy + ocz * ocz, 1e-30f);
        const float cmax = sqrtf(fmaxf(1.0f - rl * rl / d2, 0.0f));
        const float sang = TWO_PI * (1.0f - cmax);
        pdf = oks ? 1.0f / fmaxf(sang, 1e-30f) : 0.0f;
      }
      lp = lp + pdf;
    }
    lp = lp * (1.0f / (float)P.n_lights);
    const float pdfv = 0.5f * lp + 0.5f * cpdf;  // pdf.rs:88-91
    const bool ok_diff = pdfv > 0.0f;

    // weight = albedo * scattering pdf / (pdf * rr)  (camera.rs:248-253)
    const float dw_den = 1.0f / fmaxf(pdfv * rr_prob, 1e-30f);
    const float dwr = car * cpdf * dw_den;
    const float dwg = cag * cpdf * dw_den;
    const float dwb = cab * cpdf * dw_den;

    ndx = spec ? sdx : gdx;
    ndy = spec ? sdy : gdy;
    ndz = spec ? sdz : gdz;
    alive = alive * ((spec || ok_diff) ? 1.0f : 0.0f);
    const bool live = alive > 0.0f;
    ax = ax * (live ? (spec ? swr : dwr) : 1.0f);
    ay = ay * (live ? (spec ? swg : dwg) : 1.0f);
    az = az * (live ? (spec ? swb : dwb) : 1.0f);
  }
  const bool live = alive > 0.0f;
  const float b1 = b + 1.0f;
  L.ox = live ? px_ : ox;
  L.oy = live ? py_ : oy;
  L.oz = live ? pz_ : oz;
  L.dx = live ? ndx : dx;
  L.dy = live ? ndy : dy;
  L.dz = live ? ndz : dz;
  L.ax = ax;
  L.ay = ay;
  L.az = az;
  L.rx = rx;
  L.ry = ry;
  L.rz = rz;
  L.b = b1;
  // depth exhaustion (camera.rs:186-187; pallas_megakernel.py:2009)
  L.alive = b1 < (float)P.max_depth ? alive : 0.0f;
  W.bounce();
}

// One bounce of a live lane (K5): the closest hit (the per-lane
// intersect), then shade.  `s` and `sample` key the draws.
template <bool MIS, bool BOOK2, class WorkT>
__device__ void bounce(Lane& L, const Params& P, uint32_t s, uint32_t sample,
                       WorkT& W) {
  const float a = L.dx * L.dx + L.dy * L.dy + L.dz * L.dz;
  const float inv_a = 1.0f / a;
  const Hit H = intersect<BOOK2, false>(P, L.tm, L.ox, L.oy, L.oz, L.dx, L.dy,
                                        L.dz, a, inv_a, s, sample,
                                        (uint32_t)L.b, true, W);
  shade<MIS, BOOK2>(L, P, s, sample, H, a, W);
}

// The same bounce in a converged warp (K2, K3, K4): every lane of the warp
// calls it, and `live` says whether this lane has a live ray.  With COOP
// the intersect is the warp-cooperative one, which a lane without a live
// ray joins with its ballot bits clear; without it (tables with no sphere
// or box cluster cull, where there is no cluster scan to share) the live
// lanes take the per-lane bounce, the same computation in less code.
// Either way the live lanes compute what bounce computes.
template <bool MIS, bool BOOK2, bool COOP, class WorkT>
__device__ __forceinline__ void bounce_warp(Lane& L, const Params& P,
                                            uint32_t s, uint32_t sample,
                                            bool live, WorkT& W) {
  if constexpr (COOP) {
    const float a = L.dx * L.dx + L.dy * L.dy + L.dz * L.dz;
    const float inv_a = 1.0f / a;
    const Hit H = intersect<BOOK2, true>(P, L.tm, L.ox, L.oy, L.oz, L.dx,
                                         L.dy, L.dz, a, inv_a, s, sample,
                                         (uint32_t)L.b, live, W);
    if (live) shade<MIS, BOOK2>(L, P, s, sample, H, a, W);
  } else if (live) {
    bounce<MIS, BOOK2>(L, P, s, sample, W);
  }
}

// clamped pixel coordinates of a slot under the 32x32 screen swizzle
__device__ __forceinline__ void slot_pixel(const Params& P, int s, float* px,
                                           float* py) {
  const int tiles_x = (P.width + BLK - 1) / BLK;
  const int blk = s / (BLK * BLK);
  const int within = s % (BLK * BLK);
  *px = (float)min((blk % tiles_x) * BLK + within % BLK, P.width - 1);
  *py = (float)min((blk / tiles_x) * BLK + within / BLK, P.height - 1);
}

// camera ray of absolute sample `sample` (spawn_rays,
// pallas_megakernel.py:1817-1854; Camera::get_ray, camera.rs:152-180)
template <bool BOOK2>
__device__ __forceinline__ void spawn(Lane& L, const Params& P, uint32_t s,
                                      uint32_t sample, float px, float py) {
  const float4 u = uniforms4(s, sample, 0u, STREAM_CAMERA, P.k0, P.k1);
  float jx, jy;
  if (P.stratified) {
    // stratum of the sample in the sqrt_spp^2 grid, in integers from the
    // absolute index, wrapped so that extra samples stay in the pixel
    const uint32_t n = (uint32_t)P.sqrt_spp;
    const uint32_t sw = sample % (n * n);
    const float si = (float)(sw % n);
    const float sj = (float)(sw / n);
    const float recip = 1.0f / (float)n;
    jx = px + ((si + u.x) * recip - 0.5f);
    jy = py + ((sj + u.y) * recip - 0.5f);
  } else {
    jx = px + (u.x - 0.5f);
    jy = py + (u.y - 0.5f);
  }
  const float* cam = P.cam;
  const float psx = cam[3] + jx * cam[6] + jy * cam[9];
  const float psy = cam[4] + jx * cam[7] + jy * cam[10];
  const float psz = cam[5] + jx * cam[8] + jy * cam[11];
  float ox0 = cam[0], oy0 = cam[1], oz0 = cam[2];
  if (P.defocus) {
    const float dr = sqrtf(u.z);
    const float dth = u.w * TWO_PI;
    const float ddx = dr * cosf(dth);
    const float ddy = dr * sinf(dth);
    ox0 = cam[0] + ddx * cam[12] + ddy * cam[15];
    oy0 = cam[1] + ddx * cam[13] + ddy * cam[16];
    oz0 = cam[2] + ddx * cam[14] + ddy * cam[17];
  }
  // the ray's time of a moving scene (the_next_week/camera.rs:160-162)
  L.tm = (BOOK2 && P.moving)
             ? uniforms4(s, sample, 0u, STREAM_TIME, P.k0, P.k1).x
             : 0.0f;
  L.ox = ox0;
  L.oy = oy0;
  L.oz = oz0;
  L.dx = psx - ox0;
  L.dy = psy - oy0;
  L.dz = psz - oz0;
  L.ax = 1.0f;
  L.ay = 1.0f;
  L.az = 1.0f;
  L.b = 0.0f;
  L.alive = 1.0f;
  L.mid = 1.0f;
}

// a lane has work while a sample is in flight or samples are left
__device__ __forceinline__ bool lane_has_work(const Lane& L, float spp_f) {
  return L.mid > 0.0f || L.done < spp_f;
}

// The first half of a lane's iteration (pbody, pallas_megakernel.py:
// 1904-1962): bank a dead unbanked path and respawn an idle lane that has
// samples left.  Returns the absolute sample index that keys the bounce.
template <bool BOOK2>
__device__ __forceinline__ uint32_t bank_respawn(Lane& L, const Params& P,
                                                 uint32_t s, float px,
                                                 float py) {
  const float spp_f = (float)P.spp;
  const bool fin = L.mid > 0.0f && L.alive <= 0.0f;
  L.sx = L.sx + (fin ? L.rx : 0.0f);
  L.sy = L.sy + (fin ? L.ry : 0.0f);
  L.sz = L.sz + (fin ? L.rz : 0.0f);
  L.done = L.done + (fin ? 1.0f : 0.0f);
  L.mid = fin ? 0.0f : L.mid;
  const float finz = fin ? 0.0f : 1.0f;
  L.rx = L.rx * finz;
  L.ry = L.ry * finz;
  L.rz = L.rz * finz;
  const uint32_t sample = (uint32_t)((int)L.done + P.sample_offset);
  if (L.mid <= 0.0f && L.done < spp_f) spawn<BOOK2>(L, P, s, sample, px, py);
  return sample;
}

// One iteration of a lane in a converged warp (K2, K3): every lane of the
// warp calls it, and `act` says whether this lane takes the step (it has
// work, and in K2 is within its bound): bank a finished path, respawn, and
// one bounce_warp (COOP as there; K2 always cooperative), which the lanes
// without a live ray join.
template <bool MIS, bool BOOK2, bool COOP = true, class WorkT>
__device__ __forceinline__ void lane_step_warp(Lane& L, const Params& P,
                                               uint32_t s, float px,
                                               float py, bool act,
                                               WorkT& W) {
  uint32_t sample = 0;
  if (act) sample = bank_respawn<BOOK2>(L, P, s, px, py);
  bounce_warp<MIS, BOOK2, COOP>(L, P, s, sample, act && L.alive > 0.0f, W);
}

}  // namespace rtt
