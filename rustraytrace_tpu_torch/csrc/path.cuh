// The path tracer's device side, shared by the persist kernel (K2,
// persist.cu) and the respawn megakernel (K3, megakernel.cu): closest hit
// over spheres (SAH cluster cull) then quads, one bounce of the path or the
// NEE/MIS estimator, the camera spawn, and the per-lane step {bank a
// finished path, respawn the next camera ray, one bounce}.
//
// Counterparts: intersect / bounce_body / spawn_rays / pbody of _make_kernel,
// rustraytrace_tpu/ops/pallas_megakernel.py:883-1991.  Plain twin:
// ops/wavefront.py (_intersect_plain, _bounce_plain, spawn_rays,
// _iteration_plain); every expression is written in the twin's order (see
// rtt_common.cuh), so kernel and twin are bitwise equal.
//
// Random numbers are Philox keyed by (slot, absolute sample index, bounce,
// stream): a lane's path does not depend on the launch, the sorted position
// or the kernel (K2 or K3) that runs it.
#pragma once

#include "rtt_common.cuh"

namespace rtt {

// joined sphere table columns (ops/megakernel.py J_*)
constexpr int J_COLS = 24;
constexpr int J_CX = 0, J_INVR = 7, J_KIND = 8, J_AR = 9, J_FUZZ = 12,
              J_IOR = 13;
// light table columns (ops/megakernel.py L_*)
constexpr int L_COLS = 24;
constexpr int L_KIND = 0, L_QX = 1, L_UX = 4, L_VX = 7, L_WX = 10,
              L_NX = 13, L_DP = 16, L_AREA = 17, L_CX = 18, L_RAD = 21;
constexpr int BLK = 32;  // screen swizzle block
constexpr int RR_START_BOUNCE = 5;
constexpr float INV_PI = 0.3183098861837907f;

// Everything a launch reads besides the lane state.  The layout is mirrored
// by ops/_cuda.py PathParams (checked against rtt_params_size at load).
struct Params {
  const float4* geom;  // [N] cx, cy, cz, r2 in cluster order
  const float* tab;    // [N, 24] joined sphere + material table
  int n_rows;
  const float* clb;  // [C, 8] cluster lo3, hi3
  const int* cls;    // [C+1] cluster starts / unroll
  int n_clusters;
  const float* sclb;  // [S, 8] super-cluster bounds
  const int* scls;    // [S+1] super-cluster starts (in clusters)
  int n_sclusters;
  int unroll;
  const float* qtab;  // [Q, 32] quad frames + materials
  int n_quads;
  const float* ltab;  // [L, 24] NEE light table
  int n_lights;
  const float* cam;  // [20] center, pixel00, du, dv, disk u, v
  const float* bg;   // [4] flat background
  int sky_bg, defocus, width, height, spp, max_depth, stratified, sqrt_spp;
  uint32_t k0, k1;
  int sample_offset;
  // [3] work counters (bounces, sphere rows tested, boxes tested), read by
  // the COUNT instances only; null otherwise
  unsigned long long* work;
};

// Per-thread work counts, added to Params::work once at the end.  The
// kernels are instantiated with COUNT = false for every timed launch, where
// each count is a no-op and the compiler drops the fields; COUNT = true only
// where a caller passes Params::work.
template <bool COUNT>
struct Work {
  uint32_t bounces = 0, spheres = 0, boxes = 0;
  __device__ __forceinline__ void bounce() {
    if constexpr (COUNT) ++bounces;
  }
  __device__ __forceinline__ void sphere_rows(int n) {
    if constexpr (COUNT) spheres += (uint32_t)n;
  }
  __device__ __forceinline__ void box() {
    if constexpr (COUNT) ++boxes;
  }
  __device__ __forceinline__ void flush(const Params& P) const {
    if constexpr (COUNT) {
      atomicAdd(P.work, (unsigned long long)bounces);
      atomicAdd(P.work + 1, (unsigned long long)spheres);
      atomicAdd(P.work + 2, (unsigned long long)boxes);
    }
  }
};

// slab test of an AABB [lo3, hi3] against the ray, entry before best t
__device__ __forceinline__ bool box_hit(const float* b, float ox, float oy,
                                        float oz, float ivx, float ivy,
                                        float ivz, float bt) {
  const float tx1 = (b[0] - ox) * ivx;
  const float tx2 = (b[3] - ox) * ivx;
  const float ty1 = (b[1] - oy) * ivy;
  const float ty2 = (b[4] - oy) * ivy;
  const float tz1 = (b[2] - oz) * ivz;
  const float tz2 = (b[5] - oz) * ivz;
  const float t1 = fmaxf(fmaxf(fminf(tx1, tx2), fminf(ty1, ty2)),
                         fminf(tz1, tz2));
  const float t2 = fminf(fminf(fmaxf(tx1, tx2), fmaxf(ty1, ty2)),
                         fmaxf(tz1, tz2));
  return (t1 <= t2) && (t2 > T_MIN) && (t1 < bt);
}

template <class WorkT>
__device__ __forceinline__ void scan_spheres(const Params& P, int lo, int hi,
                                             float ox, float oy, float oz,
                                             float dx, float dy, float dz,
                                             float a, float inv_a, float* bt,
                                             int* bi, WorkT& W) {
  W.sphere_rows(hi - lo);
  for (int s = lo; s < hi; ++s) {
    const float4 g = P.geom[s];
    bool ok;
    const float root = sphere_root(g.x, g.y, g.z, g.w, ox, oy, oz, dx, dy,
                                   dz, a, inv_a, &ok);
    if (ok && root < *bt) {
      *bt = root;
      *bi = s;
    }
  }
}

__device__ __forceinline__ float safe_inv(float d) {
  const float sg = d < 0.0f ? -1e-20f : 1e-20f;
  return 1.0f / (fabsf(d) < 1e-20f ? sg : d);
}

struct Hit {
  float t;  // best t, or BIG on a miss
  int si;   // sphere winner row, or -1
  int qi;   // quad winner row, or -1 (a quad winner overrides si)
};

// Closest hit: spheres first (a per-thread cull over the two-level SAH
// cluster hierarchy, the box test of pallas_megakernel.py:797), then every
// quad, each with a strict "<" in table order: a sphere wins a tie with a
// quad.  The cull is not exactly a full scan: an f32 root can lie past its
// cluster's box (the ground sphere's, near its surface), and the box test
// then drops that hit.  The plain twin runs the same cull.
template <class WorkT>
__device__ inline Hit intersect(const Params& P, float ox, float oy,
                                float oz, float dx, float dy, float dz,
                                float a, float inv_a, WorkT& W) {
  float bt = BIG;
  int bi = -1;
  const int U = P.unroll;
  if (P.n_clusters > 0) {
    const float ivx = safe_inv(dx), ivy = safe_inv(dy), ivz = safe_inv(dz);
    if (P.n_sclusters > 1) {
      for (int sc = 0; sc < P.n_sclusters; ++sc) {
        W.box();
        if (!box_hit(P.sclb + 8 * sc, ox, oy, oz, ivx, ivy, ivz, bt))
          continue;
        for (int c = P.scls[sc]; c < P.scls[sc + 1]; ++c) {
          W.box();
          if (!box_hit(P.clb + 8 * c, ox, oy, oz, ivx, ivy, ivz, bt))
            continue;
          scan_spheres(P, P.cls[c] * U, P.cls[c + 1] * U, ox, oy, oz, dx, dy,
                       dz, a, inv_a, &bt, &bi, W);
        }
      }
    } else {
      for (int c = 0; c < P.n_clusters; ++c) {
        W.box();
        if (!box_hit(P.clb + 8 * c, ox, oy, oz, ivx, ivy, ivz, bt)) continue;
        scan_spheres(P, P.cls[c] * U, P.cls[c + 1] * U, ox, oy, oz, dx, dy,
                     dz, a, inv_a, &bt, &bi, W);
      }
    }
  } else {
    scan_spheres(P, 0, P.n_rows, ox, oy, oz, dx, dy, dz, a, inv_a, &bt, &bi,
                 W);
  }
  int qi = -1;
  for (int q = 0; q < P.n_quads; ++q) {
    bool ok;
    const float tq = quad_hit(P.qtab + q * Q_COLS, ox, oy, oz, dx, dy, dz,
                              &ok);
    if (ok && tq < bt) {
      bt = tq;
      qi = q;
    }
  }
  return Hit{bt, bi, qi};
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

// One bounce of a live lane (bounce_body, pallas_megakernel.py:1202-1771):
// the path integrator, or with MIS the book-3 NEE/MIS estimator
// (the_rest_of_your_life/camera.rs:184-254) without the isotropic branch,
// which comes with media.  `s` and `sample` key the draws.
template <bool MIS, class WorkT>
__device__ void bounce(Lane& L, const Params& P, uint32_t s, uint32_t sample,
                       WorkT& W) {
  const float ox = L.ox, oy = L.oy, oz = L.oz;
  const float dx = L.dx, dy = L.dy, dz = L.dz;
  float ax = L.ax, ay = L.ay, az = L.az;
  float rx = L.rx, ry = L.ry, rz = L.rz;
  float alive = L.alive;
  const float b = L.b;
  const float4 u = uniforms4(s, sample, (uint32_t)b, STREAM_BOUNCE, P.k0,
                             P.k1);

  const float a = dx * dx + dy * dy + dz * dz;
  const float inv_a = 1.0f / a;
  const Hit H = intersect(P, ox, oy, oz, dx, dy, dz, a, inv_a, W);
  const float t = H.t;
  const bool hit = t < BIG;
  const bool qwin = H.qi >= 0;
  float kind, car, cag, cab, fz, io, owx, owy, owz;
  if (qwin) {
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
  } else {
    const float* row = P.tab + (hit ? H.si : 0) * J_COLS;
    kind = hit ? row[J_KIND] : 0.0f;
    car = row[J_AR];
    cag = row[J_AR + 1];
    cab = row[J_AR + 2];
    fz = row[J_FUZZ];
    io = row[J_IOR];
    const float invr = row[J_INVR];
    owx = hit ? (t * dx - (row[J_CX] - ox)) * invr : 0.0f;
    owy = hit ? (t * dy - (row[J_CX + 1] - oy)) * invr : 0.0f;
    owz = hit ? (t * dz - (row[J_CX + 2] - oz)) * invr : 1.0f;
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
  float ndx, ndy, ndz;
  if constexpr (!MIS) {
    const bool is_iso = kind == 4.0f;
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
    const float sq6 = sqrtf(u6);
    const float clx = cosf(phi2) * sq6;
    const float cly = sinf(phi2) * sq6;
    const float clz = sqrtf(fmaxf(1.0f - u6, 0.0f));
    const float mdx = clx * bux + cly * bvx + clz * nx;
    const float mdy = clx * buy + cly * bvy + clz * ny;
    const float mdz = clx * buz + cly * bvz + clz * nz;

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
    const float cpdf = fmaxf(cos_th, 0.0f) * INV_PI;  // pdf.rs:41-49

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
  L.tm = 0.0f;
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

// One iteration of a lane (pbody, pallas_megakernel.py:1904-1962): bank a
// dead unbanked path, respawn an idle lane that has samples left, and run
// one bounce of a live lane.
template <bool MIS, class WorkT>
__device__ __forceinline__ void lane_step(Lane& L, const Params& P,
                                          uint32_t s, float px, float py,
                                          WorkT& W) {
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
  if (L.mid <= 0.0f && L.done < spp_f) spawn(L, P, s, sample, px, py);
  if (L.alive > 0.0f) bounce<MIS>(L, P, s, sample, W);
}

}  // namespace rtt
