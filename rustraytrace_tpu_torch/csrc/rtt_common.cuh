// Device functions shared by the port's kernels (sphere_hit.cu, and through
// path.cuh persist.cu and megakernel.cu).
//
// Every floating-point expression here is written in the evaluation order of
// the plain PyTorch twins (ops/hit.py, ops/wavefront.py), which follow the
// JAX kernels' order, and the library is built with -fmad=false: no
// multiply-add is contracted, so kernel and plain version round the same way.
// Float literals carry the f suffix so that nothing is promoted to double.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rtt {

constexpr float T_MIN = 1.0e-3f;  // shadow-acne epsilon (renderer.wgsl:185)
constexpr float T_MAX = 1.0e9f;   // horizon
constexpr float BIG = 1.0e30f;    // "no hit yet" best t
constexpr float TWO_PI = 6.283185307179586f;

// ---- Philox-4x32-10 (Random123); plain twin: ops/rng.py ----
constexpr uint32_t PHILOX_M0 = 0xD2511F53u;
constexpr uint32_t PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u;
constexpr uint32_t PHILOX_W1 = 0xBB67AE85u;

// counter stream word: which draw group of a (slot, sample, bounce)
constexpr uint32_t STREAM_BOUNCE = 0u;  // scatter u1, u2, dielectric, RR
constexpr uint32_t STREAM_CAMERA = 1u;  // jitter x, y, lens r, theta
constexpr uint32_t STREAM_MIS_A = 2u;   // NEE/MIS u5-u8
constexpr uint32_t STREAM_MIS_B = 3u;   // NEE/MIS u9, u10 (two unused)
constexpr uint32_t STREAM_TIME = 4u;    // camera ray time (three unused)
// medium m's free-flight uniform: word m % 4 of stream STREAM_MEDIA + m / 4
constexpr uint32_t STREAM_MEDIA = 5u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += PHILOX_W0;
      k1 += PHILOX_W1;
    }
    const uint32_t hi0 = __umulhi(PHILOX_M0, c.x);
    const uint32_t lo0 = PHILOX_M0 * c.x;
    const uint32_t hi1 = __umulhi(PHILOX_M1, c.z);
    const uint32_t lo1 = PHILOX_M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// (bits & 0x7FFFFF) * 2^-23: the JAX kernel's _uniform, in [0, 1 - 2^-23]
__device__ __forceinline__ float bits_to_uniform(uint32_t b) {
  return (float)(b & 0x7FFFFFu) * (1.0f / 8388608.0f);
}

// the four uniforms of counter (slot, sample, bounce, stream)
__device__ __forceinline__ float4 uniforms4(uint32_t slot, uint32_t sample,
                                            uint32_t bounce, uint32_t stream,
                                            uint32_t k0, uint32_t k1) {
  const uint4 w = philox4x32_10(make_uint4(slot, sample, bounce, stream), k0,
                                k1);
  return make_float4(bits_to_uniform(w.x), bits_to_uniform(w.y),
                     bits_to_uniform(w.z), bits_to_uniform(w.w));
}

// ---- sphere quadric (pallas_hit.py:77-103, renderer.wgsl:122-142) ----
// Half-b form with oc = c - o subtracted first; the near root unless it is
// outside (T_MIN, T_MAX), else the far root.  Returns the root; *ok says
// whether it is a valid hit.  a = |d|^2, inv_a = 1 / a.
__device__ __forceinline__ float sphere_root(float cx, float cy, float cz,
                                             float r2, float ox, float oy,
                                             float oz, float dx, float dy,
                                             float dz, float a, float inv_a,
                                             bool* ok) {
  const float ocx = cx - ox;
  const float ocy = cy - oy;
  const float ocz = cz - oz;
  const float h = dx * ocx + dy * ocy + dz * ocz;
  const float c = ocx * ocx + ocy * ocy + ocz * ocz - r2;
  const float disc = h * h - a * c;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  const float tn = (h - sq) * inv_a;
  const float tf = (h + sq) * inv_a;
  const float root = (tn > T_MIN && tn < T_MAX) ? tn : tf;
  *ok = (disc > 0.0f) && (root > T_MIN) && (root < T_MAX);
  return root;
}

// ---- quad (pallas_megakernel.py:883-916 qbody, quad.rs:59-88) ----
// quad table columns (pallas_megakernel.py Q_*; ops/hit.py pack_quad_table)
constexpr int Q_QX = 0, Q_UX = 3, Q_VX = 6, Q_NX = 9, Q_DP = 12, Q_WX = 13,
              Q_KIND = 16, Q_AR = 17, Q_FUZZ = 20, Q_IOR = 21;
constexpr int Q_COLS = 32;

// Plane hit and planar-coordinate interior test of one quad row q: returns
// the plane's t; *ok says whether it is a valid hit in (T_MIN, T_MAX)
// inside the quad.  A zero normal (masked quad) is rejected by |denom|.
__device__ __forceinline__ float quad_hit(const float* q, float ox, float oy,
                                          float oz, float dx, float dy,
                                          float dz, bool* ok) {
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
  // alpha = w . (rel x v); beta = w . (u x rel)
  const float alpha = wx * (rely * vz - relz * vy) +
                      wy * (relz * vx - relx * vz) +
                      wz * (relx * vy - rely * vx);
  const float beta = wx * (uy * relz - uz * rely) +
                     wy * (uz * relx - ux * relz) +
                     wz * (ux * rely - uy * relx);
  *ok = fabsf(denom) >= 1e-8f && tq > T_MIN && tq < T_MAX && alpha >= 0.0f &&
        alpha <= 1.0f && beta >= 0.0f && beta <= 1.0f;
  return tq;
}

// ---- bulk copies into shared memory (Hopper's copy engine, sm_90) ----
// One thread initialises an mbarrier for one arrival, announces the bytes
// it expects and issues 1-D bulk copies (cp.async.bulk) that complete on
// it; the threads that read the data wait for the barrier's phase.
// Addresses and sizes of a bulk copy are multiples of 16 bytes.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// this thread's arrival, expecting `bytes` more from bulk copies
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// wait until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// copy `bytes` from global `src` to shared `dst`, completing on `bar`
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

}  // namespace rtt
