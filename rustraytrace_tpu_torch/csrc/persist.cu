// K2: one bounded launch of the persist path tracer.
//
// Replaces rustraytrace_tpu/ops/pallas_wavefront.py:_persist_raw (kernel
// body: the persist branch of _make_kernel, pallas_megakernel.py:1856-1991,
// with sorted_lanes=True, has_image=False; spheres, quads, sky or flat
// background, solid albedo; the path or the NEE/MIS integrator, stratified
// or jittered camera samples).  Plain twin: ops/wavefront.py
// persist_step_plain.
//
// One thread per lane.  A thread loads its lane's 20 state words and slot,
// runs up to persist_iters iterations of the shared lane step (path.cuh)
// while the lane has work, and stores the state back in place.
//
// Intersection walks the two-level SAH cluster hierarchy per thread (see
// path.cuh): the TPU kernel culled a whole 4096-lane tile at once ("any lane
// hits the box"), which is Mosaic control flow; a Hopper thread can branch
// on its own ray.
//
// Bound on this card: FP32 throughput of the sphere quadric loop, with warp
// divergence (threads of a warp visit different clusters and run different
// path lengths) as the main loss; the tables (~20 KB) stay in L1/L2.  This
// first version does nothing about either: no shared-memory staging, no
// warp votes, no tuning of block size or iteration bound.
#include "path.cuh"

namespace {

constexpr int N_STATE = 20;

template <bool MIS, bool COUNT>
__global__ void persist_kernel(float* __restrict__ st,
                               const int* __restrict__ slot, int R,
                               rtt::Params P, int persist_iters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  float v[N_STATE];
#pragma unroll
  for (int k = 0; k < N_STATE; ++k) v[k] = st[(size_t)k * R + i];
  rtt::Lane L = {v[0],  v[1],  v[2],  v[3],  v[4],  v[5],  v[6],
                 v[7],  v[8],  v[9],  v[10], v[11], v[12], v[13],
                 v[14], v[15], v[16], v[17], v[18], v[19]};
  const int s = slot[i];
  float px, py;
  rtt::slot_pixel(P, s, &px, &py);
  const float spp_f = (float)P.spp;
  rtt::Work<COUNT> W;
  for (int it = 0; it < persist_iters; ++it) {
    if (!rtt::lane_has_work(L, spp_f)) break;
    rtt::lane_step<MIS>(L, P, (uint32_t)s, px, py, W);
  }
  const float out[N_STATE] = {L.tm, L.ox,    L.oy, L.oz,   L.dx, L.dy, L.dz,
                              L.ax, L.ay,    L.az, L.rx,   L.ry, L.rz,
                              L.alive, L.b, L.done, L.sx, L.sy, L.sz, L.mid};
#pragma unroll
  for (int k = 0; k < N_STATE; ++k) st[(size_t)k * R + i] = out[k];
  W.flush(P);
}

}  // namespace

extern "C" int rtt_persist_step(float* state, const int* slot, int R,
                                const rtt::Params* params, int persist_iters,
                                int mis, void* stream) {
  if (R > 0) {
    const int block = 128;
    const int grid = (R + block - 1) / block;
    const cudaStream_t st = (cudaStream_t)stream;
    const bool count = params->work != nullptr;
    if (mis && count)
      persist_kernel<true, true><<<grid, block, 0, st>>>(state, slot, R,
                                                         *params,
                                                         persist_iters);
    else if (mis)
      persist_kernel<true, false><<<grid, block, 0, st>>>(state, slot, R,
                                                          *params,
                                                          persist_iters);
    else if (count)
      persist_kernel<false, true><<<grid, block, 0, st>>>(state, slot, R,
                                                          *params,
                                                          persist_iters);
    else
      persist_kernel<false, false><<<grid, block, 0, st>>>(state, slot, R,
                                                           *params,
                                                           persist_iters);
  }
  return (int)cudaGetLastError();
}

// sizeof(rtt::Params), which ops/_cuda.py checks its ctypes mirror against
extern "C" int rtt_params_size() { return (int)sizeof(rtt::Params); }
