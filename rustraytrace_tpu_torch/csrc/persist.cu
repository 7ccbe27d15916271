// K2: one bounded launch of the persist path tracer.
//
// Replaces rustraytrace_tpu/ops/pallas_wavefront.py:_persist_raw (kernel
// body: the persist branch of _make_kernel, pallas_megakernel.py:1856-1991,
// with sorted_lanes=True: spheres, moving or not, boxes, quads, constant
// media, solid, checker, Perlin and image albedos, sky or flat background;
// the path or the NEE/MIS integrator, stratified or jittered camera
// samples; uniform or per-tile launch bounds).  Image texels are fetched in
// the kernel, so the freeze protocol and its pend records are gone.  Plain
// twin: ops/wavefront.py persist_step_plain.
//
// One thread per lane.  A thread loads its lane's 20 state words and slot,
// runs up to its bound of iterations of the shared lane step (path.cuh)
// while the lane has work, and stores the state back in place.  The bound
// is persist_iters, or with tile_bounds that of the lane's tile of
// tile_lanes sorted positions (pallas_wavefront.py:692-714).
//
// Bound on this card: FP32 throughput of the sphere quadric loop.  The
// TPU kernel culled a whole 4096-lane tile at once; a per-thread cull makes
// a warp execute the leaf scans of every cluster any of its lanes needs,
// with the other lanes masked.  So the design is warp-level:
//
// * Converged warps.  A warp loops while any of its lanes has work and is
//   within its bound (__any_sync); a lane that is done, past its bound or
//   beyond R rides along with its ballot bits clear, and never leaves the
//   loop early.  Tile bounds are warp-uniform (tile_lanes % 32 == 0, which
//   the wrapper checks).
// * The cooperative leaf scan (intersect<BOOK2, true>, path.cuh): a sphere
//   or box cluster that at most COOP_LANES lanes of the warp need is
//   scanned by all 32 lanes for each of them in turn; above that, the
//   needing lanes scan it themselves.  Both give the per-lane form's hit
//   bitwise.
// * Occupancy: blocks of 128 threads, and launch bounds that let the
//   Book-1 path instance (the flagship's) keep six blocks an SM and the
//   others four, each without spilling.
// The scene tables (8-50 KB for the reference scenes) are read from global
// memory: they stay in L1, and staging them in shared memory with bulk
// copies measured no faster on the flagship or the final scene while its
// table pointers took registers (PERF.md).
#include "path.cuh"

namespace {

constexpr int N_STATE = 20;
constexpr int BLOCK = 128;

template <bool MIS, bool BOOK2, bool COUNT>
__global__ void __launch_bounds__(BLOCK, (MIS || BOOK2 || COUNT) ? 4 : 6)
    persist_kernel(float* __restrict__ st, const int* __restrict__ slot,
                   int R, rtt::Params P, int persist_iters,
                   const int* __restrict__ tile_bounds, int tile_lanes) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = i < R;
  const int bound =
      !valid ? 0 : (tile_bounds ? tile_bounds[i / tile_lanes] : persist_iters);
  float v[N_STATE];
#pragma unroll
  for (int k = 0; k < N_STATE; ++k) v[k] = valid ? st[(size_t)k * R + i] : 0.0f;
  rtt::Lane L = {v[0],  v[1],  v[2],  v[3],  v[4],  v[5],  v[6],
                 v[7],  v[8],  v[9],  v[10], v[11], v[12], v[13],
                 v[14], v[15], v[16], v[17], v[18], v[19]};
  const int s = valid ? slot[i] : 0;
  float px, py;
  rtt::slot_pixel(P, s, &px, &py);
  const float spp_f = (float)P.spp;
  rtt::Work<COUNT> W;
  for (int it = 0;; ++it) {
    const bool act = it < bound && rtt::lane_has_work(L, spp_f);
    if (!__any_sync(rtt::FULL_MASK, act)) break;
    rtt::lane_step_warp<MIS, BOOK2>(L, P, (uint32_t)s, px, py, act, W);
  }
  if (valid) {
    const float out[N_STATE] = {L.tm, L.ox,    L.oy, L.oz,   L.dx, L.dy, L.dz,
                                L.ax, L.ay,    L.az, L.rx,   L.ry, L.rz,
                                L.alive, L.b, L.done, L.sx, L.sy, L.sz, L.mid};
#pragma unroll
    for (int k = 0; k < N_STATE; ++k) st[(size_t)k * R + i] = out[k];
  }
  W.flush(P);
}

template <bool MIS, bool BOOK2>
static void launch(float* state, const int* slot, int R, const rtt::Params& P,
                   int persist_iters, const int* tile_bounds, int tile_lanes,
                   cudaStream_t st) {
  const int grid = (R + BLOCK - 1) / BLOCK;
  if (P.work != nullptr)
    persist_kernel<MIS, BOOK2, true><<<grid, BLOCK, 0, st>>>(
        state, slot, R, P, persist_iters, tile_bounds, tile_lanes);
  else
    persist_kernel<MIS, BOOK2, false><<<grid, BLOCK, 0, st>>>(
        state, slot, R, P, persist_iters, tile_bounds, tile_lanes);
}

}  // namespace

// One launch over R lanes; tile_bounds (int32 [R / tile_lanes], or null for
// a uniform bound of persist_iters) bounds each tile's iterations.
extern "C" int rtt_persist_step(float* state, const int* slot, int R,
                                const rtt::Params* params, int persist_iters,
                                int mis, int book2, const int* tile_bounds,
                                int tile_lanes, void* stream) {
  if (R > 0) {
    const cudaStream_t st = (cudaStream_t)stream;
    const rtt::Params& P = *params;
    if (mis && book2)
      launch<true, true>(state, slot, R, P, persist_iters, tile_bounds,
                         tile_lanes, st);
    else if (mis)
      launch<true, false>(state, slot, R, P, persist_iters, tile_bounds,
                          tile_lanes, st);
    else if (book2)
      launch<false, true>(state, slot, R, P, persist_iters, tile_bounds,
                          tile_lanes, st);
    else
      launch<false, false>(state, slot, R, P, persist_iters, tile_bounds,
                           tile_lanes, st);
  }
  return (int)cudaGetLastError();
}

// sizeof(rtt::Params), which ops/_cuda.py checks its ctypes mirror against
extern "C" int rtt_params_size() { return (int)sizeof(rtt::Params); }
