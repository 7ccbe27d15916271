// K5: the per-bounce segment kernel, one bounce of every live lane per
// launch, with the bank and respawn of the lanes that die in it.
//
// Replaces rustraytrace_tpu/ops/pallas_wavefront.py:_wavefront_seg_raw
// (kernel body: the segment branch of _make_kernel,
// pallas_megakernel.py:1773-1815) and the bank and respawn that the JAX
// loop runs between its launches (pallas_wavefront.py:927-950).  Plain
// twin: ops/wavefront.py segment_step_plain; host loop: ops/wavefront.py
// _wavefront_pass_segments.
//
// One lane per slot, in slot order (the 32x32 screen swizzle, so that
// neighbouring lanes trace neighbouring primary rays).  The carried state
// is the JAX layout's 15 rows, float32 [15, R]: 0 time, 1-3 origin, 4-6
// direction, 7-9 attenuation, 10-12 radiance, 13 alive, 14 the lane's
// bounce count.  Beside it: the banked sums float32 [3, R], the samples
// done float32 [R], and the absolute sample index of the path in flight
// int32 [R], which keys the lane's draws with its slot and bounce.  A live
// lane runs one bounce of path.cuh (depth exhaustion at b >= max_depth,
// pallas_megakernel.py:1797-1798).  A lane that dies in it banks its
// radiance, counts the sample and, with samples left, spawns the camera ray
// of its next sample: path.cuh's bank_respawn, K2's and K3's step, with the
// lane's sample in flight as `mid`.  A lane that was dead is not touched.
// Texels are fetched in the kernel, so there is no pend record and no texel
// resolve between launches.  The path integrator only: the JAX segment
// loop raises for MIS, and so does the port's.
//
// Bound on this card: a launch is one bounce, so its bytes (the state, the
// sums, the count and the sample index of the lanes that run) are small
// and the loop is bound by what happens between launches.  The design:
//
// * No work between launches.  The bank and respawn run in the kernel, so
//   the host only launches; each launch adds the number of lanes still
//   alive after it to its own int32 slot of `alive` (one ballot and one
//   atomicAdd a warp), and the host reads those slots once per chunk of
//   launches instead of syncing every segment.  A launch after the last
//   live lane finds every warp dead and returns at once.
// * Converged warps.  There is no early return of a lane: a dead lane
//   rides along with `live` false through bounce_warp, and only a warp
//   with no live lane leaves, as a whole, before its first collective.
// * Two instances, picked by the wrapper from the tables as K3 does
//   (megakernel.cluster_cull): COOP runs K2's cooperative leaf scan, whose
//   neighbouring lanes share the clusters they need; without a sphere or
//   box cluster cull the live lanes take the per-lane bounce.
#include "path.cuh"

namespace {

constexpr int N_SEG = 15;
constexpr int BLOCK = 128;

template <bool BOOK2, bool COUNT, bool COOP>
__global__ void __launch_bounds__(BLOCK, COUNT ? 4 : 6)
    segment_kernel(float* __restrict__ st, float* __restrict__ sums,
                   float* __restrict__ done, int* __restrict__ sample, int R,
                   rtt::Params P, int* __restrict__ alive) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const bool live = i < R && st[13 * (size_t)R + i] > 0.0f;
  // the whole warp leaves together, before any collective
  if (!__any_sync(rtt::FULL_MASK, live)) return;
  rtt::Lane L = {};
  uint32_t smp = 0;
  if (live) {
    float v[N_SEG];
#pragma unroll
    for (int k = 0; k < N_SEG; ++k) v[k] = st[(size_t)k * R + i];
    L = rtt::Lane{v[0],  v[1],  v[2],  v[3],  v[4],  v[5],  v[6], v[7],
                  v[8],  v[9],  v[10], v[11], v[12], v[13], v[14]};
    L.mid = 1.0f;  // the sample in flight, as bank_respawn reads it
    smp = (uint32_t)sample[i];
  }
  rtt::Work<COUNT> W;
  rtt::bounce_warp<false, BOOK2, COOP>(L, P, (uint32_t)i, smp, live, W);
  if (live) {
    if (L.alive <= 0.0f) {
      // died in this bounce: bank, count, and respawn with samples left
      L.sx = sums[i];
      L.sy = sums[(size_t)R + i];
      L.sz = sums[2 * (size_t)R + i];
      L.done = done[i];
      float px, py;
      rtt::slot_pixel(P, i, &px, &py);
      sample[i] = (int)rtt::bank_respawn<BOOK2>(L, P, (uint32_t)i, px, py);
      sums[i] = L.sx;
      sums[(size_t)R + i] = L.sy;
      sums[2 * (size_t)R + i] = L.sz;
      done[i] = L.done;
    }
    const float out[N_SEG] = {L.tm, L.ox, L.oy, L.oz, L.dx,
                              L.dy, L.dz, L.ax, L.ay, L.az,
                              L.rx, L.ry, L.rz, L.alive, L.b};
#pragma unroll
    for (int k = 0; k < N_SEG; ++k) st[(size_t)k * R + i] = out[k];
  }
  const unsigned still = __ballot_sync(rtt::FULL_MASK, live && L.alive > 0.0f);
  if ((threadIdx.x & 31) == 0 && still != 0u) atomicAdd(alive, __popc(still));
  W.flush(P);
}

template <bool BOOK2, bool COUNT>
void launch1(float* state, float* sums, float* done, int* sample, int R,
             const rtt::Params& P, bool coop, int* alive, cudaStream_t st) {
  const int grid = (R + BLOCK - 1) / BLOCK;
  if (coop)
    segment_kernel<BOOK2, COUNT, true>
        <<<grid, BLOCK, 0, st>>>(state, sums, done, sample, R, P, alive);
  else
    segment_kernel<BOOK2, COUNT, false>
        <<<grid, BLOCK, 0, st>>>(state, sums, done, sample, R, P, alive);
}

}  // namespace

// One segment over R lanes (R a multiple of 32, which the wrapper checks):
// one bounce of the live lanes, the bank and respawn of those that die;
// `alive` (a device int32) gets the number of lanes alive after it added.
extern "C" int rtt_segment_step(float* state, float* sums, float* done,
                                int* sample, int R,
                                const rtt::Params* params, int book2,
                                int coop, int* alive, void* stream) {
  if (R > 0) {
    const cudaStream_t st = (cudaStream_t)stream;
    const rtt::Params& P = *params;
    const bool count = P.work != nullptr, c = coop != 0;
    if (book2 && count)
      launch1<true, true>(state, sums, done, sample, R, P, c, alive, st);
    else if (book2)
      launch1<true, false>(state, sums, done, sample, R, P, c, alive, st);
    else if (count)
      launch1<false, true>(state, sums, done, sample, R, P, c, alive, st);
    else
      launch1<false, false>(state, sums, done, sample, R, P, c, alive, st);
  }
  return (int)cudaGetLastError();
}
