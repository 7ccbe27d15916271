// K3: the respawn megakernel, one launch per render pass.
//
// Replaces rustraytrace_tpu/ops/pallas_megakernel.py:_megakernel_raw with
// respawn=True (respawn loop :1993-2039), the kernel the JAX package runs
// for scenes off the sorted persist route: every scene under 256
// primitives, every image over 2 Mi slot lanes, and MIS scenes.  Plain twin:
// ops/megakernel.py respawn_pass_plain.
//
// A lane holds one slot at a time.  It starts the slot with no sample in
// flight (its first step spawns sample 0, the respawn state of
// pallas_megakernel.py:2031-2034) and runs the lane step of path.cuh (bank,
// respawn, one bounce; depth exhaustion at b >= max_depth) until the slot
// has banked `spp` samples; then it writes the slot's three radiance sums
// and takes the next slot.  The step and the slot-keyed Philox are K2's,
// and a slot's samples are banked in sample order whichever lane runs
// them, so K3's sums are the same computation as an unbounded, unsorted K2
// launch loop on the same tables, whatever the grid or the order in which
// lanes take slots.
//
// Bound on this card: the FP32 work of the bounce (the primitive loops and,
// under MIS, the light sampling and pdf).  What the design does about the
// rest:
//
// * A persistent grid fed by a slot queue.  The launch is one resident
//   wave (the SMs times the blocks an SM holds for the instance, from the
//   occupancy query, never more than the slots need), and a device counter
//   hands out slots with one atomicAdd by a warp's leader, so no block
//   waits for its slowest lane while slots are left.
// * Converged warps.  There is no early return: a lane without a slot
//   rides along with `act` false, and the warp leaves only when no lane
//   has work (__any_sync); every iteration is lane_step_warp.
// * Two instances of the loop, chosen by the wrapper from the tables
//   (COOP: a sphere or box cluster cull runs).  With COOP the warp takes
//   32 consecutive slots once all its lanes are done, so its lanes trace
//   neighbouring pixels, and the step is K2's cooperative leaf scan (T =
//   COOP_LANES), which those coherent lanes keep efficient.  Without it
//   each lane that needs a slot takes its rank among the warp's needing
//   lanes, so the lanes stay full until the queue runs dry, and the step
//   is the per-lane bounce: with no cluster scan to share, the same
//   computation in less code.
// * Launch bounds per instance (megakernel.cuh), none spilling.
#include "path.cuh"

#include "megakernel.cuh"

namespace {

using rtt::mega::BLOCK;

template <bool MIS, bool BOOK2, bool COUNT, bool COOP>
__global__ void __launch_bounds__(
    BLOCK, rtt::mega::min_blocks(false, BOOK2, COUNT))
    respawn_kernel(float* __restrict__ out, int R, rtt::Params P,
                   int* __restrict__ queue) {
  constexpr bool C = rtt::mega::coop(COOP);
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const float spp_f = (float)P.spp;
  rtt::Lane L = {};
  int s = -1;  // this lane's slot; -1 before one is taken, >= R once dry
  float px = 0.0f, py = 0.0f;
  rtt::Work<COUNT> W;
  for (;;) {
    // write the sums of finished slots and take new ones until every lane
    // has work or the queue is dry for it
    for (;;) {
      const bool fin = s >= 0 && s < R && !rtt::lane_has_work(L, spp_f);
      if (fin) {
        out[3 * (size_t)s] = L.sx;
        out[3 * (size_t)s + 1] = L.sy;
        out[3 * (size_t)s + 2] = L.sz;
        s = -1;
      }
      int base = 0;
      if constexpr (C) {
        // the warp takes 32 consecutive slots once none of its lanes holds
        // one
        if (!__all_sync(rtt::FULL_MASK, s < 0)) break;
        if (lane == 0) base = atomicAdd(queue, 32);
        s = __shfl_sync(rtt::FULL_MASK, base, 0) + lane;
        L = rtt::Lane{};
        if (s < R) rtt::slot_pixel(P, s, &px, &py);
      } else {
        // each lane without a slot takes the next, by its rank among them
        const unsigned need = __ballot_sync(rtt::FULL_MASK, s < 0);
        if (need == 0) break;
        if (lane == 0) base = atomicAdd(queue, __popc(need));
        base = __shfl_sync(rtt::FULL_MASK, base, 0);
        if (s < 0) {
          s = base + __popc(need & below);
          L = rtt::Lane{};
          if (s < R) rtt::slot_pixel(P, s, &px, &py);
        }
      }
    }
    const bool act = s >= 0 && s < R;
    if (!__any_sync(rtt::FULL_MASK, act)) break;
    W.lane_step(act);
    W.warp_iters(1);
    rtt::lane_step_warp<MIS, BOOK2, C>(L, P, (uint32_t)s, px, py, act, W);
  }
  W.flush(P);
}

template <bool MIS, bool BOOK2, bool COUNT, bool COOP>
void launch1(float* out, int R, const rtt::Params& P, int* queue, int grid,
             cudaStream_t st) {
  respawn_kernel<MIS, BOOK2, COUNT, COOP>
      <<<grid, BLOCK, 0, st>>>(out, R, P, queue);
}

template <bool MIS, bool BOOK2>
void launch(float* out, int R, const rtt::Params& P, bool coop, int* queue,
            int grid, cudaStream_t st) {
  const bool count = P.work != nullptr;
  if (count && coop)
    launch1<MIS, BOOK2, true, true>(out, R, P, queue, grid, st);
  else if (count)
    launch1<MIS, BOOK2, true, false>(out, R, P, queue, grid, st);
  else if (coop)
    launch1<MIS, BOOK2, false, true>(out, R, P, queue, grid, st);
  else
    launch1<MIS, BOOK2, false, false>(out, R, P, queue, grid, st);
}

template <bool MIS, bool BOOK2, bool COUNT, bool COOP>
int blocks_per_sm1() {
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, respawn_kernel<MIS, BOOK2, COUNT, COOP>, BLOCK, 0);
  return e == cudaSuccess ? n : -(int)e;
}

template <bool MIS, bool BOOK2>
int blocks_per_sm(bool count, bool coop) {
  if (count && coop) return blocks_per_sm1<MIS, BOOK2, true, true>();
  if (count) return blocks_per_sm1<MIS, BOOK2, true, false>();
  if (coop) return blocks_per_sm1<MIS, BOOK2, false, true>();
  return blocks_per_sm1<MIS, BOOK2, false, false>();
}

}  // namespace

// One launch over R slots on `grid` blocks; `queue` is a device int32 that
// holds 0 on the launch's stream.
extern "C" int rtt_respawn_pass(float* out, int R, const rtt::Params* params,
                                int mis, int book2, int coop, int* queue,
                                int grid, void* stream) {
  if (R > 0) {
    const cudaStream_t st = (cudaStream_t)stream;
    const rtt::Params& P = *params;
    const bool c = coop != 0;
    if (mis && book2)
      launch<true, true>(out, R, P, c, queue, grid, st);
    else if (mis)
      launch<true, false>(out, R, P, c, queue, grid, st);
    else if (book2)
      launch<false, true>(out, R, P, c, queue, grid, st);
    else
      launch<false, false>(out, R, P, c, queue, grid, st);
  }
  return (int)cudaGetLastError();
}

// The block size and the blocks an SM holds for an instance (the
// occupancy query); a negative count is a CUDA error.
extern "C" int rtt_respawn_shape(int mis, int book2, int count, int coop,
                                 int* block) {
  *block = BLOCK;
  const bool c = coop != 0;
  if (mis && book2) return blocks_per_sm<true, true>(count, c);
  if (mis) return blocks_per_sm<true, false>(count, c);
  if (book2) return blocks_per_sm<false, true>(count, c);
  return blocks_per_sm<false, false>(count, c);
}
