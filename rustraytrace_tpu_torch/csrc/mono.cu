// K4: the monolithic megakernel, one launch per render pass.
//
// Replaces rustraytrace_tpu/ops/pallas_megakernel.py:_megakernel_raw with
// respawn=False (the sample loop :2041-2070), the default of the JAX
// package's render_pass_megakernel.  Plain twin: ops/megakernel.py
// mono_pass_plain.
//
// A warp holds 32 consecutive slots at a time, a lane each.  For each
// sample s in [0, spp) every lane spawns the camera ray of absolute sample
// s + sample_offset, the warp runs the bounce of path.cuh while any of its
// paths is alive (depth exhaustion at b >= max_depth), and each lane adds
// its path's radiance to its sums; after the last sample the lanes write
// their slots' sums and the warp takes the next 32 slots.  The draws are
// K3's, keyed by (slot, sample, bounce, stream), and the sums are added in
// sample order, so K4's sums equal K3's bitwise on the same tables and
// seed, whatever the grid or the order in which warps take slots.
//
// Bound on this card: the FP32 work of the bounce, as K3, plus a wait that
// K3 does not have and that this kernel keeps: at each sample boundary a
// warp waits for the longest path among its 32 lanes, where K3's lanes
// respawn on their own.  This is the SIMT form of the TPU tile's
// lockstep, what the JAX package's respawn=False computes, and the reason
// the kernel is kept apart from K3.  Around it the design is K3's:
//
// * A persistent grid fed by a slot queue: one resident wave (the
//   occupancy query, never more blocks than the slots need), and a warp's
//   leader takes the next 32 slots with one atomicAdd when its lanes have
//   banked all their samples together, so the lockstep is the only wait.
// * Converged warps: a lane past R or with its path dead rides along with
//   `live` false, and each sample's bounce loop runs while __any_sync finds
//   a live path, through bounce_warp: K2's cooperative leaf scan where a
//   sphere or box cluster cull runs (COOP, the wrapper's choice from the
//   tables), the per-lane bounce of the live lanes elsewhere.
// * Launch bounds per instance (megakernel.cuh): the Book-3 MIS instance
//   down to 80 registers, none spilling.
#include "path.cuh"

#include "megakernel.cuh"

namespace {

using rtt::mega::BLOCK;

template <bool MIS, bool BOOK2, bool COUNT, bool COOP>
__global__ void __launch_bounds__(
    BLOCK, rtt::mega::min_blocks(true, BOOK2, COUNT))
    mono_kernel(float* __restrict__ out, int R, rtt::Params P,
                int* __restrict__ queue) {
  constexpr bool C = rtt::mega::coop(COOP);
  const int lane = threadIdx.x & 31;
  rtt::Work<COUNT> W;
  for (;;) {
    int base = 0;
    if (lane == 0) base = atomicAdd(queue, 32);
    base = __shfl_sync(rtt::FULL_MASK, base, 0);
    if (base >= R) break;
    const int s = base + lane;
    const bool valid = s < R;
    rtt::Lane L = {};
    float px = 0.0f, py = 0.0f;
    if (valid) rtt::slot_pixel(P, s, &px, &py);
    for (int k = 0; k < P.spp; ++k) {
      const uint32_t sample = (uint32_t)(k + P.sample_offset);
      if (valid) rtt::spawn<BOOK2>(L, P, (uint32_t)s, sample, px, py);
      L.rx = 0.0f;
      L.ry = 0.0f;
      L.rz = 0.0f;
      for (;;) {
        const bool live = valid && L.alive > 0.0f;
        if (!__any_sync(rtt::FULL_MASK, live)) break;
        W.lane_step(live);
        W.warp_iters(1);
        rtt::bounce_warp<MIS, BOOK2, C>(L, P, (uint32_t)s, sample, live, W);
      }
      L.sx = L.sx + L.rx;
      L.sy = L.sy + L.ry;
      L.sz = L.sz + L.rz;
    }
    if (valid) {
      out[3 * (size_t)s] = L.sx;
      out[3 * (size_t)s + 1] = L.sy;
      out[3 * (size_t)s + 2] = L.sz;
    }
  }
  W.flush(P);
}

template <bool MIS, bool BOOK2, bool COUNT, bool COOP>
void launch1(float* out, int R, const rtt::Params& P, int* queue, int grid,
             cudaStream_t st) {
  mono_kernel<MIS, BOOK2, COUNT, COOP>
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
      &n, mono_kernel<MIS, BOOK2, COUNT, COOP>, BLOCK, 0);
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
extern "C" int rtt_mono_pass(float* out, int R, const rtt::Params* params,
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
extern "C" int rtt_mono_shape(int mis, int book2, int count, int coop,
                              int* block) {
  *block = BLOCK;
  const bool c = coop != 0;
  if (mis && book2) return blocks_per_sm<true, true>(count, c);
  if (mis) return blocks_per_sm<true, false>(count, c);
  if (book2) return blocks_per_sm<false, true>(count, c);
  return blocks_per_sm<false, false>(count, c);
}
