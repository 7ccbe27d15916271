// K3: the respawn megakernel, one launch per render pass.
//
// Replaces rustraytrace_tpu/ops/pallas_megakernel.py:_megakernel_raw with
// respawn=True (respawn loop :1993-2039), the kernel the JAX package runs
// for scenes off the sorted persist route: every scene under 256
// primitives, every image over 2 Mi slot lanes, and MIS scenes.  Plain twin:
// ops/megakernel.py respawn_pass_plain.
//
// One thread per slot, in slot order: no sort and no lane state in device
// memory.  A thread starts with no sample in flight (its first step spawns
// sample 0, the respawn state of pallas_megakernel.py:2031-2034) and runs the
// lane step of path.cuh (bank, respawn, one bounce; depth exhaustion at
// b >= max_depth) until it has banked `spp` samples, then writes its three
// radiance sums.  The step and the slot-keyed Philox are K2's, so K3's sums
// are the same computation as an unbounded, unsorted K2 launch loop on the
// same tables.
//
// Bound on this card: the FP32 work of the bounce (the primitive loops and,
// under MIS, the light sampling and pdf), and the tail of long paths in a
// block: a block retires only when its slowest lane has banked all its
// samples, and closed scenes (Cornell boxes) have long paths.  This first
// design does nothing about either: no work redistribution between lanes,
// no shared-memory tables, no tuning of the block size.
#include "path.cuh"

namespace {

template <bool MIS, bool BOOK2, bool COUNT>
__global__ void respawn_kernel(float* __restrict__ out, int R,
                               rtt::Params P) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  rtt::Lane L = {};
  float px, py;
  rtt::slot_pixel(P, i, &px, &py);
  const float spp_f = (float)P.spp;
  rtt::Work<COUNT> W;
  while (rtt::lane_has_work(L, spp_f))
    rtt::lane_step<MIS, BOOK2>(L, P, (uint32_t)i, px, py, W);
  out[3 * (size_t)i] = L.sx;
  out[3 * (size_t)i + 1] = L.sy;
  out[3 * (size_t)i + 2] = L.sz;
  W.flush(P);
}

template <bool MIS, bool BOOK2>
static void launch(float* out, int R, const rtt::Params& P, cudaStream_t st) {
  const int block = 128;
  const int grid = (R + block - 1) / block;
  if (P.work != nullptr)
    respawn_kernel<MIS, BOOK2, true><<<grid, block, 0, st>>>(out, R, P);
  else
    respawn_kernel<MIS, BOOK2, false><<<grid, block, 0, st>>>(out, R, P);
}

}  // namespace

extern "C" int rtt_respawn_pass(float* out, int R, const rtt::Params* params,
                                int mis, int book2, void* stream) {
  if (R > 0) {
    const cudaStream_t st = (cudaStream_t)stream;
    const rtt::Params& P = *params;
    if (mis && book2)
      launch<true, true>(out, R, P, st);
    else if (mis)
      launch<true, false>(out, R, P, st);
    else if (book2)
      launch<false, true>(out, R, P, st);
    else
      launch<false, false>(out, R, P, st);
  }
  return (int)cudaGetLastError();
}
