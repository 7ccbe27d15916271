// K4: the monolithic megakernel, one launch per render pass.
//
// Replaces rustraytrace_tpu/ops/pallas_megakernel.py:_megakernel_raw with
// respawn=False (the sample loop :2041-2070), the default of the JAX
// package's render_pass_megakernel.  Plain twin: ops/megakernel.py
// mono_pass_plain.
//
// One thread per slot, in slot order.  For each sample s in [0, spp) the
// thread spawns the camera ray of absolute sample s + sample_offset, runs
// the bounce of path.cuh while the path is alive (depth exhaustion at
// b >= max_depth), and adds the path's radiance to its sums; then it
// writes its three sums.  The draws are K3's, keyed by (slot, sample,
// bounce, stream), and the sums are added in sample order, so K4's sums
// equal K3's bitwise on the same tables and seed.
//
// Bound on this card: the FP32 work of the bounce, as K3, plus a wait that
// K3 does not have: a warp reconverges after every sample's bounce loop,
// so at each sample boundary it waits for the longest path among its 32
// lanes, where K3's lanes respawn on their own.  This is the SIMT form of
// the TPU tile's lockstep, and the reason the kernel is kept apart from
// K3; nothing in this first design works around it.
#include "path.cuh"

namespace {

template <bool MIS, bool BOOK2, bool COUNT>
__global__ void mono_kernel(float* __restrict__ out, int R, rtt::Params P) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  rtt::Lane L = {};
  float px, py;
  rtt::slot_pixel(P, i, &px, &py);
  rtt::Work<COUNT> W;
  for (int k = 0; k < P.spp; ++k) {
    const uint32_t sample = (uint32_t)(k + P.sample_offset);
    rtt::spawn<BOOK2>(L, P, (uint32_t)i, sample, px, py);
    L.rx = 0.0f;
    L.ry = 0.0f;
    L.rz = 0.0f;
    while (L.alive > 0.0f)
      rtt::bounce<MIS, BOOK2>(L, P, (uint32_t)i, sample, W);
    L.sx = L.sx + L.rx;
    L.sy = L.sy + L.ry;
    L.sz = L.sz + L.rz;
  }
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
    mono_kernel<MIS, BOOK2, true><<<grid, block, 0, st>>>(out, R, P);
  else
    mono_kernel<MIS, BOOK2, false><<<grid, block, 0, st>>>(out, R, P);
}

}  // namespace

extern "C" int rtt_mono_pass(float* out, int R, const rtt::Params* params,
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
