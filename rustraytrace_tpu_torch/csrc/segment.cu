// K5: the per-bounce segment kernel, one bounce per launch.
//
// Replaces rustraytrace_tpu/ops/pallas_wavefront.py:_wavefront_seg_raw
// (kernel body: the segment branch of _make_kernel,
// pallas_megakernel.py:1773-1815).  Plain twin: ops/wavefront.py
// segment_step_plain; host loop: ops/wavefront.py _wavefront_pass_segments,
// which banks and respawns lanes between launches in plain PyTorch.
//
// One thread per lane (lane = slot, no sort).  The carried state is the
// JAX layout's 15 rows, float32 [15, R]: 0 time, 1-3 origin, 4-6
// direction, 7-9 attenuation, 10-12 radiance, 13 alive, 14 the lane's
// bounce count; beside it an int32 [R] tensor holds the absolute sample
// index of the path in flight, which keys the lane's draws with its slot
// and bounce.  A live lane runs one bounce of path.cuh (depth exhaustion at
// b >= max_depth, pallas_megakernel.py:1797-1798) and is stored back in
// place; a dead lane is not touched, the per-thread form of the whole-tile
// skip at :1808-1813.  Texels are fetched in the kernel, so there is no
// pend record and no texel resolve between launches.  The path integrator
// only: the JAX segment loop raises for MIS, and so does the port's.
//
// Bound on this card: one bounce per launch reads and writes the 15-row
// state, so a launch is short and the host loop's per-segment work (a
// sync, the bank, and a respawn of every lane's camera ray in hundreds of
// small tensor ops) dominates the loop; nothing in this first design works
// around it.
#include "path.cuh"

namespace {

constexpr int N_SEG = 15;

template <bool BOOK2, bool COUNT>
__global__ void segment_kernel(float* __restrict__ st,
                               const int* __restrict__ sample, int R,
                               rtt::Params P) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  if (!(st[13 * (size_t)R + i] > 0.0f)) return;
  float v[N_SEG];
#pragma unroll
  for (int k = 0; k < N_SEG; ++k) v[k] = st[(size_t)k * R + i];
  rtt::Lane L = {v[0], v[1], v[2],  v[3],  v[4],  v[5],  v[6], v[7],
                 v[8], v[9], v[10], v[11], v[12], v[13], v[14]};
  rtt::Work<COUNT> W;
  rtt::bounce<false, BOOK2>(L, P, (uint32_t)i, (uint32_t)sample[i], W);
  const float out[N_SEG] = {L.tm, L.ox, L.oy, L.oz, L.dx, L.dy,    L.dz, L.ax,
                            L.ay, L.az, L.rx, L.ry, L.rz, L.alive, L.b};
#pragma unroll
  for (int k = 0; k < N_SEG; ++k) st[(size_t)k * R + i] = out[k];
  W.flush(P);
}

template <bool BOOK2>
static void launch(float* state, const int* sample, int R,
                   const rtt::Params& P, cudaStream_t st) {
  const int block = 128;
  const int grid = (R + block - 1) / block;
  if (P.work != nullptr)
    segment_kernel<BOOK2, true><<<grid, block, 0, st>>>(state, sample, R, P);
  else
    segment_kernel<BOOK2, false><<<grid, block, 0, st>>>(state, sample, R, P);
}

}  // namespace

extern "C" int rtt_segment_step(float* state, const int* sample, int R,
                                const rtt::Params* params, int book2,
                                void* stream) {
  if (R > 0) {
    const cudaStream_t st = (cudaStream_t)stream;
    if (book2)
      launch<true>(state, sample, R, *params, st);
    else
      launch<false>(state, sample, R, *params, st);
  }
  return (int)cudaGetLastError();
}
