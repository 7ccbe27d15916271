// The launch shape of the megakernels K3 (megakernel.cu) and K4 (mono.cu),
// fixed from sweeps on the H100 (chip_measure.py --mega-sweep builds one
// library per setting with the -DRTT_MEGA_* flags, and with
// -DRTT_COOP_LANES for the cooperative threshold they share with K2).
#pragma once

#ifndef RTT_MEGA_BLOCK
#define RTT_MEGA_BLOCK 128
#endif
// resident threads an SM that every instance's launch bounds ask for; 0:
// each instance's own (min_blocks)
#ifndef RTT_MEGA_MIN_THREADS
#define RTT_MEGA_MIN_THREADS 0
#endif
// -1: each instance runs its COOP flag (the wrapper's choice from the
// tables); 0 or 1: every instance runs as COOP = 0 or 1, to measure the
// choice
#ifndef RTT_MEGA_FORCE_COOP
#define RTT_MEGA_FORCE_COOP -1
#endif

namespace rtt {
namespace mega {

constexpr int BLOCK = RTT_MEGA_BLOCK;

// what an instance built for COOP runs (RTT_MEGA_FORCE_COOP)
__host__ __device__ constexpr bool coop(bool flag) {
  return RTT_MEGA_FORCE_COOP < 0 ? flag : RTT_MEGA_FORCE_COOP != 0;
}

// The launch bounds' blocks an SM: 768 resident threads (at most 80
// registers) for every timed instance but K4's Book-2 ones, whose MIS
// instance spills at 80; 512 for those and the counting instances.
constexpr int min_blocks(bool mono, bool book2, bool count) {
  return (RTT_MEGA_MIN_THREADS > 0 ? RTT_MEGA_MIN_THREADS
                                   : (count || (mono && book2) ? 512 : 768)) /
         BLOCK;
}

}  // namespace mega
}  // namespace rtt
