"""Philox-4x32-10 in torch integer ops (counterparts: the on-core PRNG
``_uniform`` of ``rustraytrace_tpu/ops/pallas_megakernel.py:557-562``, and
the device function ``philox4x32_10`` in ``csrc/rtt_common.cuh``, of which
this is the plain twin).

Counter-based: every draw is a pure function of (counter, key), so the
persist kernel keys its counters by ``(slot, absolute sample index, bounce,
stream)`` and a lane's path is the same whichever launch, sorted position or
thread runs it.  Uniforms are drawn as the JAX kernel draws them:
``(bits & 0x7FFFFF) * 2^-23``, in [0, 1 - 2^-23].

Words are carried in int64 tensors holding values in [0, 2^32).  The
32x32 -> 64-bit multiply is split into 16-bit halves so that no
intermediate leaves int64 range.
"""

from __future__ import annotations

import torch

PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
_M32 = 0xFFFFFFFF

# stream word of the counter: which draw group of a (slot, sample, bounce)
STREAM_BOUNCE = 0  # 4 uniforms of one bounce (scatter u1, u2, dielectric, RR)
STREAM_CAMERA = 1  # 4 uniforms of a camera ray (jitter x, y, lens r, theta)
STREAM_MIS_A = 2  # NEE/MIS u5-u8 (material direction, light sample)
STREAM_MIS_B = 3  # NEE/MIS u9, u10 (light pick, mixture choice), 2 unused
STREAM_TIME = 4  # camera ray time of a moving scene (bounce word 0), 3 unused
# constant media: medium m's free-flight uniform of a bounce is word m % 4
# of stream STREAM_MEDIA + m // 4
STREAM_MEDIA = 5


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of m * x for 0 <= m, x < 2^32."""
    xh = x >> 16
    xl = x & 0xFFFF
    a = m * xh  # < 2^48
    b = m * xl  # < 2^48
    lo = (((a & 0xFFFF) << 16) + b) & _M32
    hi = (a + (b >> 16)) >> 16
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Random123 philox4x32 with 10 rounds.  Counter words are int64
    tensors (broadcastable) or ints in [0, 2^32); the key is two ints.
    Returns the four output words as int64 tensors."""
    c = [torch.as_tensor(w, dtype=torch.int64) for w in (c0, c1, c2, c3)]
    k0 &= _M32
    k1 &= _M32
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W0) & _M32
            k1 = (k1 + PHILOX_W1) & _M32
        hi0, lo0 = _mulhilo(PHILOX_M0, c[0])
        hi1, lo1 = _mulhilo(PHILOX_M1, c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return c


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """Low 23 bits as a float32 uniform in [0, 1 - 2^-23]."""
    return (bits & 0x7FFFFF).to(torch.float32) * (1.0 / 8388608.0)


def seed_key(seed: int):
    """Philox key words of a render seed."""
    seed = int(seed)
    return seed & _M32, (seed >> 32) & _M32


def uniforms4(slot, sample, bounce, stream: int, key):
    """The four uniforms of counter (slot, sample, bounce, stream)."""
    words = philox4x32_10(slot, sample, bounce, stream, key[0], key[1])
    return [bits_to_uniform(w) for w in words]
