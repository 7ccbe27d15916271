"""Philox-4x32-10 in torch integer ops (counterparts: the on-core PRNG
``_uniform`` of ``rustraytrace_tpu/ops/pallas_megakernel.py:557-562``, and
the device function ``philox4x32_10`` in ``csrc/rtt_common.cuh``, of which
this is the plain twin), and the reference route's draws and direction
transforms (``rustraytrace_tpu/ops/rng.py``).

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


# ---- the reference route's draws and direction sampling (ops/rng.py:23-91
# of the JAX package) ----

TWO_PI = 6.283185307179586


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root on every device, as the
    JAX package and torch's CUDA ops give it; torch's CPU float32 sqrt
    differs from it in the last bit on ~0.6% of inputs, so on the CPU the
    root is taken in float64 and rounded once."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.sqrt(x.double()).to(torch.float32)
    return torch.sqrt(x)


def uniforms(pix: torch.Tensor, sample, bounce: int, streams, n: int,
             key) -> torch.Tensor:
    """[R, n] uniforms of rays ``pix`` (flat pixel indices) at absolute
    sample ``sample`` (an int, or an int tensor [R]) and ``bounce``:
    column c is word c % 4 of counter (pix, sample, bounce,
    streams[c // 4]).  A ray's draws depend only on its pixel and sample,
    so they do not depend on how rays are chunked."""
    if isinstance(sample, torch.Tensor):
        sample = sample.to(torch.int64)
    cols = []
    for st in streams[:-(-n // 4)]:
        cols.extend(uniforms4(pix.to(torch.int64), sample, int(bounce),
                              int(st), key))
    return torch.stack(cols[:n], dim=-1)


def _stack(a, b, c=None):
    return torch.stack([a, b] if c is None else [a, b, c], dim=-1)


def unit_vector(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Uniform direction on S^2 from two uniforms (renderer.wgsl:78-83)."""
    a = u1 * TWO_PI
    z = u2 * 2.0 - 1.0
    r = sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return _stack(r * torch.cos(a), r * torch.sin(a), z)


def in_unit_disk(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Uniform point in the unit disk, [..., 2] (renderer.wgsl:85-89)."""
    r = sqrt(u1)
    theta = u2 * TWO_PI
    return _stack(r * torch.cos(theta), r * torch.sin(theta))


def cosine_direction(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted hemisphere direction in the local z-up frame
    (the_rest_of_your_life/vec3.rs:212-221)."""
    phi = TWO_PI * u1
    sqrt_u2 = sqrt(u2)
    z = sqrt(torch.clamp(1.0 - u2, min=0.0))
    return _stack(torch.cos(phi) * sqrt_u2, torch.sin(phi) * sqrt_u2, z)


def to_sphere(u1, u2, radius, distance_squared) -> torch.Tensor:
    """Direction toward a sphere subtending a cone, local z-toward frame
    (the_rest_of_your_life/sphere.rs:55-65)."""
    z = 1.0 + u2 * (sqrt(torch.clamp(
        1.0 - radius * radius / distance_squared, min=0.0)) - 1.0)
    phi = TWO_PI * u1
    s = sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return _stack(torch.cos(phi) * s, torch.sin(phi) * s, z)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of two [..., 3] tensors, x + y then + z: the
    same order on every device and every tensor length."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the last axis (jnp.cross)."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return _stack(ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def normalize(v: torch.Tensor) -> torch.Tensor:
    return v / sqrt(dot(v, v))[..., None]


def onb_from_w(n: torch.Tensor):
    """Orthonormal basis (u, v, w) with w = normalize(n), the branch-free
    form of the_rest_of_your_life/onb.rs:8-18 (helper axis y when
    |w.x| > 0.9, else x)."""
    w = normalize(n)
    use_y = torch.abs(w[..., 0:1]) > 0.9
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=w.dtype, device=w.device)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=w.dtype, device=w.device)
    a = torch.where(use_y, ey, ex)
    v = normalize(cross(w, a))
    u = cross(w, v)
    return u, v, w


def onb_transform(u, v, w, local: torch.Tensor) -> torch.Tensor:
    """local -> world: l.x u + l.y v + l.z w (onb.rs:32-34)."""
    return local[..., 0:1] * u + local[..., 1:2] * v + local[..., 2:3] * w
