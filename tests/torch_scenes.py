"""Synthetic scenes of the port's tests and ``chip_smoke.py``, each built
with a given ``SceneBuilder`` class, so that the JAX package's builder and
the port's build the same scene: a field of random quads (the JAX
package's tests/test_quad_cluster.py ``_quad_field``) and its volumetric
MIS scene (tests/test_round4_tpu.py ``_smoke_mis_scene``), with their
camera settings; the scene of an image-textured constant medium, which
the kernel routes do not cover; and rays aimed at the cell faces of the
sphere grid.  Imports numpy only."""

import numpy as np


def quad_field(builder_cls, n=64, seed=2):
    """n random quads scattered in a 40-cube (tests/test_quad_cluster.py
    _quad_field), built with ``builder_cls``."""
    rng = np.random.default_rng(seed)
    b = builder_cls()
    for k in range(n):
        q = rng.uniform(-20, 20, 3)
        u = rng.normal(size=3)
        u = u / np.linalg.norm(u) * rng.uniform(1.0, 3.0)
        v = np.cross(u, rng.normal(size=3))
        v = v / np.linalg.norm(v) * rng.uniform(1.0, 3.0)
        b.add_quad(tuple(q), tuple(u), tuple(v),
                   b.lambertian((0.5 + 0.5 * (k % 2), 0.4, 0.3)))
    return b.build()


def smoke_mis_scene(builder_cls, smoke=(0.0, 0.0, 0.0)):
    """The JAX package's volumetric MIS scene (tests/test_round4_tpu.py
    _smoke_mis_scene): a Cornell box, a smoke box of density 0.01 and
    albedo ``smoke`` (black there), a glass sphere and one NEE light quad,
    built with ``builder_cls``."""
    b = builder_cls()
    red = b.lambertian((0.65, 0.05, 0.05))
    white = b.lambertian((0.73, 0.73, 0.73))
    green = b.lambertian((0.12, 0.45, 0.15))
    light = b.diffuse_light((15.0, 15.0, 15.0))
    b.add_quad((555, 0, 0), (0, 0, 555), (0, 555, 0), green)
    b.add_quad((0, 0, 555), (0, 0, -555), (0, 555, 0), red)
    b.add_quad((0, 555, 0), (555, 0, 0), (0, 0, 555), white)
    b.add_quad((0, 0, 555), (555, 0, 0), (0, 0, -555), white)
    b.add_quad((555, 0, 555), (-555, 0, 0), (0, 555, 0), white)
    b.add_quad((213, 554, 227), (130, 0, 0), (0, 0, 105), light)
    b.add_medium_box((0, 0, 0), (165, 330, 165), 0.01,
                     b.isotropic(smoke), rotate_y_deg=15.0,
                     translate=(265, 0, 295))
    b.add_sphere((190, 90, 190), 90.0, b.dielectric(1.5))
    b.add_light_quad((343, 554, 332), (-130, 0, 0), (0, 0, -105))
    return b.build()


def image_medium_scene(builder_cls):
    """A fog sphere whose isotropic phase albedo is an image texture (a 4x4
    checker of two colors) over a ground sphere under the sky: the JAX
    package renders it only on its XLA routes, the port on its reference
    routes."""
    b = builder_cls()
    img = np.zeros((4, 4, 3), np.float32)
    img[...] = (0.9, 0.3, 0.2)
    img[::2, ::2] = img[1::2, 1::2] = (0.2, 0.4, 0.9)
    b.add_medium_sphere((0, 1, 0), 1.0, 0.8,
                        b.isotropic(tex=b.image_texture(img)))
    b.add_sphere((0, -1000, 0), 1000.0, b.lambertian((0.5, 0.5, 0.5)))
    b.add_sphere((2.2, 1, 0), 1.0, b.metal((0.7, 0.6, 0.5), 0.1))
    return b.build()


IMAGE_MEDIUM_CFG = dict(aspect_ratio=1.0, vfov=40.0, lookfrom=(0, 2, 8),
                        lookat=(0.5, 0.8, 0))
SMOKE_CFG = dict(aspect_ratio=1.0, background=(0.0, 0.0, 0.0), vfov=40.0,
                 lookfrom=(278.0, 278.0, -800.0), lookat=(278.0, 278.0, 0.0))
FIELD_CFG = dict(aspect_ratio=1.0, vfov=60.0, lookfrom=(0, 0, 60),
                 lookat=(0, 0, 0), focus_dist=10.0)
# inside the field, the case pallas_megakernel.py:201-205 measured
FIELD_INSIDE_CFG = dict(aspect_ratio=1.0, vfov=60.0, lookfrom=(0, 0, 0),
                        lookat=(0, 0, -20), focus_dist=10.0)


def cell_face_rays(centers, radii, n, seed, cell_r_mult=4.0, res=8):
    """(origins [n', 3], unit directions [n', 3]) float32 of rays that
    strike spheres of a cloud where the sphere grid
    (``ops/bvh.py grid_bin_spheres``) cuts them: each ray aims at a point
    of a small sphere's surface on the nearest face plane of its cell,
    from 0.5-30 units outside the surface.  Spheres whose nearest plane
    misses them are dropped, so n' <= n."""
    centers = np.asarray(centers, np.float32)
    radii = np.abs(np.asarray(radii, np.float32))
    rng = np.random.default_rng(seed)
    r_med = float(np.median(radii))
    small = np.where(2.0 * radii <= cell_r_mult * r_med)[0]
    lo = (centers[small] - radii[small, None]).min(axis=0)
    hi = (centers[small] + radii[small, None]).max(axis=0)
    cell = max(cell_r_mult * r_med, float((hi - lo).max()) / res)
    k = rng.choice(small, n)
    ax = rng.integers(0, 3, n)
    rows = np.arange(n)
    plane = lo[ax] + np.round((centers[k, ax] - lo[ax]) / cell) * cell
    off = plane - centers[k, ax]
    keep = np.abs(off) < 0.999 * radii[k]
    ring = np.sqrt(np.maximum(radii[k] ** 2 - off ** 2, 0.0))
    ang = rng.uniform(0.0, 2.0 * np.pi, n)
    p = np.zeros((n, 3))
    p[rows, ax] = plane
    p[rows, (ax + 1) % 3] = centers[k, (ax + 1) % 3] + ring * np.cos(ang)
    p[rows, (ax + 2) % 3] = centers[k, (ax + 2) % 3] + ring * np.sin(ang)
    nrm = (p - centers[k]) / radii[k, None]
    out = rng.normal(size=(n, 3))
    out /= np.linalg.norm(out, axis=1, keepdims=True)
    out = np.where((out * nrm).sum(axis=1, keepdims=True) < 0.0, -out, out)
    o = p + rng.uniform(0.5, 30.0, (n, 1)) * out
    return o[keep].astype(np.float32), (-out[keep]).astype(np.float32)
