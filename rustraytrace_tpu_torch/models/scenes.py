"""Scene catalog (counterpart: ``rustraytrace_tpu/models/scenes.py``).

The two Book-1 scenes, the Book-2 quad scenes (``book2_quads``,
``book2_cornell_box``) and the Book-3 Cornell box are ported with the JAX
package's constants, seed (0x5EED_1234, the reference's GPU scene seed) and
draw order, so they build bit-equal scenes.  The other reference scenes are
listed by name and raise ``NotImplementedError`` until their feature slices
are ported.

Each builder returns ``(scene, cfg, integrator)``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np

from ..config import RenderConfig
from ..scene import Scene, SceneBuilder

_SCENE_SEED = 0x5EED_1234


def _finish(b: SceneBuilder, cfg: RenderConfig, integrator: str,
            overrides: Optional[dict], device=None
            ) -> Tuple[Scene, RenderConfig, str]:
    if overrides:
        cfg = cfg.replace(**overrides)
    return b.build(device=device), cfg, integrator


def book1_three_spheres(overrides: Optional[dict] = None, device=None):
    """BASELINE config 1: ground + lambertian/dielectric/metal trio."""
    b = SceneBuilder()
    ground = b.lambertian((0.8, 0.8, 0.0))
    center = b.lambertian((0.1, 0.2, 0.5))
    left = b.dielectric(1.5)
    right = b.metal((0.8, 0.6, 0.2), 0.0)
    b.add_sphere((0.0, -100.5, -1.0), 100.0, ground)
    b.add_sphere((0.0, 0.0, -1.2), 0.5, center)
    b.add_sphere((-1.0, 0.0, -1.0), 0.5, left)
    b.add_sphere((1.0, 0.0, -1.0), 0.5, right)
    cfg = RenderConfig(
        aspect_ratio=16.0 / 9.0, image_width=400, samples_per_pixel=100,
        max_depth=50, vfov=90.0, lookfrom=(0.0, 0.0, 0.0),
        lookat=(0.0, 0.0, -1.0), focus_dist=1.0,
    )
    return _finish(b, cfg, "path", overrides, device)


def _random_sphere_field(b: SceneBuilder, rng: np.random.Generator,
                         moving: bool, checker_ground: bool, half: int = 11):
    """Shared 22x22 random sphere field (in_one_weekend/mod.rs:57-105);
    the draw order is the JAX package's, so the field is identical."""
    if checker_ground:
        tex = b.checker(0.32, (0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
        ground = b.lambertian(tex=tex)
    else:
        ground = b.lambertian((0.5, 0.5, 0.5))
    b.add_sphere((0.0, -1000.0, 0.0), 1000.0, ground)

    for a in range(-half, half):
        for bb in range(-half, half):
            choose_mat = rng.random()
            center = np.array([a + 0.9 * rng.random(), 0.2, bb + 0.9 * rng.random()])
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose_mat < 0.8:
                albedo = rng.random(3) * rng.random(3)
                mat = b.lambertian(albedo)
                if moving:
                    center2 = center + np.array([0.0, rng.random() * 0.5, 0.0])
                    b.add_sphere(center, 0.2, mat, center2=center2)
                else:
                    b.add_sphere(center, 0.2, mat)
            elif choose_mat < 0.95:
                albedo = rng.uniform(0.5, 1.0, 3)
                fuzz = rng.random() * 0.5
                b.add_sphere(center, 0.2, b.metal(albedo, fuzz))
            else:
                b.add_sphere(center, 0.2, b.dielectric(1.5))

    b.add_sphere((0.0, 1.0, 0.0), 1.0, b.dielectric(1.5))
    b.add_sphere((-4.0, 1.0, 0.0), 1.0, b.lambertian((0.4, 0.2, 0.1)))
    b.add_sphere((4.0, 1.0, 0.0), 1.0, b.metal((0.7, 0.6, 0.5), 0.0))


def book1_random_spheres(overrides: Optional[dict] = None,
                         seed: int = _SCENE_SEED, device=None):
    """Book-1 final scene (487 spheres); in_one_weekend/mod.rs:57-126."""
    b = SceneBuilder()
    _random_sphere_field(b, np.random.default_rng(seed), moving=False,
                         checker_ground=False)
    cfg = RenderConfig(
        aspect_ratio=16.0 / 9.0, image_width=1200, samples_per_pixel=10,
        max_depth=20, vfov=20.0, lookfrom=(13.0, 2.0, 3.0),
        lookat=(0.0, 0.0, 0.0), defocus_angle=0.6, focus_dist=10.0,
    )
    return _finish(b, cfg, "path", overrides, device)


def book2_quads(overrides: Optional[dict] = None, device=None):
    """Scene 5 (the_next_week/mod.rs:256-313): five colored quads."""
    b = SceneBuilder()
    b.add_quad((-3, -2, 5), (0, 0, -4), (0, 4, 0), b.lambertian((1.0, 0.2, 0.2)))
    b.add_quad((-2, -2, 0), (4, 0, 0), (0, 4, 0), b.lambertian((0.2, 1.0, 0.2)))
    b.add_quad((3, -2, 1), (0, 0, 4), (0, 4, 0), b.lambertian((0.2, 0.2, 1.0)))
    b.add_quad((-2, 3, 1), (4, 0, 0), (0, 0, 4), b.lambertian((1.0, 0.5, 0.0)))
    b.add_quad((-2, -3, 5), (4, 0, 0), (0, 0, -4), b.lambertian((0.2, 0.8, 0.8)))
    cfg = RenderConfig(
        aspect_ratio=1.0, image_width=400, samples_per_pixel=100,
        max_depth=50, background=(0.70, 0.80, 1.00), vfov=80.0,
        lookfrom=(0.0, 0.0, 9.0), lookat=(0.0, 0.0, 0.0),
    )
    return _finish(b, cfg, "path", overrides, device)


def _cornell_walls(b: SceneBuilder, light_scale: float, light_geom: str):
    """Shared Cornell box walls (the_next_week/mod.rs:358-430 layout)."""
    red = b.lambertian((0.65, 0.05, 0.05))
    white = b.lambertian((0.73, 0.73, 0.73))
    green = b.lambertian((0.12, 0.45, 0.15))
    light = b.diffuse_light((light_scale,) * 3)

    b.add_quad((555, 0, 0), (0, 555, 0), (0, 0, 555), green)
    b.add_quad((0, 0, 0), (0, 555, 0), (0, 0, 555), red)
    if light_geom == "small":
        b.add_quad((343, 554, 332), (-130, 0, 0), (0, 0, -105), light)
    else:
        b.add_quad((113, 554, 127), (330, 0, 0), (0, 0, 305), light)
    b.add_quad((0, 0, 0), (555, 0, 0), (0, 0, 555), white)
    b.add_quad((555, 555, 555), (-555, 0, 0), (0, 0, -555), white)
    b.add_quad((0, 0, 555), (555, 0, 0), (0, 555, 0), white)
    return white


def book2_cornell_box(overrides: Optional[dict] = None, device=None):
    """Scene 7 (the_next_week/mod.rs:358-430): 6 walls and 2 rotated
    boxes, baked into 18 quads."""
    b = SceneBuilder()
    white = _cornell_walls(b, 15.0, "small")
    b.add_box((0, 0, 0), (165, 330, 165), white, rotate_y_deg=15.0,
              translate=(265, 0, 295))
    b.add_box((0, 0, 0), (165, 165, 165), white, rotate_y_deg=-18.0,
              translate=(130, 0, 65))
    cfg = RenderConfig(
        aspect_ratio=1.0, image_width=600, samples_per_pixel=200,
        max_depth=50, background=(0.0, 0.0, 0.0), vfov=40.0,
        lookfrom=(278.0, 278.0, -800.0), lookat=(278.0, 278.0, 0.0),
    )
    return _finish(b, cfg, "path", overrides, device)


def book3_cornell_box(overrides: Optional[dict] = None, device=None):
    """Cornell box + glass sphere with the NEE light list
    (the_rest_of_your_life/mod.rs:69-161): 12 quads (5 walls, the light
    and a rotated box), 1 sphere, 2 NEE lights; MIS, stratified."""
    b = SceneBuilder()
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

    b.add_box((0, 0, 0), (165, 330, 165), white, rotate_y_deg=15.0,
              translate=(265, 0, 295))
    b.add_sphere((190, 90, 190), 90.0, b.dielectric(1.5))

    # NEE targets (EmptyMaterial geometry; mod.rs:128-140)
    b.add_light_quad((343, 554, 332), (-130, 0, 0), (0, 0, -105))
    b.add_light_sphere((190, 90, 190), 90.0)

    cfg = RenderConfig(
        aspect_ratio=1.0, image_width=600, samples_per_pixel=100,
        max_depth=50, background=(0.0, 0.0, 0.0), vfov=40.0,
        lookfrom=(278.0, 278.0, -800.0), lookat=(278.0, 278.0, 0.0),
        stratified=True,
    )
    return _finish(b, cfg, "mis", overrides, device)


SCENES: Dict[str, Callable] = {
    "book1_three_spheres": book1_three_spheres,
    "book1_random_spheres": book1_random_spheres,
    "in_one_weekend": book1_random_spheres,
    "book2_quads": book2_quads,
    "book2_cornell_box": book2_cornell_box,
    "book3_cornell_box": book3_cornell_box,
    "the_rest_of_your_life": book3_cornell_box,
}

# reference scenes whose feature slices (motion, checker, boxes, media,
# Perlin, image textures) are not ported yet
NOT_PORTED = (
    "book2_bouncing_spheres", "book2_checkered_spheres", "book2_earth",
    "book2_perlin_spheres", "book2_simple_light", "book2_cornell_smoke",
    "book2_final_scene", "sphere_field_10k", "the_next_week",
)


def get_scene(name: str, overrides: Optional[dict] = None, device=None):
    if name in NOT_PORTED:
        raise NotImplementedError(f"scene {name!r}: not ported yet")
    if name not in SCENES:
        raise KeyError(f"unknown scene {name!r}")
    return SCENES[name](overrides, device=device)
