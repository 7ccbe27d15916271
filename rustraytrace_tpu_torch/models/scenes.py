"""Scene catalog (counterpart: ``rustraytrace_tpu/models/scenes.py``).

Every reference scene, ported with the JAX package's constants, seed
(0x5EED_1234, the reference's GPU scene seed) and draw order, so each
builds a bit-equal scene: the two Book-1 scenes, the nine Book-2 scenes
(``get_scene("the_next_week", scene_num=n)``; no number builds the final
scene), the Book-3 Cornell box and the 10,000-sphere scaling field.

Each builder returns ``(scene, cfg, integrator)``.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from ..config import RenderConfig
from ..scene import Scene, SceneBuilder

_SCENE_SEED = 0x5EED_1234


def earthmap() -> Tuple[np.ndarray, str]:
    """(image [h, w, 3] float32 in [0, 1], source) of the Book-2 globe.

    Decodes earthmap.jpg from $RTW_IMAGES, then from the repository's
    ``assets`` directory (the reference's search order, rtw_image.rs:11-36),
    as the JAX package's ``_load_earthmap`` does.  Where no file decodes
    (no PIL on the host), it builds the same procedural blue-green globe,
    and ``source`` says "procedural"."""
    candidates = []
    env = os.environ.get("RTW_IMAGES")
    if env:
        candidates.append(os.path.join(env, "earthmap.jpg"))
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    candidates.append(os.path.join(repo, "assets", "earthmap.jpg"))
    for path in candidates:
        if os.path.exists(path):
            try:
                from PIL import Image

                img = np.asarray(Image.open(path).convert("RGB"),
                                 np.float32) / 255.0
                return img, path
            except Exception:
                continue
    # procedural fallback: latitude bands + longitude wobble
    h, w = 256, 512
    v, u = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                       indexing="ij")
    land = (np.sin(u * 21.0) * np.cos(v * 17.0) + np.sin(u * 5 + v * 9)) > 0.3
    img = np.where(land[..., None],
                   np.array([0.1, 0.5, 0.15], np.float32),
                   np.array([0.05, 0.15, 0.5], np.float32))
    return img.astype(np.float32), "procedural"


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


def sphere_field_10k(overrides: Optional[dict] = None,
                     seed: int = _SCENE_SEED, half: int = 50, device=None):
    """Scaling scene beyond the reference: the Book-1 material mix on a
    100x100 grid (10,001 spheres), which takes the two-level SAH cull."""
    b = SceneBuilder()
    _random_sphere_field(b, np.random.default_rng(seed), moving=False,
                         checker_ground=False, half=half)
    cfg = RenderConfig(
        aspect_ratio=16.0 / 9.0, image_width=1200, samples_per_pixel=10,
        max_depth=20, vfov=20.0, lookfrom=(13.0, 2.0, 3.0),
        lookat=(0.0, 0.0, 0.0), defocus_angle=0.6, focus_dist=10.0,
    )
    return _finish(b, cfg, "path", overrides, device)


def book2_bouncing_spheres(overrides: Optional[dict] = None,
                           seed: int = _SCENE_SEED, device=None):
    """Scene 1 (the_next_week/mod.rs:83-155): moving lambertians over a
    checker ground."""
    b = SceneBuilder()
    _random_sphere_field(b, np.random.default_rng(seed), moving=True,
                         checker_ground=True)
    cfg = RenderConfig(
        aspect_ratio=16.0 / 9.0, image_width=400, samples_per_pixel=100,
        max_depth=50, background=(0.70, 0.80, 1.00), vfov=20.0,
        lookfrom=(13.0, 2.0, 3.0), lookat=(0.0, 0.0, 0.0),
        defocus_angle=0.6, focus_dist=10.0,
    )
    return _finish(b, cfg, "path", overrides, device)


def book2_checkered_spheres(overrides: Optional[dict] = None, device=None):
    """Scene 2 (mod.rs:157-194): two checkered spheres."""
    b = SceneBuilder()
    tex = b.checker(0.32, (0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    mat = b.lambertian(tex=tex)
    b.add_sphere((0.0, -10.0, 0.0), 10.0, mat)
    b.add_sphere((0.0, 10.0, 0.0), 10.0, mat)
    cfg = RenderConfig(
        aspect_ratio=16.0 / 9.0, image_width=400, samples_per_pixel=100,
        max_depth=50, background=(0.70, 0.80, 1.00), vfov=20.0,
        lookfrom=(13.0, 2.0, 3.0), lookat=(0.0, 0.0, 0.0),
    )
    return _finish(b, cfg, "path", overrides, device)


def book2_earth(overrides: Optional[dict] = None, device=None):
    """Scene 3 (mod.rs:196-220): the earthmap globe."""
    b = SceneBuilder()
    tex = b.image_texture(earthmap()[0])
    b.add_sphere((0.0, 0.0, 0.0), 2.0, b.lambertian(tex=tex))
    cfg = RenderConfig(
        aspect_ratio=16.0 / 9.0, image_width=400, samples_per_pixel=100,
        max_depth=50, background=(0.70, 0.80, 1.00), vfov=20.0,
        lookfrom=(0.0, 0.0, 12.0), lookat=(0.0, 0.0, 0.0),
    )
    return _finish(b, cfg, "path", overrides, device)


def book2_perlin_spheres(overrides: Optional[dict] = None, device=None):
    """Scene 4 (mod.rs:222-254): marble noise texture."""
    b = SceneBuilder()
    tex = b.noise(4.0)
    mat = b.lambertian(tex=tex)
    b.add_sphere((0.0, -1000.0, 0.0), 1000.0, mat)
    b.add_sphere((0.0, 2.0, 0.0), 2.0, mat)
    cfg = RenderConfig(
        aspect_ratio=16.0 / 9.0, image_width=400, samples_per_pixel=100,
        max_depth=50, background=(0.70, 0.80, 1.00), vfov=20.0,
        lookfrom=(13.0, 2.0, 3.0), lookat=(0.0, 0.0, 0.0),
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


def book2_simple_light(overrides: Optional[dict] = None, device=None):
    """Scene 6 (mod.rs:315-356): marble spheres, an emissive quad and an
    emissive sphere."""
    b = SceneBuilder()
    tex = b.noise(4.0)
    mat = b.lambertian(tex=tex)
    b.add_sphere((0.0, -1000.0, 0.0), 1000.0, mat)
    b.add_sphere((0.0, 2.0, 0.0), 2.0, mat)
    light = b.diffuse_light((4.0, 4.0, 4.0))
    b.add_sphere((0.0, 7.0, 0.0), 2.0, light)
    b.add_quad((3, 1, -2), (2, 0, 0), (0, 2, 0), light)
    cfg = RenderConfig(
        aspect_ratio=16.0 / 9.0, image_width=400, samples_per_pixel=100,
        max_depth=50, background=(0.0, 0.0, 0.0), vfov=20.0,
        lookfrom=(26.0, 3.0, 6.0), lookat=(0.0, 2.0, 0.0),
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


def book2_cornell_smoke(overrides: Optional[dict] = None, device=None):
    """Scene 8 (mod.rs:432-505): the walls and two rotated constant-medium
    boxes, black smoke and white fog."""
    b = SceneBuilder()
    _cornell_walls(b, 7.0, "big")
    b.add_medium_box((0, 0, 0), (165, 330, 165), 0.01,
                     b.isotropic((0.0, 0.0, 0.0)),
                     rotate_y_deg=15.0, translate=(265, 0, 295))
    b.add_medium_box((0, 0, 0), (165, 165, 165), 0.01,
                     b.isotropic((1.0, 1.0, 1.0)),
                     rotate_y_deg=-18.0, translate=(130, 0, 65))
    cfg = RenderConfig(
        aspect_ratio=1.0, image_width=600, samples_per_pixel=200,
        max_depth=50, background=(0.0, 0.0, 0.0), vfov=40.0,
        lookfrom=(278.0, 278.0, -800.0), lookat=(278.0, 278.0, 0.0),
    )
    return _finish(b, cfg, "path", overrides, device)


def book2_final_scene(overrides: Optional[dict] = None, image_width=400,
                      samples_per_pixel=250, max_depth=4,
                      seed: int = _SCENE_SEED, device=None):
    """Scene 9 and the Book-2 default (mod.rs:507-624): 400 ground boxes, a
    light quad, a moving sphere, glass, metal, a glass sphere filled with
    blue medium, a whole-scene mist, the earth globe, a marble sphere and a
    1000-sphere cloud: 1,006 spheres, 400 boxes, 1 quad, 2 media."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()

    ground = b.lambertian((0.48, 0.83, 0.53))
    for i in range(20):
        for j in range(20):
            w = 100.0
            x0 = -1000.0 + i * w
            z0 = -1000.0 + j * w
            y1 = rng.random() * 100.0 + 1.0
            b.add_box((x0, 0.0, z0), (x0 + w, y1, z0 + w), ground)

    b.add_quad((123, 554, 147), (300, 0, 0), (0, 0, 265),
               b.diffuse_light((7.0, 7.0, 7.0)))

    c1 = np.array([400.0, 400.0, 200.0])
    b.add_sphere(c1, 50.0, b.lambertian((0.7, 0.3, 0.1)),
                 center2=c1 + np.array([30.0, 0.0, 0.0]))
    b.add_sphere((260, 150, 45), 50.0, b.dielectric(1.5))
    b.add_sphere((0, 150, 145), 50.0, b.metal((0.8, 0.8, 0.9), 1.0))

    # glass boundary with a blue medium inside (mod.rs:558-568)
    b.add_sphere((360, 150, 145), 70.0, b.dielectric(1.5))
    b.add_medium_sphere((360, 150, 145), 70.0, 0.2,
                        b.isotropic((0.2, 0.4, 0.9)))
    # whole-scene mist (mod.rs:570-579)
    b.add_medium_sphere((0, 0, 0), 5000.0, 0.0001,
                        b.isotropic((1.0, 1.0, 1.0)))

    b.add_sphere((400, 200, 400), 100.0,
                 b.lambertian(tex=b.image_texture(earthmap()[0])))
    b.add_sphere((220, 280, 300), 80.0, b.lambertian(tex=b.noise(0.2)))

    white = b.lambertian((0.73, 0.73, 0.73))
    for _ in range(1000):
        center = rng.uniform(0.0, 165.0, 3)
        q, _, _ = _rotate_translate_point(center, 15.0, (-100, 270, 395))
        b.add_sphere(q, 10.0, white)

    cfg = RenderConfig(
        aspect_ratio=1.0, image_width=image_width,
        samples_per_pixel=samples_per_pixel, max_depth=max_depth,
        background=(0.0, 0.0, 0.0), vfov=40.0,
        lookfrom=(478.0, 278.0, -600.0), lookat=(278.0, 278.0, 0.0),
    )
    return _finish(b, cfg, "path", overrides, device)


def _rotate_translate_point(p, rotate_y_deg, translate):
    """RotateY then Translate of a point (hittable.rs:143-170)."""
    rad = np.radians(rotate_y_deg)
    c, s = np.cos(rad), np.sin(rad)
    q = np.array([c * p[0] + s * p[2], p[1], -s * p[0] + c * p[2]])
    return q + np.asarray(translate, np.float64), c, s


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
    "book2_bouncing_spheres": book2_bouncing_spheres,
    "book2_checkered_spheres": book2_checkered_spheres,
    "book2_earth": book2_earth,
    "book2_perlin_spheres": book2_perlin_spheres,
    "book2_quads": book2_quads,
    "book2_simple_light": book2_simple_light,
    "book2_cornell_box": book2_cornell_box,
    "book2_cornell_smoke": book2_cornell_smoke,
    "book2_final_scene": book2_final_scene,
    "book3_cornell_box": book3_cornell_box,
    "the_rest_of_your_life": book3_cornell_box,
    "sphere_field_10k": sphere_field_10k,
}

# Book-2 numeric dispatch (the_next_week/mod.rs:68-81)
BOOK2_SCENES: Dict[int, Callable] = {
    1: book2_bouncing_spheres,
    2: book2_checkered_spheres,
    3: book2_earth,
    4: book2_perlin_spheres,
    5: book2_quads,
    6: book2_simple_light,
    7: book2_cornell_box,
    8: book2_cornell_smoke,
    9: lambda overrides=None, device=None: book2_final_scene(
        overrides, image_width=800, samples_per_pixel=10000, max_depth=40,
        device=device),
}

# book-name normalization (main.rs:7-12: lowercase, strip non-alphanumerics)
# and the reference's accepted aliases (main.rs:87-96)
_BOOK_ALIASES = {
    "inoneweekend": "in_one_weekend", "oneweekend": "in_one_weekend",
    "weekend": "in_one_weekend", "book1": "in_one_weekend",
    "thenextweek": "the_next_week", "nextweek": "the_next_week",
    "next": "the_next_week", "book2": "the_next_week",
    "therestofyourlife": "the_rest_of_your_life",
    "restofyourlife": "the_rest_of_your_life",
    "rest": "the_rest_of_your_life", "restoflife": "the_rest_of_your_life",
    "book3": "the_rest_of_your_life",
}


def normalize_scene_name(name: str) -> str:
    """Resolve a scene or book name as the reference CLI does (main.rs:7-12
    normalization, main.rs:87-96 aliases), extended to the registry's own
    names (``book2-earth`` works too)."""
    if name in SCENES or name == "the_next_week":
        return name
    key = "".join(c for c in name.lower() if c.isalnum())
    if key in _BOOK_ALIASES:
        return _BOOK_ALIASES[key]
    for reg in list(SCENES) + ["the_next_week"]:
        if key == "".join(c for c in reg if c.isalnum()):
            return reg
    return name


def get_scene(name: str, overrides: Optional[dict] = None,
              scene_num: Optional[int] = None, device=None):
    """(scene, cfg, integrator) of a scene or book name; ``the_next_week``
    takes the Book-2 scene number (the final scene without one)."""
    name = normalize_scene_name(name)
    if name == "the_next_week":
        fn = BOOK2_SCENES.get(scene_num or 0, book2_final_scene)
        return fn(overrides, device=device)
    if name not in SCENES:
        raise KeyError(f"unknown scene {name!r}")
    return SCENES[name](overrides, device=device)
