"""Scene catalog: the ported reference scenes, as builders."""

from .scenes import (
    NOT_PORTED,
    SCENES,
    book1_random_spheres,
    book1_three_spheres,
    book2_cornell_box,
    book2_quads,
    book3_cornell_box,
    get_scene,
)

__all__ = [
    "NOT_PORTED",
    "SCENES",
    "book1_random_spheres",
    "book1_three_spheres",
    "book2_cornell_box",
    "book2_quads",
    "book3_cornell_box",
    "get_scene",
]
