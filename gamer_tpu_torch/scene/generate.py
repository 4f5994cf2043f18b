"""Scene + dataset generation.

`generate_scene` is the GUI scene mode (mainwindow.cpp:1137-1170): N
instances, each a random pick from a galaxy pool, random unit orientation,
random position in [-1,1]^3 scaled by box_size (the first instance stays at
the origin scale). Seeded (the reference draws from unseeded rand()).

`generate_galaxy_variations` feeds dataset generation (BASELINE config 5):
numeric parameter jitter around a template galaxy, preserving the component
structure (class ids, arm/winding enable flags) so a whole batch shares one
compiled kernel.

A copy of ``gamer_tpu.scene.generate``; the port imports nothing of ``gamer_tpu``.
tests/test_torch_copies.py holds the copy equal to the original.
"""

from __future__ import annotations

import copy
from typing import List, Sequence

import numpy as np

from ..utils.rng import Rng
from .schema import GalaxyData, GalaxyInstance, Scene

# numeric fields safe to jitter without changing compile-time structure
_JITTER_FIELDS = ("strength", "z0", "r0", "scale", "ks", "noise_tilt")


def generate_scene(galaxies: Sequence[GalaxyData], n: int, box_size: float,
                   seed: int = 5489, base_scene: Scene | None = None) -> Scene:
    """N random instances in a box (scene mode parity)."""
    if not galaxies:
        raise ValueError("need at least one galaxy")
    rng = Rng(seed)
    scene = copy.deepcopy(base_scene) if base_scene is not None else Scene()
    scene.instances = []
    for i in range(n):
        g = galaxies[rng.next_int(0, len(galaxies) - 1)]
        orientation = np.asarray(rng.next_vec3(-1, 1))
        nrm = float(np.linalg.norm(orientation))
        orientation = tuple(orientation / (nrm if nrm else 1.0))
        pos = np.asarray(rng.next_vec3(-1, 1))
        if i != 0:
            pos = pos * box_size
        scene.instances.append(
            GalaxyInstance(
                galaxy=copy.deepcopy(g),
                position=tuple(pos),
                orientation=orientation,
                intensity_scale=1.0,
                name=g.params.name,
            )
        )
    return scene


def generate_galaxy_variations(template: GalaxyData, n: int, seed: int = 0,
                               jitter: float = 0.2) -> List[GalaxyData]:
    """n structure-preserving parameter variations of a template galaxy.

    Positive shape/noise parameters are scaled by lognormal-ish factors
    exp(U(-jitter, jitter)); arm phases get uniform rotations; winding
    parameters wiggle within the same sign. Zero-valued fields stay zero so
    the static structure (scene_prep.CompStatic) is unchanged.
    """
    rng = Rng(seed if seed else 5489)
    out: List[GalaxyData] = []
    for _ in range(n):
        g = copy.deepcopy(template)
        p = g.params
        p.winding_b = p.winding_b * np.exp(rng.next_double(-jitter, jitter))
        p.winding_n = p.winding_n * np.exp(rng.next_double(-jitter, jitter))
        phase = rng.next_double(0, 2 * np.pi)
        p.arm1, p.arm2, p.arm3, p.arm4 = (
            p.arm1 + phase, p.arm2 + phase, p.arm3 + phase, p.arm4 + phase)
        for cp in g.components:
            for f in _JITTER_FIELDS:
                v = getattr(cp, f)
                if v != 0:
                    setattr(cp, f, float(v * np.exp(rng.next_double(-jitter, jitter))))
            cp.delta = float(cp.delta + rng.next_double(-0.3, 0.3))
        out.append(g)
    return out
