"""gamer_tpu_torch scene prep and scalar page against the JAX package.

The port's flatten_scene must give the same static structure and the same
float32 params as gamer_tpu's, and its page must equal the TPU kernel's
packed SMEM row (pallas_render._pack_scalars) entry for entry.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import gamer_tpu  # noqa: E402
from gamer_tpu.engine import pallas_render as jpr  # noqa: E402
from gamer_tpu.engine import scene_prep as jsp  # noqa: E402
from gamer_tpu.models import presets  # noqa: E402
from gamer_tpu.ops import camera as jcam  # noqa: E402
from gamer_tpu.scene.schema import ComponentParams  # noqa: E402

from gamer_tpu_torch.engine import cuda_render as cr  # noqa: E402
from gamer_tpu_torch.engine import scene_prep as tsp  # noqa: E402


def _scene(galaxies, camera=(0.5, 0, 0), **cfg):
    insts = [gamer_tpu.GalaxyInstance(galaxy=g, **kw) for g, kw in galaxies]
    return gamer_tpu.Scene(
        camera=gamer_tpu.CameraParams(camera=camera, target=(0, 0, 0),
                                      up=(0, 1, 0), fov=90.0),
        instances=insts,
        config=gamer_tpu.RenderConfig(size=16, ray_step=0.025, **cfg))


def _sparkly():
    g = presets.spiral()
    g.components.append(ComponentParams(
        class_name="stars small", spectrum="White", strength=300.0, r0=0.5,
        z0=0.05, scale=40.0))
    g.components.append(ComponentParams(class_name="no such class"))
    g.components.append(ComponentParams(class_name="disk", active=0.0))
    return g


CASES = {
    **{name: (lambda f=f: _scene([(f(), {})])) for name, f in presets.GALLERY.items()},
    "multi_instance": lambda: _scene(
        [(presets.spiral(), {}),
         (presets.ring(), dict(position=(0.5, 0.2, -0.8),
                               orientation=(0.3, 0.8, 0.1),
                               intensity_scale=0.7)),
         (presets.dusty_disk(), dict(position=(-1.0, 0.0, 0.3)))],
        camera=(2.5, 0.3, 0)),
    "deterministic": lambda: _scene([(_sparkly(), {})], deterministic=True),
    "nondeterministic": lambda: _scene([(_sparkly(), {})], deterministic=False,
                                       dither=True, noise_octaves=4),
}


def _assert_params_equal(ours, ref):
    assert len(ours) == len(ref)
    for pi, pj in zip(ours, ref):
        assert pi.keys() == pj.keys()
        for k in pi:
            if k == "comps":
                assert len(pi[k]) == len(pj[k])
                for ci, cj in zip(pi[k], pj[k]):
                    assert ci.keys() == cj.keys()
                    for f in ci:
                        assert ci[f].dtype == np.float32
                        np.testing.assert_array_equal(ci[f], np.asarray(cj[f]))
            else:
                assert pi[k].dtype == np.float32
                np.testing.assert_array_equal(pi[k], np.asarray(pj[k]))


@pytest.mark.parametrize("case", sorted(CASES))
def test_flatten_matches_jax(case):
    scene = CASES[case]()
    st, pr = tsp.flatten_scene(scene)
    sj, pj = jsp.flatten_scene(scene)
    assert dataclasses.asdict(st) == dataclasses.asdict(sj)
    _assert_params_equal(pr, pj)
    if case == "deterministic":
        assert all(c.cid != 6 for c in st.instances[0].comps)
    if case == "nondeterministic":
        assert any(c.cid == 6 for c in st.instances[0].comps)


@pytest.mark.parametrize("case", sorted(CASES))
def test_from_jax_flat_roundtrips(case):
    scene = CASES[case]()
    st, pr = tsp.from_jax_flat(*jsp.flatten_scene(scene))
    st2, pr2 = tsp.flatten_scene(scene)
    assert st == st2
    _assert_params_equal(pr, pr2)


@pytest.mark.parametrize("case", sorted(CASES))
def test_page_matches_pallas_pack(case):
    """The page is the TPU page's first lay.n entries: bit-exact, except
    the ridged spectral weights (numpy pow here, XLA pow there) within 1 ulp."""
    scene = CASES[case]()
    sj, pj = jsp.flatten_scene(scene)
    st, pr = tsp.from_jax_flat(sj, pj)
    cam = np.asarray(scene.camera.camera, np.float32)
    inv_vp = jcam.inv_view_projection_host(cam, scene.camera.target,
                                           scene.camera.up, scene.camera.fov)
    lay_j = jpr._build_layout(sj)
    lay = cr._build_layout(st)
    assert lay.names == lay_j.names and lay.offsets == lay_j.offsets
    assert lay.n == lay_j.n
    args = (cam, inv_vp, np.float32(0.025), np.float32(0.001))
    ref = np.asarray(jpr._pack_scalars(sj, lay_j, pj, *args)).reshape(-1)[:lay.n]
    page = cr._pack_scalars(st, lay, pr, *args)
    assert page.dtype == np.float32 and page.shape == (lay.n,)
    ridged = np.zeros(lay.n, bool)
    for name in lay.names:
        if name.endswith("ridged_w"):
            o = lay.offsets[name]
            ridged[o:o + lay.sizes[name]] = True
    np.testing.assert_array_equal(page[~ridged], ref[~ridged])
    np.testing.assert_array_max_ulp(page[ridged], ref[ridged], maxulp=1)


@pytest.mark.parametrize("case", sorted(CASES))
def test_table_describes_the_structure(case):
    """The int32 structure table decodes back to the scene's structure and
    points at the right page entries."""
    scene = CASES[case]()
    st, pr = tsp.flatten_scene(scene)
    lay = cr._build_layout(st)
    page = cr._pack_scalars(st, lay, pr, np.zeros(3, np.float32),
                            np.eye(4, dtype=np.float32), np.float32(0.025),
                            np.float32(0.001))
    table = cr._build_table(st, lay)
    assert table.dtype == np.int32
    assert table[cr.T_N_INST] == len(st.instances)
    assert table[cr.T_DITHER] == int(st.dither)
    insts = cr._read_scene(page, table)
    for inst_s, inst_p, dec in zip(st.instances, pr, insts):
        assert dec["max_arms"] == inst_s.max_arms
        np.testing.assert_array_equal(np.float32(dec["pos"]),
                                      inst_p["position"])
        assert np.float32(dec["iscale"]) == inst_p["intensity_scale"]
        assert len(dec["comps"]) == len(inst_s.comps)
        for cs, cp, (srow, cdec) in zip(inst_s.comps, inst_p["comps"],
                                        dec["comps"]):
            assert srow["cid"] == cs.cid
            assert (srow["arm_en"], srow["wind_en"], srow["star_extra"]) == (
                cs.arm_enabled, cs.winding_enabled, cs.star_extra)
            assert (srow["oct10"], srow["oct9"], srow["oct4"]) == (
                cs.oct(10), cs.oct(9), cs.oct(4))
            for f in tsp.COMP_FIELDS:
                assert np.float32(cdec[f]) == cp[f]
            np.testing.assert_array_equal(np.float32(cdec["spec"]), cp["spec"])


@pytest.mark.parametrize("kind", ["simplex", "perlin", "iq"])
def test_layout_and_table_take_every_noise_kind(kind):
    """The page layout does not depend on the kind (its lookup table is not
    part of the page); the table header names it."""
    st, _ = tsp.flatten_scene(_scene([(presets.spiral(), {})],
                                     noise_kind=kind))
    base, _ = tsp.flatten_scene(_scene([(presets.spiral(), {})]))
    lay, lay0 = cr._build_layout(st), cr._build_layout(base)
    assert lay.kind == kind
    assert lay.offsets == lay0.offsets and lay.n == lay0.n
    table, table0 = cr._build_table(st, lay), cr._build_table(base, lay0)
    assert table[cr.T_KIND] == cr.NOISE_KINDS.index(kind)
    keep = np.arange(len(table)) != cr.T_KIND
    np.testing.assert_array_equal(table[keep], table0[keep])
