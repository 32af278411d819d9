"""The canvas ops, the noise host bake and the public functions of ported
modules that were ported last, against the JAX package.

Canvas ops are exact for uint8, float16 and float32; ``hash31`` and the
RGBA8 ``noise_grad3d`` bake are exact; the other public functions
(physics, character, post and shadow) within 1e-6."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clap_tpu.ops import canvas as jc
from clap_tpu.ops import noise as jn
from clap_tpu_torch.ops import canvas as tc
from clap_tpu_torch.ops import noise as tn
from test_torch_common import assert_tree_close, assert_tree_equal, jnp_tree

DTYPES = [("uint8", torch.uint8), ("float16", torch.float16),
          ("float32", torch.float32)]


def seeded(dtype: str, shape, seed):
    rng = np.random.default_rng(seed)
    if dtype == "uint8":
        return rng.integers(0, 256, shape).astype(np.uint8)
    x = rng.uniform(-0.1, 1.1, shape)
    # exact halves exercise round-half-to-even in the u8 conversion
    x.flat[::7] = (rng.integers(0, 256, x.size)[::7] + 0.5) / 255.0
    return x.astype(dtype)


def same(got, ref):
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("src", DTYPES, ids=[d for d, _ in DTYPES])
@pytest.mark.parametrize("dst", DTYPES, ids=[d for d, _ in DTYPES])
def test_convert_equal(src, dst):
    x = seeded(src[0], (9, 11, 4), 0)
    same(tc.convert(torch.from_numpy(x), dst[1]),
         jc.convert(jnp.asarray(x), jnp.dtype(dst[0])))


@pytest.mark.parametrize("dst", DTYPES, ids=[d for d, _ in DTYPES])
@pytest.mark.parametrize("color", [(1.0, 0.5, 0.25, 1.0),
                                   (0.2, 0.77, 0.501960784, 0.0),
                                   (1, 0, 0, 1)])
def test_fill_equal(dst, color):
    img = np.zeros((5, 6, 4), dst[0])
    same(tc.canvas_fill(torch.from_numpy(img), color),
         jc.canvas_fill(jnp.asarray(img), color))


POSITIONS = [(0, 0), (6, 6), (-3, 2), (5, -4), (20, 20), (-9, -9)]


@pytest.mark.parametrize("dst", DTYPES, ids=[d for d, _ in DTYPES])
@pytest.mark.parametrize("src", DTYPES, ids=[d for d, _ in DTYPES])
@pytest.mark.parametrize("op", ["blit", "blend"])
def test_blit_and_blend_equal(dst, src, op):
    d = seeded(dst[0], (12, 10, 4), 1)
    s = seeded(src[0], (6, 5, 4), 2)
    if src[0] != "uint8":
        s = np.clip(s, 0, 1).astype(src[0])
    jf, tf = getattr(jc, f"canvas_{op}"), getattr(tc, f"canvas_{op}")
    for x, y in POSITIONS:
        td = torch.from_numpy(d.copy())
        same(tf(td, torch.from_numpy(s), x, y),
             jf(jnp.asarray(d), jnp.asarray(s), x, y))
        np.testing.assert_array_equal(td.numpy(), d)   # dst untouched


def test_hash31_equal():
    rng = np.random.default_rng(3)
    x, y, z = rng.integers(-2**31, 2**31, (3, 4096))
    for seed in (0, 1337, 2**32 - 1):
        np.testing.assert_array_equal(tn.hash31(x, y, z, seed),
                                      jn.hash31(x, y, z, seed))
    p = rng.uniform(-20, 20, (3, 512))
    np.testing.assert_array_equal(
        tn.fbm3_periodic(*p, 4, 2.0, 0.5, 8, 7),
        jn.fbm3_periodic(*p, 4, 2.0, 0.5, 8, 7))


@pytest.mark.parametrize("kw", [dict(), dict(size=16, octaves=3, seed=5,
                                              period_units=4.0)])
def test_noise_grad3d_bake_equal(kw):
    got = tn.noise_grad3d(**kw)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, jn.noise_grad3d(**kw))


# ---------------------------------------------------------------------------
# the public functions of ported modules added last
# ---------------------------------------------------------------------------

def _world():
    """The entry testbed's static world in both packages (ENTRY_SCENE)."""
    from clap_tpu.scene.testbed import build_testbed
    from test_torch_common import ENTRY_SCENE, to_port

    tb = build_testbed(**ENTRY_SCENE)
    return tb.cfg.world, to_port(tb.cfg.world)


def _geometry(seed):
    """A seeded triangle soup as both packages' SceneGeometry (one env in
    the port)."""
    from clap_tpu.render.pipeline import SceneGeometry as JGeom
    from clap_tpu_torch.render.pipeline import SceneGeometry as TGeom

    rng = np.random.default_rng(seed)
    T = 40
    verts = rng.uniform(-4, 4, (3 * T, 3)).astype(np.float32)
    verts[:, 1] = rng.uniform(0, 3, 3 * T)
    faces = np.arange(3 * T, dtype=np.int32).reshape(T, 3)
    valid = rng.uniform(size=T) < 0.8
    zeros = np.zeros_like(verts)
    jg = JGeom(verts=jnp.asarray(verts), normals=jnp.asarray(zeros),
               faces=jnp.asarray(faces), face_valid=jnp.asarray(valid),
               base_color=jnp.asarray(zeros),
               rough_metal=jnp.zeros((3 * T, 2)),
               emission=jnp.asarray(zeros))
    t = torch.from_numpy
    tg = TGeom(verts=t(verts)[None], normals=t(zeros), faces=t(faces),
               face_valid=t(valid)[None], base_color=t(zeros),
               rough_metal=torch.zeros(3 * T, 2), emission=t(zeros))
    return jg, tg


def _light_camera():
    from clap_tpu import mathx as jmx

    view = jmx.mat4_look_at(jnp.array([4.0, 9.0, 3.0]), jnp.zeros(3),
                            jnp.array([0.0, 1.0, 0.0]))
    proj = jmx.mat4_ortho(-7.0, 7.0, -7.0, 7.0, 0.1, 30.0)
    return np.array(view), np.array(proj)


def case_capsule_inertia(rng):
    from clap_tpu.physics.world import capsule_inertia as J
    from clap_tpu_torch.physics.world import (capsule_inertia,
                                              capsule_inertia_np)

    m, r, h = rng.uniform(0.0, 3.0, (3, 64)).astype(np.float32)
    r[:4] = 0.0
    h[4:8] = 0.0
    got = capsule_inertia(*map(torch.from_numpy, (m, r, h)))
    np.testing.assert_array_equal(got.numpy(), capsule_inertia_np(m, r, h))
    return J(*map(jnp.asarray, (m, r, h))), got


def case_phys_state_init(rng):
    from clap_tpu.physics.world import phys_state_init as J
    from clap_tpu_torch.physics.world import phys_state_init

    return J(5), phys_state_init(5, device="cpu")


def case_char_state_init(rng):
    from clap_tpu.char.controller import char_state_init as J
    from clap_tpu_torch.char.controller import char_state_init

    return J(), char_state_init(device="cpu")


def case_hf_normal(rng):
    from clap_tpu.physics.heightfield import hf_normal as J
    from clap_tpu_torch.physics.heightfield import hf_normal

    jw, tw = _world()
    x, z = rng.uniform(-25, 25, (2, 200)).astype(np.float32)
    return (J(jw.hf, jnp.asarray(x), jnp.asarray(z)),
            hf_normal(tw.hf, torch.from_numpy(x), torch.from_numpy(z)))


def _centers(rng):
    c = rng.uniform(-12, 12, (16, 3)).astype(np.float32)
    c[:, 1] = rng.uniform(-1.0, 4.0, 16)
    return c


def case_sphere_world_contacts(rng):
    import jax

    from clap_tpu.physics.narrowphase import sphere_world_contacts as J
    from clap_tpu_torch.physics.narrowphase import sphere_world_contacts

    jw, tw = _world()
    c = _centers(rng)
    ref = jax.vmap(lambda p: J(jw, p, 0.6))(jnp.asarray(c))
    return ref, sphere_world_contacts(tw, torch.from_numpy(c), 0.6)


def case_deepest_contact(rng):
    import jax

    from clap_tpu.physics.narrowphase import deepest_contact as J
    from clap_tpu.physics.narrowphase import sphere_world_contacts as JS
    from clap_tpu_torch.physics.narrowphase import (deepest_contact,
                                                    sphere_world_contacts)

    jw, tw = _world()
    c = _centers(rng)
    ref = jax.vmap(lambda p: J(JS(jw, p, 1.5)))(jnp.asarray(c))
    got = deepest_contact(sphere_world_contacts(tw, torch.from_numpy(c),
                                                1.5))
    assert bool(np.asarray(ref[3]).any()) and not bool(np.asarray(
        ref[3]).all())
    return tuple(ref), got


def case_closest_pt_segment(rng):
    from clap_tpu.physics.shapes import closest_pt_segment as J
    from clap_tpu_torch.physics.shapes import closest_pt_segment

    p, a, b = rng.uniform(-3, 3, (3, 128, 3)).astype(np.float32)
    b[:8] = a[:8]                             # degenerate segments
    return (J(*map(jnp.asarray, (p, a, b))),
            closest_pt_segment(*map(torch.from_numpy, (p, a, b))))


def case_bloom_chain(rng):
    from clap_tpu.render.post import bloom_chain as J
    from clap_tpu_torch.render.post import bloom_chain

    e = rng.uniform(0, 2, (24, 40, 3)).astype(np.float32)
    return (J(jnp.asarray(e), 24, 40, 0.7, 1.3),
            bloom_chain(torch.from_numpy(e)[None], 24, 40, 0.7, 1.3)[0])


def case_radial_fog(rng):
    from clap_tpu.render.post import radial_fog as J
    from clap_tpu_torch.render.post import radial_fog

    col = rng.uniform(0, 1, (16, 20, 3)).astype(np.float32)
    dist = rng.uniform(0, 200, (16, 20)).astype(np.float32)
    noise = rng.uniform(0, 1, (16, 20)).astype(np.float32)
    fog = np.array([0.58, 0.68, 0.78], np.float32)
    out = []
    for nz in (None, noise):
        ref = J(*map(jnp.asarray, (col, dist, fog)), 80.0, 160.0,
                None if nz is None else jnp.asarray(nz))
        got = radial_fog(torch.from_numpy(col)[None],
                         torch.from_numpy(dist)[None], torch.from_numpy(fog),
                         80.0, 160.0,
                         None if nz is None else torch.from_numpy(nz)[None])
        out.append((ref, got[0]))
    return tuple(r for r, _ in out), tuple(g for _, g in out)


def case_shadow_pass(rng):
    from clap_tpu.render.pipeline import RenderOptions as JOpts
    from clap_tpu.render.pipeline import shadow_pass as J
    from clap_tpu_torch.render.pipeline import RenderOptions, shadow_pass

    jg, tg = _geometry(int(rng.integers(1 << 30)))
    view, proj = _light_camera()
    ref = J(JOpts(width=64, height=64, shadow_size=64), jg,
            jnp.asarray(view), jnp.asarray(proj))
    got = shadow_pass(RenderOptions(width=64, height=64, shadow_size=64), tg,
                      torch.from_numpy(view)[None],
                      torch.from_numpy(proj)[None])[0]
    assert float(np.asarray(ref)[..., 0].min()) < 0.99   # casters drawn
    return ref, got


def case_camera_target(rng):
    from clap_tpu.render.camera import camera_target as J
    from clap_tpu_torch.render.camera import camera_target

    pos, head = rng.uniform(-5, 5, (2, 3)).astype(np.float32)
    h = np.float32(1.83)
    refs = [J(jnp.asarray(pos), jnp.asarray(h))]
    gots = [camera_target(torch.from_numpy(pos), torch.tensor(h))]
    for has in (True, False, np.bool_(True), np.bool_(False)):
        jh = has if isinstance(has, bool) else jnp.asarray(has)
        th = has if isinstance(has, bool) else torch.tensor(bool(has))
        refs.append(J(jnp.asarray(pos), jnp.asarray(h), jnp.asarray(head),
                      jh))
        gots.append(camera_target(torch.from_numpy(pos), torch.tensor(h),
                                  torch.from_numpy(head), th))
    return tuple(refs), tuple(gots)


CASES = [case_capsule_inertia, case_phys_state_init, case_char_state_init,
         case_hf_normal, case_sphere_world_contacts, case_deepest_contact,
         case_closest_pt_segment, case_bloom_chain, case_radial_fog,
         case_shadow_pass, case_camera_target]


@pytest.mark.parametrize("case", CASES,
                         ids=[c.__name__[5:] for c in CASES])
def test_public_functions_equal(case):
    """Each public function on seeded inputs: the JAX package's result and
    the port's, ints and bools exact, floats within 1e-6."""
    ref, got = case(np.random.default_rng(11))
    assert_tree_close(jnp_tree(ref), got, atol=1e-6, rtol=0.0)


def test_init_states_bit_exact():
    """The initial states equal the JAX package's bit for bit (values and
    dtypes)."""
    for case in (case_phys_state_init, case_char_state_init):
        ref, got = case(None)
        assert_tree_equal(jnp_tree(ref), got)
