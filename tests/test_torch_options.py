"""The port's render options against the JAX package, function by
function, at the JAX tests' small sizes (64², 96 × 64, 128 × 96), 2 envs
where the port batches:

- ``laplace_edges``, ``film_grain`` (tiled over a frame larger than the
  noise), ``bake_lut`` / ``apply_lut`` for all 14 presets, ``menu_blur``
  and ``downsample_pool``: within 1e-6;
- the device noise against the JAX package run eagerly: ``_hash31``
  exact (uint32 wraparound, negative and large lattice ids), ``noise_glsl``
  within 1e-6, ``noise3d_field`` and ``fog_cloud`` within 1e-5 (the
  central difference doubles an ulp of the fBm before it normalises);
- ``ssao`` (kernel mode) and ``pcf_shadow``: both truncate clipped float
  tap positions to pixels, so an ulp can move a tap by one pixel. Bar:
  >= 99 % of pixels within 1e-5, every pixel within 2 taps' worth (2/16,
  2/25);
- the committed tables (``ssao_kernel``, ``blue_noise2d``) equal to the
  JAX package's draws, and the port's functions of the JAX draws within
  1e-6 of the JAX results.

``render_frame`` with each option on is in tests/test_torch_options_frame.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clap_tpu.ops import noise as jnoise
from clap_tpu.render import lut as jlut
from clap_tpu.render import pipeline as jpl
from clap_tpu.render import post as jpost
from clap_tpu.render import shade as jshade
from clap_tpu_torch.ops import noise as tnoise
from clap_tpu_torch.render import lut as tlut
from clap_tpu_torch.render import pipeline as tpl
from clap_tpu_torch.render import post as tpost
from clap_tpu_torch.render import shade as tshade
import test_torch_common  # noqa: F401  (one torch thread per worker)

TIGHT = dict(atol=1e-6, rtol=0)
B = 2


def per_env(fn, *arrays):
    """The JAX package's single-image function over the env axis, eagerly
    env by env."""
    return np.stack([np.asarray(fn(*(jnp.asarray(a[i]) for a in arrays)))
                     for i in range(B)])


def t(a):
    return torch.as_tensor(np.array(a))


# ---------------------------------------------------------------------------
# image ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", [3, 5])
def test_laplace_edges(kernel):
    d = np.random.default_rng(1).uniform(0.2, 1.0, (B, 64, 64)) \
        .astype(np.float32)
    ref = per_env(lambda x: jpost.laplace_edges(x, kernel), d)
    np.testing.assert_allclose(tpost.laplace_edges(t(d), kernel).numpy(),
                               ref, **TIGHT)


@pytest.mark.parametrize("channels", [1, 3])
def test_film_grain(channels):
    """96 × 128 frames over a 64² noise: the noise tiles."""
    rng = np.random.default_rng(2)
    color = rng.uniform(size=(B, 96, 128, 3)).astype(np.float32)
    noise = rng.uniform(size=(64, 64, 3)).astype(np.float32)
    if channels == 1:
        noise = noise[..., 0]
    ref = per_env(lambda c: jpost.film_grain(c, jnp.asarray(noise), 0.03),
                  color)
    got = tpost.film_grain(t(color), t(noise), 0.03)
    np.testing.assert_allclose(got.numpy(), ref, **TIGHT)


def test_menu_blur():
    frame = np.random.default_rng(3).uniform(size=(B, 64, 96, 3)) \
        .astype(np.float32)
    opts = tpl.RenderOptions(width=96, height=64)
    ref = per_env(lambda f: jpl.menu_blur(f, jpl.RenderOptions()), frame)
    np.testing.assert_allclose(tpl.menu_blur(t(frame), opts).numpy(), ref,
                               **TIGHT)


@pytest.mark.parametrize("f", [2, 4])
def test_downsample_pool(f):
    img = np.random.default_rng(4).uniform(size=(B, 96, 64, 3)) \
        .astype(np.float32)
    ref = per_env(lambda x: jpost.downsample_pool(x, f), img)
    np.testing.assert_allclose(tpost.downsample_pool(t(img), f).numpy(),
                               ref, **TIGHT)


@pytest.mark.parametrize("name", [p.name for p in jlut.LUT_PRESETS])
def test_lut_preset(name):
    """bake_lut at 16³ and apply_lut of random colours (some outside
    [0, 1]) through it."""
    jp, tp = jlut.lut_find(name), tlut.lut_find(name)
    assert (tp.exposure, tp.contrast) == (jp.exposure, jp.contrast)
    jv = jlut.bake_lut(jp, 16)
    tv = tlut.bake_lut(tp, 16, device="cpu")
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TIGHT)
    color = np.random.default_rng(5).uniform(
        -0.1, 1.1, (B, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(jlut.apply_lut(jnp.asarray(color), jv))
    np.testing.assert_allclose(tlut.apply_lut(t(color), tv).numpy(), ref,
                               **TIGHT)


def test_lut_presets_listed_alike():
    assert [p.name for p in tlut.LUT_PRESETS] == \
        [p.name for p in jlut.LUT_PRESETS]
    with pytest.raises(KeyError):
        tlut.lut_find("no such preset")


# ---------------------------------------------------------------------------
# device noise
# ---------------------------------------------------------------------------

def test_hash31_exact():
    rng = np.random.default_rng(6)
    ints = [rng.integers(-2**31, 2**31, 4096).astype(np.int32)
            for _ in range(3)]
    ints[0][:64] = np.arange(-32, 32)
    for seed in (0, 1337, 1340, 2**31 + 5):
        ref = np.asarray(jnoise._hash31_jnp(*(jnp.asarray(i) for i in ints),
                                            seed))
        got = tnoise._hash31(*(t(i) for i in ints), seed).numpy()
        assert got.dtype == ref.dtype == np.float32
        assert np.array_equal(got, ref)


def _points(n=4096, scale=40.0):
    return (np.random.default_rng(7).uniform(-1, 1, (n, 3)) * scale) \
        .astype(np.float32)


def test_noise_glsl():
    p = _points()
    ref = np.asarray(jnoise.noise_glsl(jnp.asarray(p)))
    np.testing.assert_allclose(tnoise.noise_glsl(t(p)).numpy(), ref,
                               **TIGHT)


@pytest.mark.parametrize("freq", [0.05, 0.37])
def test_noise3d_field(freq):
    p = _points(2048)
    ref = np.asarray(jnoise.noise3d_field(jnp.asarray(p), freq))
    got = tnoise.noise3d_field(t(p), freq).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def test_fog_cloud():
    p = _points(2048, 60.0).reshape(2, 32, 32, 3)
    ref = np.asarray(jnoise.fog_cloud(jnp.asarray(p), 1.0, 0.05))
    got = tnoise.fog_cloud(t(p), 1.0, 0.05).numpy()
    assert 0.05 < (got > 0).mean() < 0.95      # a cloud, not a constant
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# the tables the JAX package draws from its PRNG
# ---------------------------------------------------------------------------

def test_committed_ssao_kernel_is_the_jax_draw():
    ref = np.asarray(jpost.ssao_kernel(jax.random.PRNGKey(7)))
    got = tpost.ssao_kernel(device="cpu").numpy()
    assert got.dtype == np.float32 and np.array_equal(got, ref)


def test_ssao_kernel_of_draws():
    key = jax.random.PRNGKey(11)
    k1, k2, k3 = jax.random.split(key, 3)
    draws = np.stack([
        np.asarray(jax.random.uniform(k1, (16,), minval=-1, maxval=1)),
        np.asarray(jax.random.uniform(k2, (16,), minval=-1, maxval=1)),
        np.asarray(jax.random.uniform(k3, (16,), minval=0, maxval=1))], -1)
    np.testing.assert_allclose(
        tpost.ssao_kernel(draws, device="cpu").numpy(),
        np.asarray(jpost.ssao_kernel(key)), **TIGHT)


def test_committed_blue_noise_is_the_jax_draw():
    ref = np.asarray(jnoise.blue_noise2d(64))
    got = tnoise.blue_noise2d(64, device="cpu").numpy()
    assert got.dtype == np.float32 and np.array_equal(got, ref)
    with pytest.raises(ValueError):
        tnoise.blue_noise2d(32, device="cpu")


@pytest.mark.parametrize("size", [32, 64])
def test_blue_noise_of_draws(size):
    key = jax.random.PRNGKey(size)
    draws = np.stack([np.asarray(jax.random.uniform(k, (size, size)))
                      for k in jax.random.split(key, 3)])
    np.testing.assert_allclose(
        tnoise.blue_noise2d(size, draws, device="cpu").numpy(),
        np.asarray(jnoise.blue_noise2d(size, key)), **TIGHT)
    np.testing.assert_allclose(
        tnoise.blue_noise_luma(size, draws, device="cpu").numpy(),
        np.asarray(jnoise.blue_noise_luma(size, key)), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# integer taps: hemisphere SSAO and PCF
# ---------------------------------------------------------------------------

def _surface(h=96, w=128):
    """View-space positions and normals of a bumpy surface seen in
    perspective, 2 envs."""
    ys, xs = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w),
                         indexing="ij")
    out_p, out_n = [], []
    for env in range(B):
        z = -(5.0 + 0.6 * np.sin(xs * 7 + env) + 0.4 * np.cos(ys * 5)
              + 2.0 * (ys > 0.3 + 0.1 * env))
        p = np.stack([xs * -z * 0.6, ys * -z * 0.45, z], -1)
        dx = np.gradient(p, axis=1)
        dy = np.gradient(p, axis=0)
        n = np.cross(dx, dy)
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        out_p.append(p)
        out_n.append(n)
    return (np.stack(out_p).astype(np.float32),
            np.stack(out_n).astype(np.float32))


def _agree(got, ref, taps):
    diff = np.abs(got - ref)
    return float((diff <= 1e-5).mean()), float(diff.max()), 2.0 / taps


def test_ssao_kernel_mode():
    vpos, vnrm = _surface()
    kern = np.asarray(jpost.ssao_kernel(jax.random.PRNGKey(7)))
    ref = per_env(lambda p, n: jpost.ssao(p, n, jnp.asarray(kern)), vpos,
                  vnrm)
    got = tpost.ssao(t(vpos), t(vnrm), t(kern)).numpy()
    share, worst, bar = _agree(got, ref, 16)
    assert got.shape == ref.shape and 0.0 < got.mean() < 1.0
    assert share >= 0.99 and worst <= bar, (share, worst)


def _pcf_inputs(shared):
    rng = np.random.default_rng(8)
    S, C = 32, 4
    yy, xx = np.meshgrid(np.arange(S), np.arange(S), indexing="ij")
    maps = np.stack([[0.5 + 0.3 * np.sin(xx / (3 + c) + e) * np.cos(yy / 4)
                      for c in range(C)] for e in range(B)]) \
        .astype(np.float32)
    mvps = np.tile(np.eye(4, dtype=np.float32), (B, C, 1, 1))
    for c in range(C):
        mvps[:, c, :3, :3] *= 1.0 / (6.0 * (c + 1))
        mvps[:, c, 2, 3] = 0.05
    wpos = rng.uniform(-12, 12, (B, 64, 96, 3)).astype(np.float32)
    vd = rng.uniform(0, 90, (B, 64, 96)).astype(np.float32)
    nrm = rng.standard_normal((B, 64, 96, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    dists = np.array([10.0, 25.0, 50.0, 100.0], np.float32)
    ldir = np.array([-0.4, -0.8, -0.4], np.float32)
    ldir /= np.linalg.norm(ldir)
    if shared:
        maps, mvps = maps[0], mvps[0]
    return maps, mvps, dists, wpos, vd, nrm, ldir


@pytest.mark.parametrize("shared", [False, True])
def test_pcf_shadow(shared):
    maps, mvps, dists, wpos, vd, nrm, ldir = _pcf_inputs(shared)
    ref = np.stack([np.asarray(jshade.pcf_shadow(
        jnp.asarray(maps if shared else maps[e]),
        jnp.asarray(mvps if shared else mvps[e]), jnp.asarray(dists),
        jnp.asarray(wpos[e]), jnp.asarray(vd[e]), jnp.asarray(nrm[e]),
        jnp.asarray(ldir))) for e in range(B)])
    got = tshade.pcf_shadow(t(maps), t(mvps), t(dists), t(wpos), t(vd),
                            t(nrm), t(ldir)).numpy()
    share, worst, bar = _agree(got, ref, 25)
    assert 0.05 < ((got > 0) & (got < 1)).mean()     # penumbrae exist
    assert share >= 0.99 and worst <= bar, (share, worst)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("kind", ["vsm", "pcf"])
def test_shadow_lookups_take_nan_positions(kind, shared):
    """A state gone NaN reaches the frame's render before the watchdog
    resets it. A NaN world position indexes nothing out of range: the
    lookup gives 1.0 (lit) there, as the JAX package's clamped gathers do,
    and every other pixel is what it is without the NaNs, bit for bit."""
    maps, mvps, dists, wpos, vd, nrm, ldir = _pcf_inputs(shared)
    if kind == "vsm":
        maps = np.stack([maps, maps * maps], -1)
    bad = np.random.default_rng(3).random(wpos.shape[:-1]) < 0.1
    wnan = np.where(bad[..., None], np.float32(np.nan), wpos)

    def port(w):
        if kind == "vsm":
            return tshade.vsm_shadow(t(maps), t(mvps), t(dists), t(w),
                                     t(vd)).numpy()
        return tshade.pcf_shadow(t(maps), t(mvps), t(dists), t(w), t(vd),
                                 t(nrm), t(ldir)).numpy()

    def ref(e):
        m, mv = (maps, mvps) if shared else (maps[e], mvps[e])
        args = (jnp.asarray(m), jnp.asarray(mv), jnp.asarray(dists),
                jnp.asarray(wnan[e]), jnp.asarray(vd[e]))
        if kind == "vsm":
            return np.asarray(jshade.vsm_shadow(*args))
        return np.asarray(jshade.pcf_shadow(*args, jnp.asarray(nrm[e]),
                                            jnp.asarray(ldir)))

    got, clean = port(wnan), port(wpos)
    want = np.stack([ref(e) for e in range(B)])
    assert np.array_equal(got[bad], want[bad]) and (got[bad] == 1.0).all()
    assert np.array_equal(got[~bad], clean[~bad])


def test_apply_lut_takes_nan_colours():
    """apply_lut of a NaN colour indexes nothing out of range and gives NaN
    there, as the JAX package's does; the other pixels within 1e-6 of the
    JAX package's."""
    jv = jlut.bake_lut(jlut.LUT_PRESETS[1], 16)
    color = np.random.default_rng(5).uniform(
        -0.1, 1.1, (B, 32, 32, 3)).astype(np.float32)
    color[:, ::5, ::3, 1] = np.nan
    ref = np.asarray(jlut.apply_lut(jnp.asarray(color), jv))
    got = tlut.apply_lut(t(color), t(jv)).numpy()
    assert np.isnan(got[:, ::5, ::3]).all()
    np.testing.assert_allclose(got, ref, equal_nan=True, **TIGHT)


def test_material_fog_in_shade_pixels():
    """shade_pixels(fog_density=, shadow_tint=) on random pixels against
    the JAX package's, env by env, within 1e-6."""
    from clap_tpu.render.lights import lights_empty
    from test_torch_common import to_port

    rng = np.random.default_rng(9)
    H, W = 32, 64
    le = lights_empty(2)
    jl = le._replace(
        direction=le.direction.at[0].set(jnp.array([0.0, -1.0, 0.0])),
        pos=le.pos.at[1].set(jnp.array([1.0, 3.0, 0.5])),
        color=jnp.ones((2, 3)), is_dir=le.is_dir.at[0].set(True),
        active=jnp.ones(2, bool))
    wpos = rng.uniform(-4, 4, (B, H, W, 3)).astype(np.float32)
    nrm = rng.standard_normal((B, H, W, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    base = rng.uniform(size=(B, H, W, 3)).astype(np.float32)
    rough = rng.uniform(size=(B, H, W)).astype(np.float32)
    metal = rng.uniform(size=(B, H, W)).astype(np.float32)
    sf = rng.uniform(size=(B, H, W)).astype(np.float32)
    fd = rng.uniform(size=(B, H, W)).astype(np.float32)
    eye = np.array([[0.0, 5.0, 8.0], [1.0, 4.0, 7.0]], np.float32)
    tint = np.array([0.2, 0.3, 0.5], np.float32)
    mask = np.ones((B, 1, 2, 2), bool)
    ref = np.stack([np.asarray(jshade.shade_pixels(
        jnp.asarray(wpos[e]), jnp.asarray(nrm[e]), jnp.asarray(eye[e]),
        jshade.Material(jnp.asarray(base[e]), jnp.asarray(rough[e]),
                        jnp.asarray(metal[e]), jnp.zeros((H, W, 3))),
        jl, jnp.asarray(mask[e]), shadow_factor=jnp.asarray(sf[e]),
        shadow_tint=jnp.asarray(tint), fog_density=jnp.asarray(fd[e])))
        for e in range(B)])
    got = tshade.shade_pixels(
        t(wpos), t(nrm), t(eye),
        tshade.Material(t(base), t(rough), t(metal),
                        torch.zeros(B, H, W, 3)),
        to_port(jl), t(mask), shadow_factor=t(sf), shadow_tint=t(tint),
        fog_density=t(fd)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
