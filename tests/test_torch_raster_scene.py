"""``raster_scene`` (clap_tpu/render/raster.py:1291-1297: project, assemble
records, bin, K1's walk) of the port against the JAX package (Pallas in
interpret mode) on tests/test_raster.py's scenes: one triangle, two at
different depths, a back face, a full-screen triangle past the span cap
at 1,280 × 128, a perspective-correct edge-on quad, and 40 random
triangles in clip space. The port's verts (V, 4) give an (H, W) G-buffer
as the JAX package's do, and a batch (B, V, 4) gives (B, H, W).

Triangle ids exact; depth within 1e-5 and barycentrics within 1e-4 where
the pixel is covered (float32 interpolation order)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clap_tpu.render.raster import raster_scene as jraster_scene
from clap_tpu_torch.render.raster import raster_scene
from test_raster import screen_tri


def _random(seed=3, T=40):
    rng = np.random.default_rng(seed)
    ctr = rng.uniform(-1.0, 1.0, (T, 1, 2))
    ctr = ctr[np.lexsort((ctr[:, 0, 0], ctr[:, 0, 1]))]
    pts = (ctr + rng.uniform(-0.35, 0.35, (T, 3, 2))).astype(np.float32)
    z = rng.uniform(-0.9, 0.9, (T, 1)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, (T, 1)).astype(np.float32)
    clip = np.concatenate([
        pts * w[..., None],
        np.broadcast_to(z[..., None] * w[..., None], (T, 3, 1)),
        np.broadcast_to(w[..., None], (T, 3, 1))], axis=-1).reshape(T * 3, 4)
    faces = np.arange(T * 3, dtype=np.int32).reshape(T, 3)
    # both windings, so about half the triangles face the camera
    faces[1::2] = faces[1::2, [0, 2, 1]]
    return clip, faces, 256, 64


SCENES = {
    "single": lambda: (np.array(screen_tri([[10, 2], [10, 25], [50, 2]])),
                       np.array([[0, 1, 2]], np.int32), 128, 32),
    "depth_order": lambda: (np.concatenate([
        np.array(screen_tri([[0, 0], [0, 32], [128, 0]], z=0.5)),
        np.array(screen_tri([[0, 0], [0, 32], [128, 0]], z=-0.5))]),
        np.array([[0, 1, 2], [3, 4, 5]], np.int32), 128, 32),
    "backface": lambda: (np.array(screen_tri([[10, 2], [50, 2], [10, 25]])),
                         np.array([[0, 1, 2]], np.int32), 128, 32),
    "big_triangle": lambda: (np.array(screen_tri(
        [[0, 0], [0, 128], [1280, 0]], 1280, 128, z=0.2)),
        np.array([[0, 1, 2]], np.int32), 1280, 128),
    "perspective": lambda: (np.array([
        [-0.5, -0.5, 0.0, 1.0], [2.0, -2.0, 0.0, 4.0],
        [-0.5, 0.5, 0.0, 1.0]], np.float32),
        np.array([[0, 1, 2]], np.int32), 64, 64),
    "random": _random,
}


def _check(ref, got):
    rid, gid = np.asarray(ref.tri_id), got.tri_id.numpy()
    np.testing.assert_array_equal(gid, rid)
    cov = rid >= 0
    np.testing.assert_allclose(got.depth.numpy()[cov],
                               np.asarray(ref.depth)[cov], atol=1e-5)
    assert np.isinf(got.depth.numpy()[~cov]).all()
    np.testing.assert_allclose(got.bary.numpy()[cov],
                               np.asarray(ref.bary)[cov], atol=1e-4)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_raster_scene(name):
    clip, faces, w, h = SCENES[name]()
    ref = jraster_scene(jnp.asarray(clip), jnp.asarray(faces), w, h)
    got = raster_scene(torch.as_tensor(clip), torch.as_tensor(faces), w, h)
    assert got.tri_id.shape == (h, w)
    _check(ref, got)
    if name != "backface":
        assert (got.tri_id >= 0).any()


def test_raster_scene_batch_and_face_valid():
    """A batch of two views (the second one's verts shifted) with a
    per-face validity mask: each env equals its own single-view call."""
    clip, faces, w, h = _random()
    clip2 = clip + np.array([0.2, -0.1, 0.0, 0.0], np.float32)
    valid = np.arange(len(faces)) % 3 != 0
    batch = raster_scene(torch.as_tensor(np.stack([clip, clip2])),
                         torch.as_tensor(faces), w, h,
                         face_valid=torch.as_tensor(valid))
    assert batch.tri_id.shape == (2, h, w)
    for b, c in enumerate((clip, clip2)):
        one = raster_scene(torch.as_tensor(c), torch.as_tensor(faces), w, h,
                           face_valid=torch.as_tensor(valid))
        for x, y in zip(batch, one):
            assert torch.equal(x[b], y)
        ref = jraster_scene(jnp.asarray(c), jnp.asarray(faces), w, h,
                            face_valid=jnp.asarray(valid))
        _check(ref, one)
