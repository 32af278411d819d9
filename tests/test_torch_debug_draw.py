"""The debug-draw overlay of the port against the JAX package: the line
buffer helpers (exact), and ``draw_lines`` exact wherever no masked sample
of the reference lands on a lit pixel (every slot used, every line on
screen and in front of the camera).

The reference writes a masked sample's pixel back with the frame's own
value, so an unused slot (a = b = 0, all its samples on the pixel where the
origin projects) erases a line that an earlier slot drew there; the port
writes valid samples only (``test_reference_erases_through_unused_slots``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clap_tpu import mathx as jmx
from clap_tpu.render import debug_draw as J
from clap_tpu_torch.render import debug_draw as T
import test_torch_common  # noqa: F401  (one torch thread per worker)


def camera(eye=(0.0, 0.0, 3.0), aspect=1.0):
    """The reference's test camera (tests/test_io_misc.py) as numpy."""
    view = jmx.mat4_look_at(jnp.asarray(eye, jnp.float32), jnp.zeros(3),
                            jnp.array([0.0, 1.0, 0.0]))
    proj = jmx.mat4_perspective(jnp.pi / 3, aspect, 0.1, 10.0)
    return np.array(view), np.array(proj)


def both(build):
    """``build(module, idx)`` on each package's empty buffer: the two
    buffers (the port's as numpy) and the two final indices."""
    out = []
    for mod, empty in ((J, J.lines_empty), (T, T.lines_empty)):
        dl, idx = build(mod, empty)
        out.append((tuple(np.asarray(x) if not isinstance(x, torch.Tensor)
                          else x.numpy() for x in dl), idx))
    return out


def overlay(mod, empty):
    dl = empty(16) if mod is J else empty(16, device="cpu")
    idx = 0
    dl, idx = mod.add_line(dl, idx, [-1, 0, 0], [1, 0, 0], (1, 0, 0))
    dl, idx = mod.add_aabb(dl, idx, [-0.5, -0.5, -0.5], [0.5, 0.5, 0.5])
    dl, idx = mod.add_cross(dl, idx, [0.1, 0.2, 0.3])
    return dl, idx


def random_lines(seed, n):
    def build(mod, empty):
        rng = np.random.default_rng(seed)
        dl = empty(n) if mod is J else empty(n, device="cpu")
        idx = 0
        while idx < n:
            kind = rng.integers(3) if n - idx >= 12 else 0
            col = tuple(float(c) for c in rng.uniform(0.1, 1.0, 3))
            if kind == 0:
                a, b = rng.uniform(-0.9, 0.9, (2, 3)).astype(np.float32)
                dl, idx = mod.add_line(dl, idx, a, b, col)
            elif kind == 1:
                c = rng.uniform(-0.4, 0.4, 3).astype(np.float32)
                dl, idx = mod.add_aabb(dl, idx, c - 0.3, c + 0.3, col)
            elif n - idx >= 3:
                p = rng.uniform(-0.6, 0.6, 3).astype(np.float32)
                dl, idx = mod.add_cross(dl, idx, p, 0.2, col)
        return dl, idx
    return build


@pytest.mark.parametrize("build", [overlay, random_lines(0, 24),
                                   random_lines(1, 40)],
                         ids=["overlay", "random24", "random40"])
def test_line_buffers_equal(build):
    (jb, ji), (tb, ti) = both(build)
    assert ji == ti
    for a, b in zip(jb, tb):
        np.testing.assert_array_equal(b, a)


def _draw_both(build, size, seed, eye=(0.0, 0.0, 3.0)):
    W, H = size
    (jb, _), (tb, _) = both(build)
    view, proj = camera(eye, W / H)
    frame = np.random.default_rng(seed).uniform(0, 0.5, (H, W, 3)).astype(
        np.float32)
    ref = np.asarray(J.draw_lines(jnp.asarray(frame),
                                  J.DebugLines(*map(jnp.asarray, jb)),
                                  jnp.asarray(view), jnp.asarray(proj)))
    got = T.draw_lines(torch.from_numpy(frame),
                       T.DebugLines(*map(torch.from_numpy, tb)),
                       torch.from_numpy(view), torch.from_numpy(proj))
    return frame, ref, got.numpy()


@pytest.mark.parametrize("size", [(64, 64), (96, 64), (160, 90)])
@pytest.mark.parametrize("build", [overlay, random_lines(0, 24),
                                   random_lines(1, 40)],
                         ids=["overlay", "random24", "random40"])
def test_draw_lines_equal(build, size):
    """Every slot used and every sample on screen: the port's frame is the
    reference's, bit for bit."""
    frame, ref, got = _draw_both(build, size, seed=size[0])
    np.testing.assert_array_equal(got, ref)
    assert (np.abs(ref - frame).max(-1) > 0).sum() > 30


def test_draw_lines_no_sample_lands_off_screen():
    """The scenes above keep every sample on screen (the condition under
    which the reference's masked samples cannot erase)."""
    for build in (overlay, random_lines(0, 24), random_lines(1, 40)):
        (jb, _), _ = both(build)
        view, proj = camera()
        a = np.concatenate([jb[0], np.ones((len(jb[0]), 1), np.float32)], 1)
        b = np.concatenate([jb[1], np.ones((len(jb[1]), 1), np.float32)], 1)
        for p in (a, b):
            c = p @ (proj @ view).T
            assert (c[:, 3] > 1e-4).all()
            ndc = c[:, :2] / c[:, 3:4]
            assert (np.abs(ndc) < 1.0).all()


@pytest.mark.parametrize("slot", [0, 7])
def test_reference_erases_through_unused_slots(slot):
    """A red line through the world origin in one slot of an 8-slot buffer
    (64² frame, the origin at pixel (32, 32)): in slot 0 the reference
    leaves that pixel black, because slots 1-7 are unused and their
    masked samples, all on that pixel, write the frame's value back after
    it; in slot 7 it lights it. The port lights it in both, and every
    other pixel as the reference does."""
    def build(mod, empty):
        dl = empty(8) if mod is J else empty(8, device="cpu")
        return mod.add_line(dl, slot, [-1, 0, 0], [1, 0, 0], (1, 0, 0))

    (jb, _), (tb, _) = both(build)
    view, proj = camera()
    frame = np.zeros((64, 64, 3), np.float32)
    ref = np.asarray(J.draw_lines(jnp.asarray(frame),
                                  J.DebugLines(*map(jnp.asarray, jb)),
                                  jnp.asarray(view), jnp.asarray(proj)))
    got = T.draw_lines(torch.from_numpy(frame),
                       T.DebugLines(*map(torch.from_numpy, tb)),
                       torch.from_numpy(view), torch.from_numpy(proj)).numpy()
    lit_ref = ref[..., 0] > 0
    lit = got[..., 0] > 0
    assert lit[32, 32]
    assert lit_ref[32, 32] == (slot == 7)
    assert lit.sum() == lit_ref.sum() + (slot == 0)
    lit_ref[32, 32] = True
    np.testing.assert_array_equal(lit, lit_ref)


def test_draw_lines_leaves_its_inputs():
    frame = torch.rand(32, 48, 3, generator=torch.Generator().manual_seed(3))
    keep = frame.clone()
    empty = T.lines_empty(12, device="cpu")
    dl, _ = T.add_aabb(empty, 0, [-0.5] * 3, [0.5] * 3)
    view, proj = camera(aspect=48 / 32)
    out = T.draw_lines(frame, dl, torch.from_numpy(view),
                       torch.from_numpy(proj))
    assert torch.equal(frame, keep) and not torch.equal(out, frame)
    assert not empty.valid.any()        # add_aabb made a new buffer
