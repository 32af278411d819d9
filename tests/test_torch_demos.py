"""The flythrough demo on the port against the JAX package's:
``python -m clap_tpu_torch.demo.flythrough`` and demo/flythrough.py, each
run through its own command line at 256 × 128 with ``--frames 2
--sim-frames 3`` (the JAX package cannot raster the demo's default 640
wide: its sub-column grid fails there, ROADMAP §3, recorded by
``test_reference_flythrough_fails_at_640``). Bars: each frame's PNG
within PSNR >= 35 dB of the reference's, as the other frame parity
tests; every frame finite with std > 0.01; the orbiting camera changes
the picture.

The platformer demo's parity test shares the JAX package's level57
compile and lives in test_torch_level57.py."""
import sys
from pathlib import Path

import numpy as np
import pytest

from clap_tpu_torch.demo import flythrough as F
from clap_tpu_torch.utils.png import decode_png
from test_torch_common import psnr

DEMO = Path(__file__).resolve().parents[1] / "demo"
ARGS = ["--frames", "2", "--sim-frames", "3"]


def reference_main(argv, monkeypatch):
    """demo/flythrough.py's main() with ``argv`` as its command line."""
    sys.path.insert(0, str(DEMO))
    try:
        import flythrough as ref
    finally:
        sys.path.remove(str(DEMO))
    monkeypatch.setattr(sys, "argv", ["flythrough.py", *argv])
    ref.main()


@pytest.fixture(scope="module")
def flights(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        jdir, tdir = (tmp_path_factory.mktemp(n) for n in ("jax", "port"))
        size = ["--width", "256", "--height", "128"]
        reference_main([*ARGS, *size, "--out", str(jdir)], mp)
        _, imgs = F.main([*ARGS, *size, "--out", str(tdir), "--device",
                          "cpu"])
    finally:
        mp.undo()
    return jdir, tdir, imgs


@pytest.mark.parametrize("frame", range(2))
def test_flythrough_frame(flights, frame):
    jdir, tdir, imgs = flights
    name = f"frame_{frame:03d}.png"
    ref = decode_png((jdir / name).read_bytes())[..., :3]
    got = decode_png((tdir / name).read_bytes())[..., :3]
    img = imgs[frame].numpy()
    assert img.shape == (128, 256, 3) and np.isfinite(img).all()
    assert float(img.std()) > 0.01
    assert got.shape == ref.shape
    assert psnr(ref / 255.0, got / 255.0) >= 35.0
    np.testing.assert_array_equal(
        got, np.clip(np.rint(img * 255), 0, 255).astype(np.uint8))


def test_flythrough_camera_orbits(flights):
    imgs = flights[2]
    assert float((imgs[0] - imgs[1]).abs().max()) > 0.05


def test_reference_flythrough_fails_at_640(monkeypatch, tmp_path):
    """The JAX demo at its own default size: cdiv(640, 128) = 5 ≠
    2·cdiv(640, 256) = 6, and its raster fails to trace (ROADMAP §3)."""
    with pytest.raises(TypeError, match="reshape"):
        reference_main(["--frames", "1", "--sim-frames", "1", "--out",
                        str(tmp_path)], monkeypatch)
