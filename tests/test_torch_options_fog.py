"""``render_frame`` with the fog options on, the port against the JAX
package on tests/test_torch_options_frame.py's scene (2 views × 64² of the
``batched_render`` terrain, fog from 5 to 40 m), with its bars (finite,
full-size, differs from the default frame, LDR PSNR >= 35 dB per view):
``fog_noise`` (the fog tint darkened by the analytic noise field at the
view position; its change is small by design, over 1e-5) and
``material_fog`` (per-pixel density from ``fog_cloud`` at the world
position, in ``shade_pixels``)."""
import pytest

from test_torch_options_frame import check_option, port_default, render_pair
from test_torch_options_frame import scene  # noqa: F401  (fixture)


@pytest.fixture(scope="module")
def default(scene):  # noqa: F811
    return port_default(scene)


def test_fog_noise(scene, default):  # noqa: F811
    ref, got = render_pair(scene, dict(fog_noise=True))
    check_option(ref, got, default, min_change=1e-5)


def test_material_fog(scene, default):  # noqa: F811
    ref, got = render_pair(scene, dict(material_fog=True))
    check_option(ref, got, default)
