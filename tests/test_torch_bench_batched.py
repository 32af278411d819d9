"""The port's bench against bench.py's own ``bench_batched_render`` (2
views × 64² of the shared terrain) on the CPU: ``kernel_attrs`` exact, and
``img_std`` within 1e-3 relative (float32 frames through different
summation orders)."""
import pytest

from clap_tpu_torch import bench as port
from test_torch_common import jax_bench

IMG_STD_RTOL = 1e-3


def test_batched_render_matches_bench_py(tmp_path):
    ref = jax_bench(tmp_path, "bench_batched_render", n_envs=2, res=64)
    got = port.bench_batched_render(n_envs=2, res=64, device="cpu")
    ref = ref()
    assert got["metric"] == ref["metric"] == "batched_render_2x64_ms"
    assert got["kernel_attrs"] == ref["kernel_attrs"] is True
    assert got["img_std"] == pytest.approx(ref["img_std"], rel=IMG_STD_RTOL)
    assert got["img_std"] > 0.01
