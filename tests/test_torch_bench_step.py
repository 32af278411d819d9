"""The port's ``bench_step_and_render`` against bench.py's own at 2 envs ×
64² on the CPU (the whole testbed of bench.py:544-625, skinned characters,
the 1,024² static bake, cluster records): the frames after the warm-up
step (``return_images=True``), each env >= 35 dB, the bar of
tests/test_torch_charskin.py. The textured config is
tests/test_torch_bench_textured.py."""
import numpy as np

from clap_tpu_torch import bench as port
from test_torch_common import jax_bench, psnr

PSNR_DB = 35.0


def frames_of_both(tmp_path, **kw):
    """Each env's PSNR of the port's frames against bench.py's (whose
    compile runs with XLA's backend optimisation off: ``jax_bench``)."""
    ref = jax_bench(tmp_path, "bench_step_and_render", fast_compile=True,
                    n_envs=2, res=64, return_images=True, **kw)
    got = port.bench_step_and_render(n_envs=2, res=64, return_images=True,
                                     device="cpu", **kw)
    ref = ref()
    assert got.shape == ref.shape == (2, 64, 64, 3)
    assert np.isfinite(got).all() and got.std() > 0.01
    return [psnr(ref[e], got[e]) for e in range(2)]


def test_step_and_render_frames_match_bench_py(tmp_path):
    assert min(frames_of_both(tmp_path)) >= PSNR_DB
