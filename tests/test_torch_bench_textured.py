"""The port's ``bench_step_and_render(textured=True)`` (the
``step_and_render_textured`` config: textured characters and trees, the
member-granularity assembly and the per-pixel gather) against bench.py's
own at 2 envs × 64² on the CPU: each env >= 35 dB."""
from test_torch_bench_step import PSNR_DB, frames_of_both


def test_textured_frames_match_bench_py(tmp_path):
    assert min(frames_of_both(tmp_path, textured=True)) >= PSNR_DB
