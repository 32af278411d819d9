"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test here is marked ``cuda`` and skips without a CUDA
device.

This file imports no JAX (the card's machine has none), and
tests/conftest.py does, so on the card run it without the conftest:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Bar, as for the reference's own kernel check: tid agreement >= 99.5 % and
depth within 1e-4 where ids agree (K2: the same finite pixels, depth
within 1e-4). The kernels are bit-exact against the plain versions in
practice."""
import math

import numpy as np
import pytest
import torch

from clap_tpu_torch import mathx as mx
from clap_tpu_torch.render import raster as R
from clap_tpu_torch.scene.terrain import terrain_init_square_landscape


@pytest.fixture
def cuda_device():
    """The first CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "tests/test_torch_cuda.py -m cuda --noconftest)")
    return torch.device("cuda", 0)


def _scene_records(W, H, dev):
    """The kernel_parity_check terrain (bench.py:780-803) as records."""
    t = terrain_init_square_landscape(5, -8.0, 0.0, -8.0, 16.0, 24)
    verts = torch.as_tensor(t.vx, device=dev)
    faces = torch.as_tensor(t.idx.reshape(-1, 3).astype(np.int32),
                            device=dev)
    view = mx.mat4_look_at(torch.tensor([6.0, 6.0, 6.0], device=dev),
                           torch.zeros(3, device=dev),
                           torch.tensor([0.0, 1.0, 0.0], device=dev))
    proj = mx.mat4_perspective(math.pi / 3, W / H, 0.1, 50.0, device=dev)
    clip = torch.cat([verts, torch.ones_like(verts[:, :1])], -1) \
        @ (proj @ view).T
    return R.assemble_tri_records(
        *R.project_to_screen(clip[None], W, H), faces,
        torch.ones((1, faces.shape[0]), dtype=torch.bool, device=dev))


@pytest.mark.cuda
def test_kernel_build_on_card(cuda_device):
    from clap_tpu_torch import cuda_build

    lib = cuda_build.load_raster_lib()
    assert lib.raster_tile_launch and lib.raster_depth_launch


@pytest.mark.cuda
@pytest.mark.parametrize("W,H,chunk", [(128, 128, 32), (256, 128, 8),
                                       (256, 128, 32)])
@pytest.mark.parametrize("depth_only", [False, True])
def test_kernel_matches_plain_version_on_card(cuda_device, depth_only, W, H,
                                              chunk):
    rec, ok = _scene_records(W, H, cuda_device)
    args = R.kernel_inputs(rec, R.bin_triangles(rec, ok, W, H), W, H,
                           chunk=chunk, depth_only=depth_only)
    kernel, plain = (R.raster_depth, R.raster_depth_ref) if depth_only \
        else (R.raster_tile, R.raster_tile_ref)
    before = kernel.launches
    k = kernel(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    r = plain(*args)
    if depth_only:
        fin = torch.isfinite(r)
        assert torch.equal(torch.isfinite(k), fin)
        assert fin.any()
        assert float((k - r).abs()[fin].max()) <= 1e-4
    else:
        same = k[1] == r[1]
        assert float(same.float().mean()) >= 0.995
        hit = same & (r[1] >= 0)
        assert hit.any()
        assert float((k[0] - r[0]).abs()[hit].max()) <= 1e-4


@pytest.mark.cuda
def test_kernel_rejects_cpu_inputs_mixed_with_cuda(cuda_device):
    """A CUDA launch takes CUDA tensors only; it never falls back."""
    rec, ok = _scene_records(128, 128, cuda_device)
    args = list(R.kernel_inputs(rec, R.bin_triangles(rec, ok, 128, 128),
                                128, 128))
    args[0] = args[0].cpu()
    with pytest.raises(ValueError):
        R.raster_tile(*args)
