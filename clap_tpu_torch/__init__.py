"""clap-tpu's PyTorch/CUDA port: batched simulation and the composed
step-and-render frame on one NVIDIA H100.

Counterpart of the JAX package ``clap_tpu`` (the reference); module and
function names follow it, with an explicit leading env axis on every
per-env tensor. The two tile-raster kernels are hand-written CUDA
(csrc/raster.cu); everything else is plain batched torch. This package
never imports JAX.

    from clap_tpu_torch.scene.testbed import build_testbed, replicate_state
    from clap_tpu_torch.engine.step import engine_step, inputs_zero
    from clap_tpu_torch.engine.frame import SceneRenderer, step_and_render
"""

__version__ = "0.1.0"

from . import mathx  # noqa: F401
