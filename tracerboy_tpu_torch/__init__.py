"""tracerboy_tpu_torch: the PyTorch/CUDA port of tracerboy_tpu.

A wavefront path tracer in plain PyTorch around hand-written CUDA
kernels for Hopper (csrc/), held against the JAX package module by
module. It imports torch and numpy, never jax or tracerboy_tpu.

    from tracerboy_tpu_torch import Renderer
    r = Renderer("shadertoy", film_size=(1280, 720), device="cuda")
    r.render_sample(1); r.render_sample(8); img = r.current_image()
"""

import torch

# Full float32 everywhere: no TF32 matrix products or convolutions.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from tracerboy_tpu_torch.renderer import (  # noqa: E402,F401
    Renderer,
    RenderState,
)
from tracerboy_tpu_torch.utils.config import (  # noqa: E402,F401
    CameraSettings,
    DebugSettings,
    DenoiserSettings,
    FilterType,
    OutputSettings,
    OutputType,
    PerformanceSettings,
    PostProcessSettings,
    RenderMode,
    TonemapType,
    default_output_settings,
)
