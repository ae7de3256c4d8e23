"""The inference half of tracerboy_tpu/ml/finetune.py: the fine-tuned
UNet's weight file and the transfer it was trained with. Training is not
ported yet (ROADMAP.md, Queue 1 item 19).
"""

from __future__ import annotations

import numpy as np
import torch

from tracerboy_tpu_torch.ml.oidn import (
    state_dict_from_flax,
    unet_from_state_dict,
)


def reinhard_fwd(x):
    """Linear HDR -> the invertible display-referred net space."""
    x = torch.clamp_min(x.to(torch.float32), 0.0)
    return (x / (1.0 + x)) ** (1 / 2.2)


def reinhard_inv(y):
    y = torch.clamp(y.to(torch.float32), 0.0, 0.995) ** 2.2
    return y / (1.0 - y)


def load_params_npz(path: str, dtype=torch.bfloat16):
    """The UNet of a flat float16 .npz of Flax conv params ("name.kernel"
    HWIO, "name.bias"; the JAX package's save_params_npz), on the CPU."""
    params: dict = {}
    with np.load(path) as d:
        for key in d.files:
            name, kind = key.rsplit(".", 1)
            params.setdefault(name, {})[kind] = d[key].astype(np.float32)
    return unet_from_state_dict(state_dict_from_flax({"params": params}),
                                dtype)
