"""2x super-resolution CNN, loading the reference's weights.bin
(tracerboy_tpu/ml/superres.py).

The reference's DirectMLSuperResolution network
(TracerBoy/DirectMLSuperResolution.cpp:300-410): conv1 5x5 3->32, conv2
3x3 32->64, conv3 3x3 64->64, nearest 2x upsample, conv_up1 5x5 64->32,
conv4/conv5 3x3 32->32 (all ReLU-fused with folded BatchNorm
scale/shift), conv6 3x3 32->3 (linear), output = residual + nearest-2x
upsampled input. The weights.bin format (LoadWeights,
DirectMLSuperResolution.cpp:93-145) is: int32 count, then per tensor
{u32 name_len, name, u32 float_count, float32 data}.

Plain convolutions (cuDNN on the card), as the JAX package leaves them to
XLA. Numerics are the JAX function's: the input rounded to bfloat16, each
convolution of bf16 operands accumulated in float32 with the float32 bias
added before the one rounding to bf16, and the residual's base the
nearest 2x upsample of the bf16-rounded input. The port computes each
convolution in float32 on the bf16-rounded operands, whose products are
exact in float32.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tracerboy_tpu_torch.ml.oidn import upsample2x
from tracerboy_tpu_torch.scene.compile import REFERENCE_CHECKOUT

# The reference's trained network, where the JAX CLI reads it.
WEIGHTS_BIN = os.path.join(REFERENCE_CHECKOUT, "TracerBoy", "ML",
                           "weights.bin")

_LAYERS = (
    # (name, kernel, in, out, relu, upsample_before)
    ("conv1", 5, 3, 32, True, False),
    ("conv2", 3, 32, 64, True, False),
    ("conv3", 3, 64, 64, True, False),
    ("conv_up1/conv", 5, 64, 32, True, True),
    ("conv4", 3, 32, 32, True, False),
    ("conv5", 3, 32, 32, True, False),
    ("conv6", 3, 32, 3, False, False),
)


def _attr(name: str) -> str:
    """The module attribute of a weights.bin layer name."""
    return name.replace("/", "_")


def read_weights_bin(path: str) -> dict:
    """{tensor name: float32 array} of a weights.bin file."""
    with open(path, "rb") as f:
        data = f.read()
    (count,) = struct.unpack_from("<i", data, 0)
    pos = 4
    out = {}
    for _ in range(count):
        (name_len,) = struct.unpack_from("<I", data, pos)
        pos += 4
        name = data[pos: pos + name_len].decode("ascii")
        pos += name_len
        (w_len,) = struct.unpack_from("<I", data, pos)
        pos += 4
        out[name] = np.frombuffer(data, "<f4", w_len, offset=pos).copy()
        pos += 4 * w_len
    return out


class SuperResNet(nn.Module):
    """The super-resolution CNN with OIHW weights; forward = upscale2x."""

    def __init__(self):
        super().__init__()
        for name, k, cin, cout, _relu, _up in _LAYERS:
            self.add_module(_attr(name),
                            nn.Conv2d(cin, cout, k, padding=k // 2))

    def forward(self, image):
        """2x super-resolve an (H, W, 3) image in [0, 1] -> (2H, 2W, 3)
        float32 in [0, 1]."""
        x = image.permute(2, 0, 1)[None].to(torch.bfloat16)
        y = x
        for name, k, _cin, _cout, relu, upsample_before in _LAYERS:
            if upsample_before:
                y = upsample2x(y)
            layer = getattr(self, _attr(name))
            w = layer.weight.to(torch.bfloat16).to(torch.float32)
            y = F.conv2d(y.to(torch.float32), w, padding=k // 2)
            y = (y + layer.bias[:, None, None]).to(torch.bfloat16)
            if relu:
                y = F.relu(y)
        residual = y.to(torch.float32)[0]
        base = upsample2x(x.to(torch.float32))[0]
        return torch.clamp(base + residual, 0.0, 1.0).permute(1, 2, 0)


def state_dict_from_superres(params: dict) -> dict:
    """SuperResNet's state_dict from the JAX package's superres params
    ({layer name: (HWIO kernel, bias)}, numpy or any array np.asarray
    reads): HWIO -> OIHW, the folded bias as it is."""
    sd = {}
    for name, (w, b) in params.items():
        w = np.asarray(w, np.float32)
        sd[f"{_attr(name)}.weight"] = torch.from_numpy(
            np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
        sd[f"{_attr(name)}.bias"] = torch.from_numpy(
            np.asarray(b, np.float32).copy())
    return sd


def load_superres(path: str) -> SuperResNet:
    """The network of a weights.bin file on the CPU, folded as the JAX
    load_superres folds it: BatchNorm's scale into the HWIO kernel, its
    shift the bias, zeros without BatchNorm."""
    raw = read_weights_bin(path)
    params = {}
    for name, k, cin, cout, _relu, _up in _LAYERS:
        w = raw[f"{name}/weights"].reshape(k, k, cin, cout)  # TF HWIO
        scale = raw.get(f"{name}/BatchNorm/scale")
        shift = raw.get(f"{name}/BatchNorm/shift")
        if scale is not None:
            w = w * scale[None, None, None, :]
            b = shift
        else:
            b = np.zeros(cout, np.float32)
        params[name] = (w, b)
    net = SuperResNet()
    net.load_state_dict(state_dict_from_superres(params))
    return net.eval()


def upscale2x(net: SuperResNet, image):
    """2x super-resolve an (H, W, 3) image in [0, 1] on the network's
    device (no autograd)."""
    with torch.inference_mode():
        return net(image.to(net.conv1.weight.device, torch.float32))
