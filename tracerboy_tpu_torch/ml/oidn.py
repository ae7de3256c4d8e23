"""The OIDN `rt` UNet denoiser as a torch module (tracerboy_tpu/ml/oidn.py).

The topology of the reference's DirectML port of Open Image Denoise
(TracerBoy/OpenImageDenoise.cpp:855-1000): 16 convolutions of 3x3 with
ReLU, four 2x2 max pools, four nearest 2x upsamples and four channel
concatenations, in the order of the JAX package's OIDNUNet. Plain
convolutions (cuDNN on the card): the JAX package leaves them to XLA, so
no hand-written kernel replaces them.

Layouts: the module takes and returns NHWC, as the Flax module does; its
state_dict holds OIHW weights named as in the .tza archives
("enc_conv0.weight", "enc_conv0.bias", ...). dtype: like the JAX module,
bfloat16 activations and weights cast from float32 parameters by
default, float32 on request. TF32 stays off (the package's __init__).

Inputs: colour (+ albedo + normal for the _alb_nrm variant), HWC in
[0, 1] after the transfer; denoise_image pads H and W reflectively to
multiples of 16 and crops back.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

ALIGNMENT = 16
# (name, output channels) in the order of oidn.py:50-75.
ENCODER = (("enc_conv0", 32), ("enc_conv1", 32), ("enc_conv2", 48),
           ("enc_conv3", 64), ("enc_conv4", 80), ("enc_conv5a", 96),
           ("enc_conv5b", 96))
DECODER = (("dec_conv4a", 112), ("dec_conv4b", 112), ("dec_conv3a", 96),
           ("dec_conv3b", 96), ("dec_conv2a", 64), ("dec_conv2b", 64),
           ("dec_conv1a", 64), ("dec_conv1b", 32), ("dec_conv0", 3))


def upsample2x(y):
    """Nearest 2x upsample of (B, C, H, W): output row (column) j reads
    input row (column) j // 2, as jax.image.resize(..., "nearest") does at
    exactly 2x."""
    return y.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class OIDNUNet(nn.Module):
    """The OIDN `rt` UNet graph; forward: (B, H, W, C) -> (B, H, W, 3)
    float32, H and W multiples of 16."""

    def __init__(self, in_channels: int = 9, dtype=torch.bfloat16):
        super().__init__()
        self.in_channels = in_channels
        self.dtype = dtype
        # Input channels of each convolution: the previous output, or the
        # concatenation of an upsample with its skip (96 + 64, 112 + 48,
        # 96 + 32, 64 + in_channels).
        cin = dict(enc_conv0=in_channels, enc_conv1=32, enc_conv2=32,
                   enc_conv3=48, enc_conv4=64, enc_conv5a=80,
                   enc_conv5b=96, dec_conv4a=96 + 64, dec_conv4b=112,
                   dec_conv3a=112 + 48, dec_conv3b=96, dec_conv2a=96 + 32,
                   dec_conv2b=64, dec_conv1a=64 + in_channels,
                   dec_conv1b=64, dec_conv0=32)
        for name, cout in ENCODER + DECODER:
            self.add_module(name, nn.Conv2d(cin[name], cout, 3, padding=1))

    def _conv(self, name, x, relu=True):
        layer = getattr(self, name)
        y = F.conv2d(x, layer.weight.to(self.dtype),
                     layer.bias.to(self.dtype), padding=1)
        return F.relu(y) if relu else y

    def forward(self, x):
        def pool(y):
            return F.max_pool2d(y, 2)

        up = upsample2x
        inp = x.permute(0, 3, 1, 2).to(self.dtype)
        x0 = self._conv("enc_conv0", inp)
        p1 = pool(self._conv("enc_conv1", x0))
        p2 = pool(self._conv("enc_conv2", p1))
        p3 = pool(self._conv("enc_conv3", p2))
        p4 = pool(self._conv("enc_conv4", p3))
        x5 = self._conv("enc_conv5b", self._conv("enc_conv5a", p4))
        d4 = self._conv("dec_conv4a", torch.cat([up(x5), p3], 1))
        d4 = self._conv("dec_conv4b", d4)
        d3 = self._conv("dec_conv3a", torch.cat([up(d4), p2], 1))
        d3 = self._conv("dec_conv3b", d3)
        d2 = self._conv("dec_conv2a", torch.cat([up(d3), p1], 1))
        d2 = self._conv("dec_conv2b", d2)
        d1 = self._conv("dec_conv1a", torch.cat([up(d2), inp], 1))
        d1 = self._conv("dec_conv1b", d1)
        out = self._conv("dec_conv0", d1, relu=False)
        return out.permute(0, 2, 3, 1).to(torch.float32)


def params_from_tza(tza: dict) -> dict:
    """The module's state_dict from read_tza's {name: (array, layout)}:
    the archive's OIHW weights and biases as they are."""
    sd = {}
    for key, (arr, layout) in tza.items():
        if key.endswith(".weight") and layout != "oihw":
            raise ValueError(f"{key}: layout {layout!r}, expected 'oihw'")
        sd[key] = torch.from_numpy(np.asarray(arr, np.float32))
    return sd


def state_dict_from_flax(variables: dict) -> dict:
    """The module's state_dict from Flax UNet variables ({"params": {name:
    {"kernel": HWIO, "bias"}}}, numpy or any array np.asarray reads):
    the JAX package's weights carried into the port."""
    sd = {}
    for name, p in variables["params"].items():
        kernel = np.asarray(p["kernel"], np.float32)
        sd[f"{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
        sd[f"{name}.bias"] = torch.from_numpy(
            np.asarray(p["bias"], np.float32).copy())
    return sd


def unet_from_state_dict(sd: dict, dtype=torch.bfloat16) -> OIDNUNet:
    """An eval-mode OIDNUNet with these weights; the input channel count
    comes from enc_conv0."""
    model = OIDNUNet(in_channels=sd["enc_conv0.weight"].shape[1],
                     dtype=dtype)
    model.load_state_dict(sd)
    return model.eval()


def load_oidn(path: str, dtype=torch.bfloat16) -> OIDNUNet:
    """The UNet of a .tza weight archive, on the CPU."""
    from tracerboy_tpu_torch.ml.tza import read_tza

    return unet_from_state_dict(params_from_tza(read_tza(path)), dtype)


def denoise_image(model: OIDNUNet, color, albedo=None, normal=None):
    """Denoise an (H, W, 3) LDR colour tensor (+ optional aux features)
    on the model's device; pads H and W reflectively up to multiples of
    16, crops the result and clamps it at 0."""
    dev = model.enc_conv0.weight.device
    feats = [color]
    if model.in_channels >= 9:
        feats.append(albedo if albedo is not None else torch.zeros_like(color))
        feats.append(normal if normal is not None else torch.zeros_like(color))
    x = torch.cat([f.to(dev, torch.float32) for f in feats], dim=-1)
    H, W = x.shape[:2]
    x = F.pad(x.permute(2, 0, 1)[None],
              (0, (-W) % ALIGNMENT, 0, (-H) % ALIGNMENT), mode="reflect")
    with torch.inference_mode():
        out = model(x.permute(0, 2, 3, 1))[0]
    return torch.clamp_min(out[:H, :W], 0.0)
