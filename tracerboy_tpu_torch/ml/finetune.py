"""Scene-adapted fine-tuning of the OIDN UNet on this renderer's noise
(tracerboy_tpu/ml/finetune.py): the transfer the fine-tuned weights were
trained with, the orbit-view dataset of (noisy input, noisier target)
render pairs, the training loop and the weight files.

Method (noise2noise): inputs are low-spp renders, targets independent
higher-spp renders of the same view; under an L2 loss the minimizer is
the clean conditional mean, so the target noise costs variance, not bias.
Views orbit the starting camera without including it.

The dataset's renders go through the port's Renderer, so on the card
through the closest-hit and any-hit kernels. Training runs the UNet under
autograd with torch.optim.Adam at optax's defaults and optax's cosine
decay schedule, on the device given (the card by default): float32
parameters, compute in the model's dtype (bfloat16 by default), as the
Flax module's param_dtype and dtype. The batch and flip draws are the JAX
loop's, from the same numpy generator in the same order, and the files
(.npz datasets, float16 Flax-layout weights) are the JAX package's: each
package reads the other's.
"""

from __future__ import annotations

import copy
import math
import os

import numpy as np
import torch

from tracerboy_tpu_torch.ml.oidn import (
    OIDNUNet,
    load_oidn,
    state_dict_from_flax,
    unet_from_state_dict,
)
from tracerboy_tpu_torch.scene.compile import REFERENCE_CHECKOUT

# The reference's rt_ldr weights, where the JAX package reads them.
RT_LDR_TZA = os.path.join(REFERENCE_CHECKOUT, "TracerBoy", "ML",
                          "rt_ldr.tza")


def reinhard_fwd(x):
    """Linear HDR -> the invertible display-referred net space."""
    x = torch.clamp_min(x.to(torch.float32), 0.0)
    return (x / (1.0 + x)) ** (1 / 2.2)


def reinhard_inv(y):
    y = torch.clamp(y.to(torch.float32), 0.0, 0.995) ** 2.2
    return y / (1.0 - y)


# ---------------------------------------------------------------------------
# Dataset: orbit-view render pairs
# ---------------------------------------------------------------------------


def orbit_offsets(n: int, diag: float, rng: np.random.Generator):
    """n small camera perturbations (move_camera kwargs) around the
    current view: yaw/pitch up to ~6 deg, translate up to ~1.5% of the
    scene diagonal."""
    views = []
    for _ in range(n):
        views.append(dict(
            yaw=float(rng.uniform(-0.10, 0.10)),
            pitch=float(rng.uniform(-0.06, 0.06)),
            forward=float(rng.uniform(-1.0, 1.0)) * 0.015 * diag,
            strafe=float(rng.uniform(-1.0, 1.0)) * 0.015 * diag,
            upward=float(rng.uniform(-1.0, 1.0)) * 0.008 * diag,
        ))
    return views


def make_dataset(scene_path: str, out_npz: str, film=(512, 320),
                 n_views: int = 48, input_spp: int = 8,
                 target_spp: int = 128, inputs_per_view: int = 2,
                 seed: int = 1, progress=print, device: str = "cuda"):
    """Render (noisy input, noisier target) pairs on orbit views with a
    Renderer on `device`.

    Stores LINEAR radiance float16 plus the per-view auto-exposure scale
    of the FIRST noisy input (inference exposes the 8-spp frame it
    denoises). Keys: inp, tgt (N, H, W, 3) float16, expo (N,) float32,
    view (N,) int32, meta [input_spp, target_spp] int32.
    """
    from tracerboy_tpu_torch.post.pipeline import auto_exposure_scale
    from tracerboy_tpu_torch.renderer import Renderer, from_jax_pytree

    r = Renderer(scene_path, film_size=film, device=device)
    diag = float(np.linalg.norm(
        np.asarray(r.compiled.bvh_hi[0]) - np.asarray(r.compiled.bvh_lo[0])))
    rng = np.random.default_rng(seed)
    views = orbit_offsets(n_views, diag, rng)

    cam = r.compiled.camera
    cam0 = {f: np.array(getattr(cam, f))
            for f in ("position", "look_at", "right", "up")}

    def shot(spp, s):
        r.seed = int(s)
        r.invalidate_history()
        r.render_sample(spp)
        return torch.clamp_min(r.resolve_radiance(), 0.0)

    inps, tgts, expos, view_ids = [], [], [], []
    for vi, v in enumerate(views):
        r.move_camera(**v)
        tgt = shot(target_spp, 7_000_000 + vi).cpu().numpy()
        for k in range(inputs_per_view):
            inp = shot(input_spp, 1000 * vi + 17 * k + 1)
            if k == 0:
                expo = float(auto_exposure_scale(inp))
            inps.append(inp.cpu().numpy().astype(np.float16))
            tgts.append(tgt.astype(np.float16))
            expos.append(expo)
            view_ids.append(vi)
        progress(f"view {vi + 1}/{n_views} done")
        # Each view perturbs the ORIGINAL camera, restored exactly (an
        # inverse walk would drift: rotations do not commute).
        for f, val in cam0.items():
            setattr(cam, f, val.copy())
        r.scene["camera"] = from_jax_pytree(cam.as_numpy(), r.device)
        r.invalidate_history()

    os.makedirs(os.path.dirname(out_npz) or ".", exist_ok=True)
    np.savez_compressed(
        out_npz, inp=np.stack(inps), tgt=np.stack(tgts),
        expo=np.asarray(expos, np.float32),
        view=np.asarray(view_ids, np.int32),
        meta=np.asarray([input_spp, target_spp], np.int32))
    progress(f"wrote {out_npz}: {len(inps)} pairs")


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def _net_space(lin_f16: np.ndarray, expo: np.ndarray, device="cpu"):
    """(N, H, W, 3) linear float16 + (N,) exposure -> the net-space
    float32 tensor on `device`."""
    lin = torch.from_numpy(np.asarray(lin_f16)).to(device, torch.float32)
    e = torch.from_numpy(np.asarray(expo, np.float32)).to(device)
    return reinhard_fwd(lin * e[:, None, None, None])


def cosine_decay(steps: int):
    """optax.cosine_decay_schedule(lr, steps)'s factor of lr at update t
    (0 at the first): 0.5 (1 + cos(pi min(t, steps) / steps))."""
    return lambda t: 0.5 * (1.0 + math.cos(math.pi * min(t, steps) / steps))


def make_optimizer(model: OIDNUNet, lr: float, steps: int):
    """(Adam at optax.adam's defaults, its cosine-decay LambdaLR)."""
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, cosine_decay(steps))


def l2_loss(model: OIDNUNet, x, y):
    """Mean squared error of the network's float32 output against y."""
    out = model(x)
    return torch.mean(torch.square(out - y.to(out.dtype)))


def train_step(model: OIDNUNet, opt, sched, x, y):
    """One Adam update on the batch (x, y); the loss before it (a device
    scalar, not read back)."""
    opt.zero_grad(set_to_none=True)
    loss = l2_loss(model, x, y)
    loss.backward()
    opt.step()
    sched.step()
    return loss.detach()


def finetune(dataset_npz: str, out_npz: str,
             init_tza: str | OIDNUNet = RT_LDR_TZA, steps: int = 1500,
             lr: float = 1e-4, batch: int = 4, holdout_views: int = 2,
             seed: int = 0, log_every: int = 100, progress=print,
             device: str = "cuda"):
    """Fine-tune the rt_ldr UNet on `device`; saves Flax-layout params as
    float16 .npz. init_tza: a .tza path, or an OIDNUNet to start from (a
    copy is trained).

    Full-frame batches, random flips (the dihedral family of the
    inference-side TTA), L2 in net space (the noisier-target argument
    needs L2: the L1 minimizer is a median, which Monte-Carlo noise
    skews). Returns (initial, final) holdout loss.
    """
    with np.load(dataset_npz) as d:
        inp, tgt, expo, view = d["inp"], d["tgt"], d["expo"], d["view"]
    hold = view >= (view.max() + 1 - holdout_views)
    Xh, Yh = (_net_space(a[hold], expo[hold], device) for a in (inp, tgt))
    X, Y = (_net_space(a[~hold], expo[~hold], device) for a in (inp, tgt))

    model = (copy.deepcopy(init_tza) if isinstance(init_tza, OIDNUNet)
             else load_oidn(init_tza)).to(device)
    opt, sched = make_optimizer(model, lr, steps)

    def holdout():
        if not len(Xh):
            return float("nan")
        tot = 0.0
        with torch.no_grad():
            for i in range(0, len(Xh), batch):
                xb, yb = Xh[i:i + batch], Yh[i:i + batch]
                tot += float(l2_loss(model, xb, yb)) * len(xb)
        return tot / len(Xh)

    rng = np.random.default_rng(seed)
    h0 = holdout()
    progress(f"holdout L2 before: {h0:.6f} ({len(X)} train pairs)")
    for step in range(steps):
        idx = rng.integers(0, len(X), size=batch)
        # Rows by Python index: no index tensor to copy to the device.
        xb = torch.stack([X[int(i)] for i in idx])
        yb = torch.stack([Y[int(i)] for i in idx])
        if rng.random() < 0.5:
            xb, yb = xb.flip(2), yb.flip(2)
        if rng.random() < 0.5:
            xb, yb = xb.flip(1), yb.flip(1)
        loss = train_step(model, opt, sched, xb, yb)
        if (step + 1) % log_every == 0:
            progress(f"step {step + 1}/{steps} "
                     f"train L2 {float(loss):.6f}")
    h1 = holdout()
    progress(f"holdout L2 after: {h1:.6f} (before: {h0:.6f})")

    save_params_npz(out_npz, model)
    return h0, h1


def save_params_npz(path: str, model: OIDNUNet):
    """The UNet's weights as a flat float16 .npz of Flax conv params
    ("name.kernel" HWIO, "name.bias"), which the JAX package's
    load_params_npz reads."""
    flat = {}
    for name, layer in model.named_children():
        flat[f"{name}.kernel"] = layer.weight.detach().cpu().numpy() \
            .transpose(2, 3, 1, 0).astype(np.float16)
        flat[f"{name}.bias"] = layer.bias.detach().cpu().numpy() \
            .astype(np.float16)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **flat)


def load_params_npz(path: str, dtype=torch.bfloat16):
    """The UNet of a flat float16 .npz of Flax conv params ("name.kernel"
    HWIO, "name.bias"; save_params_npz of either package), on the CPU."""
    params: dict = {}
    with np.load(path) as d:
        for key in d.files:
            name, kind = key.rsplit(".", 1)
            params.setdefault(name, {})[kind] = d[key].astype(np.float32)
    return unet_from_state_dict(state_dict_from_flax({"params": params}),
                                dtype)
