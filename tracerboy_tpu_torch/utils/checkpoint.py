"""Render-state checkpoint and resume (tracerboy_tpu/utils/checkpoint.py).

The accumulation state is (sum, weight), so resuming is exact. One .npz
holds the Unbiased accumulators (accum, accum_jittered, world_pos0/1,
spp) and, once RealTime mode has run, the fused path's temporal history
(rt_hist.<i>), the previous frame's camera (cam_prev.<i>) and the
frame-rate governor's pad (governor_pad). The keys and the leaf order are
the JAX package's (jax.tree_util flattens a dict in sorted key order,
depth first), so a file written by either package resumes in the other.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tracerboy_tpu_torch.scene.compile import from_jax_pytree


def _leaves(tree: dict) -> list:
    """The leaves of a nested dict in jax.tree_util's order."""
    out = []
    for key in sorted(tree):
        v = tree[key]
        out.extend(_leaves(v) if isinstance(v, dict) else [v])
    return out


def _treedef(tree: dict) -> str:
    """jax.tree_util's text of a nested dict's structure."""
    def body(t):
        return "{" + ", ".join(
            f"'{k}': " + (body(t[k]) if isinstance(t[k], dict) else "*")
            for k in sorted(t)) + "}"

    return f"PyTreeDef({body(tree)})"


def _flatten_tree(prefix: str, tree: dict, out: dict):
    out[prefix + ".__treedef__"] = np.frombuffer(_treedef(tree).encode(),
                                                 dtype=np.uint8)
    for i, leaf in enumerate(_leaves(tree)):
        out[f"{prefix}.{i}"] = _numpy(leaf)


def _unflatten_tree(prefix: str, like_tree: dict, z):
    """numpy leaves of the file shaped like like_tree, or None when one
    is missing or another shape (the resolution changed)."""
    def build(tree, counter):
        new = {}
        for key in sorted(tree):
            if isinstance(tree[key], dict):
                new[key] = build(tree[key], counter)
                if new[key] is None:
                    return None
                continue
            name = f"{prefix}.{counter[0]}"
            counter[0] += 1
            if name not in z.files:
                return None
            arr = z[name]
            want = tuple(tree[key].shape)
            if tuple(arr.shape) != want:
                # An old (H, W) diffuse_contrib plane of a RealTime
                # history becomes the (H, W, 3) one.
                if (arr.ndim + 1 == len(want)
                        and tuple(arr.shape) == want[:-1] and want[-1] == 3):
                    arr = np.repeat(arr[..., None], 3, axis=-1)
                else:
                    return None
            new[key] = arr
        return new

    return build(like_tree, [0])


def _numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def save_render_checkpoint(path: str, renderer) -> None:
    st = renderer.state
    flat = dict(
        accum=_numpy(st.accum),
        accum_jittered=_numpy(st.accum_jittered),
        world_pos0=_numpy(st.world_pos[0]),
        world_pos1=_numpy(st.world_pos[1]),
        spp=np.asarray(st.spp),
    )
    if renderer._rt_hist_fused is not None:
        _flatten_tree("rt_hist", renderer._rt_hist_fused, flat)
    if renderer._cam_prev is not None:
        _flatten_tree("cam_prev", renderer._cam_prev, flat)
    if renderer._governor is not None:
        flat["governor_pad"] = np.asarray(float(renderer._governor.pad))
    np.savez_compressed(path, **flat)


def load_render_checkpoint(path: str, renderer) -> bool:
    """Resume renderer from path; False (nothing changed) when there is
    no such file or its film size differs."""
    if not os.path.exists(path):
        return False
    z = np.load(path)
    st = renderer.state
    if z["accum"].shape != tuple(st.accum.shape):
        return False

    def dev(a):
        return torch.from_numpy(np.array(a, np.float32)).to(renderer.device)

    st.accum = dev(z["accum"])
    st.accum_jittered = dev(z["accum_jittered"])
    st.world_pos = [dev(z["world_pos0"]), dev(z["world_pos1"])]
    st.spp = int(z["spp"])
    hist = cam = None
    if "rt_hist.0" in z.files:
        hist = _unflatten_tree("rt_hist", renderer.empty_realtime_history(),
                               z)
    if "cam_prev.0" in z.files:
        cam = _unflatten_tree("cam_prev", renderer.scene["camera"], z)
    if hist is not None:
        if cam is None and renderer._cam_prev is not None:
            cam = {k: _numpy(v) for k, v in renderer._cam_prev.items()}
        renderer.load_realtime_history(hist, cam)
    elif cam is not None:
        renderer._cam_prev = from_jax_pytree(cam, renderer.device)
    if "governor_pad" in z.files:
        from tracerboy_tpu_torch.post.realtime import FrameRateGovernor

        if renderer._governor is None:
            perf = renderer.settings.performance_settings
            renderer._governor = FrameRateGovernor(
                target_fps=perf.target_frame_rate,
                pad=perf.convergence_percent_pad)
        renderer._governor.pad = float(z["governor_pad"])
    return True
