"""Audit of the port's integer gathers on lanes that carry -1.

A jnp gather clamps an out-of-range index into range; a torch gather
wraps a negative index to the end of the table and asserts on the device
for one past it (the "IndexKernel.cu: index out of bounds" of ROADMAP.md
Queue 3 item 1). The wave carries -1 in a missed lane's triangle id and a
lane's instance where no instance was hit (trace/wavefront.py,
trace/instanced.py). This module renders with a torch function mode that
checks every integer-tensor index of Tensor.__getitem__, index_select,
gather and take_along_dim against the dimension it indexes, on scenes
whose waves carry such lanes: misses to the sky on the packed and brute
backends, after an update_geometry rebuild, and a TLAS scene with
instance misses. Every index must be in [0, size): a -1 that reached a
gather unclamped would be flagged as negative.
"""

import traceback

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from tracerboy_tpu_torch import Renderer
from tracerboy_tpu_torch.scene.compile import compile_scene
from tracerboy_tpu_torch.scene.pbrt_parser import parse_pbrt
from tracerboy_tpu_torch.trace import wavefront

torch.set_num_threads(2)


def _is_index(x):
    return (isinstance(x, torch.Tensor) and not x.dtype.is_floating_point
            and x.dtype != torch.bool)


class GatherAudit(TorchFunctionMode):
    """Records each integer index outside its dimension, with the line of
    the port that made the gather."""

    def __init__(self):
        super().__init__()
        self.checked = 0
        self.bad = []

    def _check(self, idx, size):
        if idx.numel() == 0:
            return
        self.checked += 1
        lo, hi = int(idx.min()), int(idx.max())
        if lo < 0 or hi >= size:
            where = next((f"{f.filename.split('tracerboy_tpu_torch/')[-1]}"
                          f":{f.lineno}" for f in reversed(
                              traceback.extract_stack())
                          if "tracerboy_tpu_torch" in f.filename), "?")
            self.bad.append((where, lo, hi, size))

    def _getitem(self, t, key):
        if _is_index(key):
            self._check(key, t.shape[0])
            return
        if not isinstance(key, tuple) or any(k is Ellipsis for k in key):
            return
        dim = 0
        for k in key:
            if k is None:
                continue
            if _is_index(k):
                self._check(k, t.shape[dim])
                dim += 1
            elif isinstance(k, torch.Tensor):     # a mask
                dim += k.dim()
            else:
                dim += 1

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.Tensor.__getitem__:
            self._getitem(args[0], args[1])
        elif func in (torch.index_select, torch.Tensor.index_select):
            dim = args[1] if len(args) > 1 else kwargs["dim"]
            self._check(args[2] if len(args) > 2 else kwargs["index"],
                        args[0].shape[dim])
        elif func in (torch.gather, torch.Tensor.gather,
                      torch.take_along_dim):
            dim = args[1] if len(args) > 1 else kwargs["dim"]
            if func is torch.take_along_dim:
                idx, dim = args[1], args[2] if len(args) > 2 else kwargs.get(
                    "dim")
            else:
                idx = args[2] if len(args) > 2 else kwargs["index"]
            if dim is not None:
                self._check(idx, args[0].shape[dim])
        return func(*args, **kwargs)


def test_the_audit_flags_a_negative_index():
    x = torch.arange(10.0)
    with GatherAudit() as audit:
        x[torch.tensor([3, -1])]
        x[torch.tensor([0, 9])]
        torch.gather(x, 0, torch.tensor([10]).clamp(0, 9))
    assert audit.checked == 3
    assert [b[1:] for b in audit.bad] == [(-1, 3, 10)]


def _miss_lanes(scene_name, **kw):
    """Closest-hit launches of one render that carry missed lanes."""
    seen = {"miss": 0}
    real = wavefront._closest

    def counting(*args, **kwargs):
        out = real(*args, **kwargs)
        seen["miss"] += int((out[1] < 0).sum())
        return out
    return seen, counting, real


@pytest.mark.parametrize("case", ["packed", "brute", "packed_rebuilt"])
def test_miss_lanes_reach_no_gather_out_of_range(case, monkeypatch):
    name = "shadertoy:cornell" if case == "brute" else "shadertoy"
    if case != "brute":
        monkeypatch.setenv("TB_TRAVERSAL", "pallas")
    r = Renderer(name, film_size=(16, 12), device="cpu")
    if case == "packed_rebuilt":
        sc = r.scene
        r.update_geometry(sc["tri_v0"] * 1.01, sc["tri_v1"] * 1.01,
                          sc["tri_v2"] * 1.01)
    seen, counting, _ = _miss_lanes(name)
    monkeypatch.setattr(wavefront, "_closest", counting)
    with GatherAudit() as audit:
        r.render_sample(1)
    assert seen["miss"] > 0          # the wave carried -1 ids
    assert audit.checked > 100
    assert audit.bad == [], audit.bad[:8]


def test_instance_misses_reach_no_gather_out_of_range(tmp_path, monkeypatch):
    """The TLAS scene: lanes that hit no instance (inst -1), lanes that
    hit the flat ground only, and the BLAS pass's dead lanes."""
    from test_torch_instanced import two_object_text

    path = tmp_path / "two.pbrt"
    path.write_text(two_object_text(1, 2, (2.0,)))
    cs = compile_scene(parse_pbrt(str(path)), instancing="tlas")
    r = Renderer(cs, film_size=(16, 12), device="cpu")
    assert r.wave_config().has_instances
    with GatherAudit() as audit:
        r.render_sample(1)
        r.update_object_geometry(
            0, *(cs.inst_objects[0]["verts"][:, k] * 1.1 for k in range(3)))
        r.render_sample(1)
    assert np.isfinite(r.state.accum.numpy()).all()
    assert audit.checked > 100
    assert audit.bad == [], audit.bad[:8]
