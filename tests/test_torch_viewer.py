"""The port's viewer shell (tracerboy_tpu_torch/app/viewer.py) and profiling
utilities (utils/profiling.py), mirroring the JAX package's tests of the
same classes (tests/test_cli.py's settings panel, async load and
ViewerController; tests/test_utils.py's FrameStats and scope) on the
procedural cornell box, on the CPU. The JAX tests load a reference scene
that is not in the repository and skip here; these run.

TestParityWithJax holds the port's ViewerController and run_turntable
against the JAX package's on the same scene: the same keys leave the same
camera, settings, panel and material rows, and the same history restarts;
the turntable visits the same cameras. Neither renders (the turntable's
render is stubbed), so no JAX wave compiles.

f5 (the JAX viewer's shader reload, Renderer.recompile_shaders, not ported
by design) is an unhandled key in the port.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from tracerboy_tpu_torch import Renderer
from tracerboy_tpu_torch.app import viewer
from tracerboy_tpu_torch.utils.config import OutputType, RenderMode
from tracerboy_tpu_torch.utils.profiling import FrameStats, scope, trace_to

torch.set_num_threads(2)

SCENE = "shadertoy:cornell"


def _renderer(size=(16, 16)):
    return Renderer(SCENE, film_size=size, device="cpu")


def _controller(captures=None):
    return viewer.ViewerController(
        _renderer(), capture_writer=(captures.append if captures is not None
                                     else None))


class TestSettingsPanel:
    def test_panel_edits_settings_through_renderer(self):
        r = _renderer()
        panel = viewer.SettingsPanel(r)
        assert not panel.visible
        assert panel.handle_key("tab") and panel.visible
        assert "max bounces" in panel.text()
        before = r.settings.performance_settings.max_bounces
        assert panel.handle_key("right")
        assert r.settings.performance_settings.max_bounces == before + 1
        panel.handle_key("down")
        tm_before = r.settings.post_settings.tonemap_type
        panel.handle_key("right")
        assert r.settings.post_settings.tonemap_type != tm_before
        panel.handle_key("tab")
        assert not panel.handle_key("right")
        assert panel.text() == ""

    def test_panel_bounce_change_invalidates_history(self):
        r = _renderer()
        r.render_sample()
        assert r.state.spp == 1
        panel = viewer.SettingsPanel(r)
        panel.handle_key("tab")
        panel.handle_key("right")
        assert r.state.spp == 0

    def test_load_with_progress(self, capsys):
        r = viewer.load_with_progress(SCENE, film_size=(8, 8), device="cpu")
        assert r.device.type == "cpu"
        r.render_sample()
        assert r.state.spp == 1
        assert "scene loaded" in capsys.readouterr().out


class TestViewerController:
    def test_camera_keys_move_and_invalidate(self):
        ctl = _controller()
        r = ctl.renderer
        r.render_sample()
        pos_before = np.array(r.compiled.camera.position)
        assert ctl.on_key("w") == "camera"
        assert not np.allclose(np.array(r.compiled.camera.position),
                               pos_before)
        assert r.state.spp == 0
        assert ctl.on_key("left") == "camera"
        assert ctl.on_key("zz") == ""

    def test_f5_is_not_handled(self):
        """The port has no shaders to recompile (ROADMAP.md: "not to
        port, by design")."""
        ctl = _controller()
        ctl.renderer.render_sample()
        assert ctl.on_key("f5") == ""
        assert ctl.renderer.state.spp == 1
        assert not hasattr(ctl.renderer, "recompile_shaders")

    def test_mode_and_aov_toggles(self):
        ctl = _controller()
        r = ctl.renderer
        assert r.settings.render_mode == RenderMode.UNBIASED
        assert ctl.on_key("m") == "mode"
        assert r.settings.render_mode == RenderMode.REAL_TIME
        assert ctl.on_key("m") == "mode"
        assert r.settings.render_mode == RenderMode.UNBIASED
        assert ctl.on_key("o") == "aov"
        assert r.settings.output_type == OutputType.ALBEDO

    def test_click_select_then_bracket_edits_material(self):
        ctl = _controller()
        r = ctl.renderer
        assert ctl.on_key("[") == ""
        assert not ctl.on_click(8, 8)
        r.render_sample()
        info = ctl.on_click(8, 8)
        assert info and ctl.selected_mat == info["material_id"]
        alb = np.array(r.get_material(ctl.selected_mat)["albedo"])
        assert ctl.on_key("]") == "material"
        after = np.array(r.get_material(ctl.selected_mat)["albedo"])
        assert np.allclose(after, np.clip(alb * 1.25, 0, 1), atol=1e-6)
        assert ctl.on_key("[") == "material"

    def test_capture_key_uses_injected_writer(self):
        captures = []
        ctl = _controller(captures)
        ctl.renderer.render_sample()
        assert ctl.on_key("p") == "capture"
        assert len(captures) == 1 and captures[0].shape == (16, 16, 3)

    def test_panel_key_routes_to_panel(self):
        ctl = _controller()
        assert ctl.on_key("tab") == "panel"
        assert ctl.panel.visible


def _jax_renderer(size=(16, 16)):
    from tracerboy_tpu.renderer import Renderer as JaxRenderer

    return JaxRenderer(SCENE, film_size=size)


def _camera(r):
    cam = r.compiled.camera
    return np.stack([cam.position, cam.look_at, cam.right, cam.up])


def _count_restarts(r):
    """Wrap r.invalidate_history to count the history restarts."""
    calls = []
    inner = r.invalidate_history

    def counted():
        calls.append(1)
        inner()

    r.invalidate_history = counted
    return calls


def _view(ctl, restarts):
    r = ctl.renderer
    return dict(
        camera=_camera(r), settings=dataclasses.asdict(r.settings),
        materials={k: np.asarray(v) for k, v in r.compiled.materials.items()},
        panel=(ctl.panel.visible, ctl.panel.row, ctl.panel.text()),
        selected=ctl.selected_mat, restarts=len(restarts))


def _assert_same_view(got, want, step):
    np.testing.assert_array_equal(got["camera"], want["camera"],
                                  err_msg=step)
    assert got["settings"] == want["settings"], step
    assert sorted(got["materials"]) == sorted(want["materials"]), step
    for k, v in want["materials"].items():
        np.testing.assert_array_equal(got["materials"][k], v,
                                      err_msg=f"{step}: material {k}")
    for k in ("panel", "selected", "restarts"):
        assert got[k] == want[k], (step, k, got[k], want[k])


# Every key the port handles except f5 (JAX only) and p (writes the
# rendered image): camera moves and looks, both mode toggles, the AOV
# cycle past its wrap, and each of the panel's nine rows turned both ways.
PANEL_KEYS = ["tab"] + ["right", "right", "left", "down"] * 9 + [
    "up", "up", "right", "left", "left", "zz", "tab"]
VIEW_KEYS = (["w", "a", "s", "d", "q", "e", "left", "right", "up", "down",
              "w", "w", "left", "up", "m", "m", "m"] + ["o"] * 7
             + PANEL_KEYS + ["right", "zz", "s", "m"])


class TestParityWithJax:
    def test_keys_leave_the_jax_viewers_state(self):
        from tracerboy_tpu.app import viewer as jax_viewer

        jctl = jax_viewer.ViewerController(_jax_renderer())
        ctl = _controller()
        jn, n = _count_restarts(jctl.renderer), _count_restarts(ctl.renderer)
        _assert_same_view(_view(ctl, n), _view(jctl, jn), "start")
        for i, key in enumerate(VIEW_KEYS):
            assert ctl.on_key(key) == jctl.on_key(key), (i, key)
            _assert_same_view(_view(ctl, n), _view(jctl, jn), f"{i}: {key}")
        assert len(n) > 20

    def test_bracket_edits_match_jax(self):
        """'[' and ']' on each material of the box (the click only picks
        the id, so it is set directly)."""
        from tracerboy_tpu.app import viewer as jax_viewer

        jctl = jax_viewer.ViewerController(_jax_renderer())
        ctl = _controller()
        jn, n = _count_restarts(jctl.renderer), _count_restarts(ctl.renderer)
        assert ctl.on_key("]") == jctl.on_key("]") == ""
        n_mats = len(ctl.renderer.compiled.materials["albedo"])
        assert n_mats >= 3
        peak = 0.0
        for mid in range(n_mats):
            ctl.selected_mat = jctl.selected_mat = mid
            for key in ("]", "]", "]", "[", "]", "[", "["):
                assert ctl.on_key(key) == jctl.on_key(key) == "material"
                _assert_same_view(_view(ctl, n), _view(jctl, jn),
                                  f"material {mid}: {key}")
                peak = max(peak, float(np.max(ctl.renderer.get_material(
                    mid)["albedo"])))
        assert peak == 1.0   # the clip at 1 was reached
        albedo = ctl.renderer.compiled.materials["albedo"]
        # The device table follows the host rows.
        np.testing.assert_array_equal(
            ctl.renderer.scene["materials"]["albedo"].numpy(),
            np.asarray(albedo))

    def test_turntable_visits_the_jax_cameras(self, tmp_path):
        from tracerboy_tpu.app import viewer as jax_viewer

        frames, spp = 5, 3
        seen = {}
        for name, mod, r in (("jax", jax_viewer, _jax_renderer((8, 6))),
                             ("port", viewer, _renderer((8, 6)))):
            calls = seen[name] = []
            r.render_sample = (lambda s, r=r, calls=calls:
                               calls.append((s, _camera(r))))
            r.current_image = (lambda r=r:
                               np.zeros((r.height, r.width, 3), np.float32))
            mod.run_turntable(r, frames, str(tmp_path / name), spp=spp)
            calls.append((None, _camera(r)))
            assert sorted(os.listdir(tmp_path / name)) == [
                f"frame_{f:04d}.png" for f in range(frames)]
        assert len(seen["port"]) == frames + 1
        for f, ((sj, cj), (sp, cp)) in enumerate(zip(seen["jax"],
                                                     seen["port"])):
            assert sp == sj, f
            np.testing.assert_array_equal(cp, cj, err_msg=f"frame {f}")
        # The orbit moved the camera at every frame.
        cams = np.stack([c for _, c in seen["port"]])
        assert (np.abs(np.diff(cams[:, 0], axis=0)).max(axis=1) > 0).all()


def test_turntable_writes_frames(tmp_path, capsys):
    from tracerboy_tpu_torch.core import image_io

    # The benchmark scene: the orbit leaves the cornell box's walls
    # behind the camera after the first frame.
    out = tmp_path / "tt"
    assert viewer.main(["shadertoy", "--device", "cpu", "--size", "32x24",
                        "--turntable", "2", "--spp", "1", "--out-dir",
                        str(out)]) == 0
    frames = sorted(os.listdir(out))
    assert frames == ["frame_0000.png", "frame_0001.png"]
    imgs = [image_io.read_ldr(str(out / f)) for f in frames]
    for img in imgs:
        assert img.shape == (24, 32, 3) and img.max() > 0
    assert not np.array_equal(imgs[0], imgs[1])   # the camera orbited
    assert "turntable frame 2/2" in capsys.readouterr().out


def test_viewer_modules_import_no_jax():
    import subprocess
    import sys

    code = ("import sys\n"
            "import tracerboy_tpu_torch.app.viewer as v\n"
            "import tracerboy_tpu_torch.utils.profiling\n"
            "import tracerboy_tpu_torch.accel.bvh_device\n"
            "import tracerboy_tpu_torch.accel.validate\n"
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'tracerboy_tpu.', 'matplotlib'))))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


class TestProfiling:
    def test_frame_stats(self):
        import time

        fs = FrameStats(window=4)
        for _ in range(3):
            with fs.time_pass("trace"):
                time.sleep(0.002)
        fs.add_counter("rays", 1e6)
        assert fs.mean_ms("trace") >= 1.0
        assert fs.mean_counter("rays") == 1e6
        assert fs.mean_ms("none") == 0.0
        assert "trace" in fs.summary() and "rays" in fs.summary()

    def test_scope_nests(self):
        with scope("outer"):
            with scope("inner"):
                x = torch.arange(4.0).sum()
        assert float(x) == 6.0

    def test_trace_to_writes_a_chrome_trace_with_the_scopes(self, tmp_path):
        with trace_to(str(tmp_path / "prof")) as prof:
            with scope("tb_outer"):
                torch.arange(16.0).reshape(4, 4).sum()
        assert prof is not None
        path = tmp_path / "prof" / "trace.json"
        trace = json.loads(path.read_text())
        names = {e.get("name") for e in trace["traceEvents"]}
        assert "tb_outer" in names


@pytest.mark.parametrize("key", ["o", "p"])
def test_realtime_mode_frame_after_toggle(key, tmp_path, monkeypatch):
    """After 'm' the window's loop renders RealTime frames: one fused
    frame at 16x16 is an image in [0, 1]; 'o' and 'p' still route."""
    monkeypatch.chdir(tmp_path)
    ctl = _controller()
    r = ctl.renderer
    assert ctl.on_key("m") == "mode"
    img = r.render_realtime_frame_fused(as_numpy=True)
    assert img.shape == (16, 16, 3) and 0 <= img.min() and img.max() <= 1
    assert ctl.on_key(key) in ("aov", "capture")
    if key == "p":
        assert any(f.startswith("capture_") for f in os.listdir(tmp_path))
