"""Interactive viewer: progressive preview with camera controls
(tracerboy_tpu/app/viewer.py).

The analog of the reference's windowed app + ImGui panel (WinMain +
UIController): a matplotlib window showing the progressively refined
render with WASD/QE camera movement, arrow-key look, mode/AOV toggles and
click-to-inspect material editing (the SelectPixel round trip of
D3D12App.cpp:146-152/275-314). Falls back to a turntable PNG sequence
when no display is available (the 'P' capture path, D3D12App.cpp:341-364).

The JAX viewer's f5 key recompiles its shaders (Renderer.recompile_shaders
clears jax's caches); the port has nothing to recompile, so f5 is an
unhandled key here. matplotlib is imported only by the window
(run_viewer); the turntable and ViewerController need none.

Usage:
  python -m tracerboy_tpu_torch.app.viewer SCENE.pbrt [--size 320x240]
  python -m tracerboy_tpu_torch.app.viewer SCENE.pbrt --turntable 12 --out-dir frames/
  python -m tracerboy_tpu_torch.app.viewer SCENE.pbrt --device cpu --size 32x24 --turntable 2

--device is the port's own flag (the renderer's torch device, default
cuda), as in app/cli.py.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


class SettingsPanel:
    """Keyboard-driven runtime settings editor — the UIController panel
    (UIController.cpp:161-320) without ImGui: rows of (label, get,
    set(delta)); up/down selects, left/right adjusts, changes flow
    through Renderer.update_settings so history invalidation follows the
    same diffing rules as the reference's UpdateOutputSettings."""

    def __init__(self, renderer):
        import dataclasses

        from tracerboy_tpu_torch.utils.config import TonemapType

        self.renderer = renderer
        self.visible = False
        self.row = 0

        def repl(**kw):
            return renderer.settings.replace(**kw)

        def repl_perf(**kw):
            return repl(performance_settings=dataclasses.replace(
                renderer.settings.performance_settings, **kw))

        def repl_post(**kw):
            return repl(post_settings=dataclasses.replace(
                renderer.settings.post_settings, **kw))

        def repl_den(**kw):
            return repl(denoiser_settings=dataclasses.replace(
                renderer.settings.denoiser_settings, **kw))

        tm_values = list(TonemapType)

        self.rows = [
            ("max bounces", lambda: renderer.settings
             .performance_settings.max_bounces,
             lambda d: repl_perf(max_bounces=max(
                 1, renderer.settings.performance_settings.max_bounces + d))),
            ("tonemap", lambda: renderer.settings
             .post_settings.tonemap_type.name,
             lambda d: repl_post(tonemap_type=tm_values[
                 (tm_values.index(
                     renderer.settings.post_settings.tonemap_type) + d)
                 % len(tm_values)])),
            ("exposure", lambda: round(
                renderer.settings.post_settings.exposure_multiplier, 2),
             lambda d: repl_post(exposure_multiplier=max(
                 0.05, renderer.settings.post_settings.exposure_multiplier
                 * (1.25 if d > 0 else 0.8)))),
            ("auto exposure", lambda: renderer.settings
             .post_settings.enable_auto_exposure,
             lambda d: repl_post(enable_auto_exposure=not renderer
                                 .settings.post_settings
                                 .enable_auto_exposure)),
            ("denoiser", lambda: renderer.settings
             .denoiser_settings.enabled,
             lambda d: repl_den(enabled=not renderer.settings
                                .denoiser_settings.enabled)),
            ("wavelet iters", lambda: renderer.settings
             .denoiser_settings.wavelet_iterations,
             lambda d: repl_den(wavelet_iterations=max(
                 1, renderer.settings.denoiser_settings
                 .wavelet_iterations + d))),
            ("target fps", lambda: renderer.settings
             .performance_settings.target_frame_rate,
             lambda d: repl_perf(target_frame_rate=max(
                 0.0, renderer.settings.performance_settings
                 .target_frame_rate + 5 * d))),
            ("NEE", lambda: renderer.settings
             .performance_settings.enable_next_event_estimation,
             lambda d: repl_perf(
                 enable_next_event_estimation=not renderer.settings
                 .performance_settings.enable_next_event_estimation)),
            ("normal maps", lambda: renderer.settings
             .performance_settings.enable_normal_maps,
             lambda d: repl_perf(
                 enable_normal_maps=not renderer.settings
                 .performance_settings.enable_normal_maps)),
        ]

    def handle_key(self, key) -> bool:
        """Returns True when the key was consumed by the panel."""
        if key == "tab":
            self.visible = not self.visible
            return True
        if not self.visible:
            return False
        if key == "up":
            self.row = (self.row - 1) % len(self.rows)
        elif key == "down":
            self.row = (self.row + 1) % len(self.rows)
        elif key in ("left", "right"):
            _, _, setter = self.rows[self.row]
            self.renderer.update_settings(setter(1 if key == "right" else -1))
        else:
            return False
        return True

    def text(self) -> str:
        if not self.visible:
            return ""
        lines = ["-- settings ([tab] close, arrows adjust) --"]
        for i, (label, get, _) in enumerate(self.rows):
            sel = ">" if i == self.row else " "
            lines.append(f"{sel} {label}: {get()}")
        return "\n".join(lines)


def load_with_progress(path, film_size, device="cuda"):
    """Async scene load with a loading screen (the reference's
    SceneLoadStatus loading screen, UIController.cpp:124-140)."""
    import time

    from tracerboy_tpu_torch import Renderer
    from tracerboy_tpu_torch.scene.compile import load_scene_async

    stages = []
    fut = load_scene_async(path, film_size=film_size,
                           on_progress=stages.append)
    spinner = "|/-\\"
    k = 0
    while not fut.done():
        stage = stages[-1] if stages else "starting"
        print(f"\r[{spinner[k % 4]}] loading scene: {stage} ...",
              end="", flush=True)
        k += 1
        time.sleep(0.25)
    print("\rscene loaded" + " " * 30)
    return Renderer(fut.result(), film_size=film_size, device=device)


class ViewerController:
    """Headless-testable event core of the interactive viewer: all
    key/click behavior lives here; run_viewer only wires matplotlib
    events to it. Mirrors the reference's input routing
    (D3D12App.cpp:146-152 OnKeyDown -> camera/UI dispatch,
    275-314 SelectPixel/material round trip)."""

    def __init__(self, renderer, capture_writer=None):
        from tracerboy_tpu_torch.utils.config import OutputType

        self.renderer = renderer
        self.panel = SettingsPanel(renderer)
        self.selected_mat = None
        self.move = 0.25 * renderer.settings.camera_settings.movement_speed
        self.aov_cycle = [
            OutputType.LIT, OutputType.ALBEDO, OutputType.NORMAL,
            OutputType.DEPTH, OutputType.VARIANCE, OutputType.HEATMAP,
        ]
        self._capture = capture_writer  # injectable for tests

    def on_key(self, k) -> str:
        """Handle one key; returns what it did ('' = unhandled)."""
        from tracerboy_tpu_torch.utils.config import RenderMode

        r = self.renderer
        if self.panel.handle_key(k):
            return "panel"
        cam_moves = {
            "w": dict(forward=self.move), "s": dict(forward=-self.move),
            "a": dict(strafe=-self.move), "d": dict(strafe=self.move),
            "q": dict(upward=-self.move), "e": dict(upward=self.move),
            "left": dict(yaw=-0.1), "right": dict(yaw=0.1),
            "up": dict(pitch=-0.1), "down": dict(pitch=0.1),
        }
        if k in cam_moves:
            r.move_camera(**cam_moves[k])
            return "camera"
        if k in ("[", "]") and self.selected_mat is not None:
            # Live material edit on the picked pixel's material
            # (the D3D12App.cpp:307-314 round trip).
            mid = self.selected_mat
            alb = r.get_material(mid)["albedo"]
            scale = 1.25 if k == "]" else 0.8
            r.set_material(mid, albedo=np.clip(alb * scale, 0, 1))
            return "material"
        if k == "m":
            mode = (RenderMode.REAL_TIME
                    if r.settings.render_mode == RenderMode.UNBIASED
                    else RenderMode.UNBIASED)
            r.update_settings(r.settings.replace(render_mode=mode))
            return "mode"
        if k == "o":
            cur = self.aov_cycle.index(r.settings.output_type) \
                if r.settings.output_type in self.aov_cycle else 0
            r.settings = r.settings.replace(
                output_type=self.aov_cycle[
                    (cur + 1) % len(self.aov_cycle)]
            )
            return "aov"
        if k == "p":
            if self._capture is not None:
                self._capture(r.current_image())
            else:
                from tracerboy_tpu_torch.core import image_io

                image_io.write_png(
                    f"capture_{r.state.spp:05d}.png", r.current_image())
            return "capture"
        return ""

    def on_click(self, x, y) -> dict | None:
        info = self.renderer.select_pixel(int(x), int(y))
        if info:
            self.selected_mat = info["material_id"]
        return info


def run_viewer(renderer, samples_per_frame: int = 1):
    import matplotlib

    try:
        matplotlib.use("TkAgg")
    except Exception:
        pass
    import matplotlib.pyplot as plt

    from tracerboy_tpu_torch.utils.config import RenderMode

    fig, ax = plt.subplots(figsize=(8, 6))
    fig.canvas.manager.set_window_title("tracerboy-tpu-torch")
    im = ax.imshow(np.zeros((renderer.height, renderer.width, 3)))
    ax.set_axis_off()
    status = ax.set_title("rendering...")

    ctl = ViewerController(renderer)
    panel_text = ax.text(
        0.02, 0.98, "", transform=ax.transAxes, va="top", ha="left",
        fontsize=9, family="monospace", color="white",
        bbox=dict(facecolor="black", alpha=0.65, pad=6),
    )

    def on_key(event):
        did = ctl.on_key(event.key)
        if did == "panel":
            panel_text.set_text(ctl.panel.text())

    def on_click(event):
        if event.xdata is None:
            return
        info = ctl.on_click(event.xdata, event.ydata)
        if info:
            print(f"pixel ({int(event.xdata)}, {int(event.ydata)}): "
                  f"material {info['material_id']} depth "
                  f"{info['depth']:.3f} albedo {info['albedo']}  "
                  f"('['/']' edits albedo)")
            print(renderer.get_material(info["material_id"]))

    fig.canvas.mpl_connect("key_press_event", on_key)
    fig.canvas.mpl_connect("button_press_event", on_click)

    import time

    while plt.fignum_exists(fig.number):
        t0 = time.time()
        if renderer.settings.render_mode == RenderMode.REAL_TIME:
            img = renderer.render_realtime_frame_fused(as_numpy=True)
        else:
            renderer.render_sample(samples_per_frame)
            img = renderer.current_image()
        im.set_data(np.clip(img, 0, 1))
        dt = time.time() - t0
        status.set_text(
            f"{renderer.state.spp} spp | {1.0/max(dt,1e-6):.1f} fps | "
            f"conv {renderer.convergence_error():.4f} | "
            f"[wasdqe] move [arrows] look [m]ode [o]utput [p] capture "
            f"[tab] settings"
        )
        fig.canvas.draw_idle()
        plt.pause(0.001)


def run_turntable(renderer, frames: int, out_dir: str, spp: int = 8):
    """Offscreen orbit animation (headless fallback)."""
    import os

    from tracerboy_tpu_torch.core import image_io

    os.makedirs(out_dir, exist_ok=True)
    step = 2 * np.pi / frames
    for f in range(frames):
        renderer.render_sample(spp)
        image_io.write_png(
            os.path.join(out_dir, f"frame_{f:04d}.png"),
            renderer.current_image(),
        )
        # Orbit: move sideways proportional to radius, then look back.
        cam = renderer.compiled.camera
        radius = float(np.linalg.norm(cam.look_at - cam.position))
        renderer.move_camera(strafe=radius * step, yaw=step)
        print(f"turntable frame {f + 1}/{frames}", flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(prog="tracerboy-tpu-torch viewer")
    p.add_argument("scene")
    p.add_argument("--size", default="320x240")
    p.add_argument("--turntable", type=int, default=0,
                   help="render N orbit frames headless instead of a window")
    p.add_argument("--out-dir", default="turntable")
    p.add_argument("--spp", type=int, default=2,
                   help="samples per displayed frame")
    p.add_argument("--device", default="cuda",
                   help="torch device of the renderer (cpu runs the "
                        "kernels' plain versions)")
    args = p.parse_args(argv)

    w, h = (int(x) for x in args.size.lower().split("x"))
    r = load_with_progress(args.scene, film_size=(w, h), device=args.device)
    if args.turntable:
        run_turntable(r, args.turntable, args.out_dir, args.spp)
    else:
        run_viewer(r, args.spp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
