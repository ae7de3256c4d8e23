"""Command-line renderer (tracerboy_tpu/app/cli.py): progressive render
to a sample or time target with progress lines, PNG/EXR/HDR/PFM output,
AOV views, the OIDN denoiser, numbered captures and checkpoint/resume of
the accumulation state.

Usage:
  python -m tracerboy_tpu_torch.app.cli SCENE.pbrt --spp 64 --out out.png
  python -m tracerboy_tpu_torch.app.cli SCENE.pbrt --mode realtime --frames 30
  python -m tracerboy_tpu_torch.app.cli SCENE.pbrt --device cpu --size 32x24
  python -m tracerboy_tpu_torch.app.cli SCENE.pbrt --export-pbf SCENE.pbf

The flags are the JAX CLI's, plus two of the port's own: --device (the
renderer's torch device, default cuda; the CPU runs the kernels' plain
versions) and --archive (the .tza weights --denoiser oidn* needs: the
repository ships none). --upscale superres reads the reference's
weights.bin where the JAX CLI does (ml/superres.py WEIGHTS_BIN) and
stops before rendering without it. --shard tiles|spp with --devices N
splits the render over a mesh (parallel/sharding.py): on --device cuda
the first N cards (default: all), on --device cpu the CPU N times
(default 1).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

def build_parser():
    p = argparse.ArgumentParser(prog="tracerboy-tpu-torch",
                                description=__doc__)
    p.add_argument("scene", help=".pbrt, .pbf, .obj, .stl, .gltf or .glb "
                   "scene file, .npz compiled cache or shadertoy[:name]")
    p.add_argument("--out", default="out.png", help="output image path")
    p.add_argument("--spp", type=int, default=None,
                   help="sample target (default: settings/sampler)")
    p.add_argument("--size", default=None, metavar="WxH",
                   help="override film resolution, e.g. 512x512")
    p.add_argument("--mode", choices=["unbiased", "realtime"],
                   default="unbiased")
    p.add_argument("--frames", type=int, default=30,
                   help="frames to run in realtime mode")
    p.add_argument("--max-bounces", type=int, default=None)
    p.add_argument("--tonemap", default=None,
                   choices=["reinhard", "aces", "clamp", "uncharted",
                            "pbr_neutral", "agx", "agx_punchy", "gt"])
    p.add_argument("--no-nee", action="store_true")
    p.add_argument("--env-nee", default="auto",
                   choices=["auto", "on", "off"],
                   help="environment NEE with MIS: auto = on when the "
                        "env dome is the scene's only light")
    p.add_argument("--sampler", default="pcg", choices=["pcg", "sobol"],
                   help="sample streams: pcg hash randoms (+blue noise) "
                        "or padded Owen-scrambled Sobol")
    p.add_argument("--ris", action="store_true",
                   help="enable reservoir (RIS) light sampling")
    p.add_argument("--transparent-shadows", action="store_true",
                   help="glass attenuates shadow rays by Fresnel "
                        "transmission instead of hard-occluding "
                        "(straight-line approximation)")
    p.add_argument("--no-auto-exposure", action="store_true")
    p.add_argument("--exposure", type=float, default=1.0)
    p.add_argument("--firefly-clamp", type=float, default=0.0)
    p.add_argument("--dof-focus", type=float, default=0.0)
    p.add_argument("--dof-aperture", type=float, default=0.01)
    p.add_argument("--time-limit", type=float, default=-1.0,
                   help="stop after N seconds")
    p.add_argument("--aov", default=None,
                   choices=["albedo", "normal", "depth", "luminance"],
                   help="write this AOV instead of the lit image")
    p.add_argument("--denoiser", default="none",
                   choices=["none", "oidn", "oidn-ldr", "oidn-alb-nrm",
                            "oidn-clip", "oidn-alb-nrm-clip"],
                   help="ML denoise the final image (needs --archive). "
                        "oidn = color-only rt_ldr; oidn-alb-nrm = "
                        "albedo+normal-guided")
    p.add_argument("--archive", default=None, metavar="PATH.tza",
                   help="the OIDN weights of --denoiser's model")
    p.add_argument("--upscale", default=None, choices=["fsr", "superres"],
                   help="2x upscale the output")
    p.add_argument("--volume", default=None,
                   help="attach a heterogeneous medium: .vdb (OpenVDB "
                        "FloatGrid), .vol (Mitsuba grid), .npy density, "
                        "or 'cloud' (procedural test cloud)")
    p.add_argument("--hdr-out", default=None,
                   help="also write linear radiance (.exr/.hdr/.pfm)")
    p.add_argument("--capture-every", type=int, default=0, metavar="N",
                   help="write a numbered PNG every N samples")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file to save/resume accumulation")
    p.add_argument("--checkpoint-every", type=int, default=64,
                   help="checkpoint every N samples")
    p.add_argument("--shard", default="none",
                   choices=["none", "tiles", "spp"],
                   help="multi-device scaling axis over the mesh: tiles = "
                        "pixel pool split across the mesh; spp = every "
                        "mesh entry traces different sample indices, the "
                        "accumulators summed in mesh order")
    p.add_argument("--devices", type=int, default=None,
                   help="number of devices for --shard (default: all "
                        "cards; on --device cpu, 1)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--export-pbf", default=None, metavar="OUT.pbf",
                   help="serialize the parsed scene as a .pbf binary "
                        "(the reference's fast-load cache format) and exit")
    p.add_argument("--device", default="cuda",
                   help="torch device of the renderer (cuda or cpu)")
    p.add_argument("--quiet", "-q", action="store_true")
    return p



def _settings(args):
    from tracerboy_tpu_torch.utils.config import (
        OutputType,
        RenderMode,
        TonemapType,
        default_output_settings,
    )

    s = default_output_settings()
    perf = dataclasses.replace(
        s.performance_settings,
        enable_next_event_estimation=not args.no_nee,
        enable_sampling_importance_resampling=args.ris,
        environment_nee=args.env_nee,
        sampler=args.sampler,
        transparent_shadows=args.transparent_shadows,
        **({"max_bounces": args.max_bounces} if args.max_bounces else {}),
    )
    post = dataclasses.replace(
        s.post_settings,
        enable_auto_exposure=not args.no_auto_exposure,
        exposure_multiplier=args.exposure,
        **({"tonemap_type": TonemapType[args.tonemap.upper().replace(
            "PBR_NEUTRAL", "KHRONOS_PBR_NEUTRAL")]}
           if args.tonemap else {}),
    )
    s = s.replace(
        performance_settings=perf,
        post_settings=post,
        render_mode=(RenderMode.REAL_TIME if args.mode == "realtime"
                     else RenderMode.UNBIASED),
        fireflies_clamp=args.firefly_clamp,
        debug_settings=dataclasses.replace(
            s.debug_settings, time_limit_seconds=args.time_limit),
    )
    if args.aov:
        s = s.replace(output_type=OutputType[args.aov.upper()])
    if args.dof_focus > 0:
        s = s.replace(camera_settings=dataclasses.replace(
            s.camera_settings, dof_focus_distance=args.dof_focus,
            dof_aperture_width=args.dof_aperture))
    return s


def main(argv=None, stats: dict | None = None):
    """Run the CLI on argv (default sys.argv[1:]); returns the exit code.
    stats: a dict to fill with what the render loop did (spp traced,
    seconds, rays_traced, width, height, mode), for a caller that reports
    seconds a sample and Mrays/s."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.export_pbf:
        from tracerboy_tpu_torch.scene.pbf import write_pbf
        from tracerboy_tpu_torch.scene.pbrt_parser import parse_pbrt

        write_pbf(args.export_pbf, parse_pbrt(args.scene))
        print(f"wrote {args.export_pbf}")
        return 0
    if args.denoiser != "none" and not args.archive:
        parser.error(f"--denoiser {args.denoiser} needs --archive PATH.tza "
                     "(the model's OIDN weights)")
    if args.upscale == "superres":
        from tracerboy_tpu_torch.ml import superres

        if not os.path.exists(superres.WEIGHTS_BIN):
            parser.error(f"--upscale superres needs {superres.WEIGHTS_BIN} "
                         "(the super-resolution network's weights.bin)")

    import numpy as np
    import torch

    from tracerboy_tpu_torch.core import image_io
    from tracerboy_tpu_torch.renderer import Renderer
    from tracerboy_tpu_torch.utils.checkpoint import (
        load_render_checkpoint,
        save_render_checkpoint,
    )

    film = None
    if args.size:
        w, h = args.size.lower().split("x")
        film = (int(w), int(h))

    t0 = time.time()
    log = (lambda *a: None) if args.quiet else (
        lambda *a: print(f"[{time.time() - t0:7.1f}s]", *a, flush=True))

    log(f"loading {args.scene} ...")
    vol = None
    if args.volume:
        from tracerboy_tpu_torch.scene import volume as vmod

        vol = (vmod.procedural_cloud() if args.volume == "cloud"
               else vmod.load_volume(args.volume))
    shard = None if args.shard == "none" else args.shard
    r = Renderer(args.scene, settings=_settings(args), film_size=film,
                 seed=args.seed, volume=vol, device=args.device, shard=shard,
                 n_devices=args.devices)
    log(f"scene ready: {r.compiled.num_tris} tris, "
        f"{r.compiled.num_lights} lights, {r.width}x{r.height}, "
        f"{len(r.compiled.materials['flags'])} materials")
    if shard:
        log(f"sharding: {shard} over {r.mesh.size} devices")

    if args.checkpoint and load_render_checkpoint(args.checkpoint, r):
        log(f"resumed from checkpoint at {r.state.spp} spp")

    def sync():
        if r.device.type == "cuda":
            torch.cuda.synchronize(r.device)

    sync()
    t_render = time.time()
    rays0, spp0 = r.rays_traced, r.state.spp
    if args.mode == "realtime":
        for f in range(args.frames):
            img = r.render_realtime_frame_fused(
                as_numpy=(f == args.frames - 1))
            if f % 10 == 0:
                log(f"frame {f}")
        img = np.asarray(img)
    else:
        target = args.spp or r.compiled.sampler_spp
        batch = 4
        while r.state.spp < target:
            r.render_sample(min(batch, target - r.state.spp))
            log(f"{r.state.spp}/{target} spp  "
                f"convergence={r.convergence_error():.5f}")
            if args.checkpoint and r.state.spp % args.checkpoint_every == 0:
                save_render_checkpoint(args.checkpoint, r)
            if args.capture_every and r.state.spp % args.capture_every == 0:
                base, ext = os.path.splitext(args.out)
                image_io.write_png(
                    f"{base}_{r.state.spp:05d}{ext or '.png'}",
                    r.current_image())
            if args.time_limit > 0 and time.time() - t0 > args.time_limit:
                log("time limit reached")
                break
        img = r.current_image()
    sync()
    if stats is not None:
        stats.update(spp=r.state.spp - spp0, seconds=time.time() - t_render,
                     rays_traced=r.rays_traced - rays0, width=r.width,
                     height=r.height, mode=args.mode)

    if args.denoiser.startswith("oidn"):
        from tracerboy_tpu_torch.post.pipeline import display_transform

        model = ("rt_ldr_alb_nrm" if "alb-nrm" in args.denoiser
                 else "rt_ldr")
        transfer = "clip" if args.denoiser.endswith("-clip") else "reinhard"
        den_lin = r.denoise(model=model, transfer=transfer,
                            archive=args.archive)
        ps = r.settings.post_settings
        img = display_transform(
            torch.as_tensor(den_lin, device=r.device),
            ps.exposure_multiplier, int(ps.tonemap_type),
            ps.enable_gamma_correction, ps.enable_auto_exposure,
        ).cpu().numpy()
        log(f"denoised (OIDN UNet, {model}, {transfer} transfer)")

    if args.upscale:
        from tracerboy_tpu_torch.ml import superres
        from tracerboy_tpu_torch.ml.fsr import fsr_upscale

        x = torch.as_tensor(img, device=r.device)
        if args.upscale == "fsr":
            x = fsr_upscale(x)
            log("upscaled 2x (FSR-style EASU+RCAS)")
        else:
            net = superres.load_superres(superres.WEIGHTS_BIN).to(r.device)
            x = superres.upscale2x(net, x)
            log("upscaled 2x (super-resolution CNN)")
        img = x.cpu().numpy()

    image_io.write_png(args.out, img)
    log(f"wrote {args.out}")

    if args.hdr_out:
        rad = r.resolve_radiance().cpu().numpy()
        ext = args.hdr_out.rsplit(".", 1)[-1].lower()
        if ext == "exr":
            image_io.write_exr(args.hdr_out, rad)
        elif ext == "pfm":
            image_io.write_pfm(args.hdr_out, rad)
        else:
            image_io.write_hdr(args.hdr_out, rad)
        log(f"wrote {args.hdr_out}")

    if args.checkpoint and args.mode != "realtime":
        save_render_checkpoint(args.checkpoint, r)
    return 0


if __name__ == "__main__":
    sys.exit(main())
