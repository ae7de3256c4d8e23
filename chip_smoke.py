#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (tracerboy_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. print the card's name and power limit (nvidia-smi);
  2. exit non-zero without a CUDA device (there is no CPU path);
  3. build the kernels (nvcc, sm_90a; one nvcc per source, all at once)
     and print the seconds;
  4. kernel vs plain twin on "shadertoy" at 1280x720: 65,536 rays (half
     primary, half random with finite and zero t_max), closest hit on
     the main BVH and any hit on the shadow BVH, within TOLERANCE; then
     both timed with CUDA events on a full 921,600-ray wave; then both
     against their twins, and timed, on rays in no order at full width:
     the 921,600 bounce and shadow rays of the traversal study's
     make_ray_sets; then the walk the two kernels run
     (traverse.octet_walk, plain PyTorch) beside the serial walk of the
     stats kernel on the primary and the unordered rays: its hits against
     the kernels', its pops, cluster tests and stack entries held beside
     the serial walk's (the boxes the octet order enters in excess);
  5. the stats kernel (closest hit with per-ray traversal counts, the
     HEATMAP view's primary wave) on the 65,536 rays, the 921,600-ray
     primary wave and the study's 921,600 bounce rays in no order: hits
     equal to the stats-free kernel's by that kernel's own tie rule (t
     equal; id, u, v equal outside ties; the two walk in different
     orders), counts equal to its twin's (each mismatching ray listed),
     no stack overflow; timed beside the stats-free kernel and the twin
     on the primary wave and on the unordered rays;
  6. the same for the opt-in paths' kernels on the scene compiled with
     the cut and binned tables (TB_CUT=1, TB_BINNED=1): emit (cut phase
     1), closest and any hit with per-ray roots (cut phase 2), selection
     and dense pairs (binned), on the 65,536 rays and on the 921,600-ray
     primary and shadow waves, each timed beside its twin; then selection
     and dense pairs on every launch of one TB_BINNED=1 render_sample(1)
     at 1280x720 (the bounce waves, the only rays the binned path gives
     them), each against its plain version and timed, with the sums; then
     the emit kernel on every launch of one TB_CUT=1 render_sample(1) at
     1280x720 (one before each closest-hit and each shadow wave), each
     equal to its plain version bit for bit and timed, with the sums, and
     on a cut table too large for its shared memory (TB_CUT_TRIS=64);
  7. the slice: Renderer("shadertoy", (1280, 720)) render_sample(1),
     render_sample(8), current_image(), which must launch both kernels
     and overflow no stack; then "shadertoy:cornell" at 512x512, 4 spp,
     on the brute-force path; then the same render_sample(1) and (8) with
     TB_CUT=1 (and a HEATMAP render_sample(1), whose primary wave must
     still take the stats kernel) and again with TB_BINNED=1, each of
     which must launch its new kernels and overflow no stack; then the
     closest-hit and any-hit launches of one more 8-sample wave of the
     default path, recorded and timed one by one (ms per bounce);
  8. the first-hit AOV slice at 1280x720: render_sample(1) and
     current_image() in every OutputType (and render_sample(8) in LIT
     and HEATMAP), a finite image in [0, 1] each; HEATMAP launches the
     stats kernel once per wave (the primary) and the stats-free kernel
     for the bounces, the other views never the stats kernel; then
     select_pixel, visualize_selected_ray_path (one wave) and
     convergence_error;
  9. the denoiser: the OIDN UNet with the committed rt_ldr_ft.npz
     weights on the slice's resolved 1280x720 image through the Reinhard
     transfer, in bfloat16 and in float32 (finite, (720, 1280, 3); ms per
     call and the bf16-vs-f32 max |d|);
 10. path parity: one renderer's 2-sample merged wave at 128x72 on the
     kernel path against the twin path, and the cut and the binned path
     against the default kernel path, with the CPU tests' tolerance;
 11. the first-generation ("v1") closest-hit kernel against its plain
     version on the 65,536 rays, the 921,600-ray primary wave and the
     study's 921,600 bounce rays in no order (within TOLERANCE, ids
     outside ties, no stack overflow, the tree's stack need inside the
     kernel's stack), timed beside the closest-hit kernel of the waves on
     the primary wave and on the unordered rays; the rays on which the two
     kernels differ (another triangle test: never a failure) are
     counted;
 12. the traversal study (tracerboy_tpu_torch.utils.bench_traverse) at
     921,600 rays on "shadertoy": primary, bounce and shadow rays, in the
     given order and sorted oct-org, through v1, the closest-hit and the
     any-hit kernel; it must launch the v1 kernel and overflow no stack;
 13. RealTime mode at 1280x720: 16 frames of render_realtime_frame_fused
     with a move_camera after the tenth, then 4 of render_realtime_frame
     with a move after the second; every image finite in [0, 1]; the
     share of pixels with a valid history, the live pixel share under the
     adaptive mask, ms per frame and its split into trace and post by
     CUDA events; both traversal kernels must launch; then
     trace_decoupled(8) and the demodulation identity at full width (a
     wave without russian roulette: albedo * D + (I - D) + E against the
     plain wave's radiance, within IDENTITY);
 14. the command-line renderer (tracerboy_tpu_torch.app.cli.main, in
     this process) at 1280x720 on a PBRT scene it writes
     (utils/demo_scene.py: a 256x256-quad height field as a binary PLY,
     three spheres, a curve, a checkerboard texture, an .hdr sky as the
     infinite light; a second file Includes it and adds a distant and a
     point light): the sky alone at 8 spp (environment NEE on by auto),
     with --env-nee on and 4 env-NEE samples, the lit scene, 8 RealTime
     frames, and --checkpoint at 4 spp resumed to 8 by a second process;
     each must write a 1280x720 RGB PNG and finite EXR radiance, launch
     kernels 1 and 2 and overflow no stack. Every launch of the first
     run is then held against its plain version and timed beside its
     bound: each any-hit launch (an env-NEE shadow wave: the scene has
     no light records) with 0 occlusion mismatches, each closest-hit
     launch within TOLERANCE, 0 overflows; then the peak memory of
     render_sample(8) with 1 and with 8 env-NEE samples;
 15. textured PBRT scenes (utils/demo_scene.py write_textured_scene:
     150,338 triangles, the height field with an sRGB albedo PNG and a
     normal map, 8,192 alpha-cut leaf quads sharing an RGBA PNG, a screen
     cut by a "texture alpha" mask, fbm and marble spheres, a glass
     sphere, the sky as the only light; textured_lit.pbrt adds a distant
     light): the load cold and from its .tbcache.npz; four CLI runs at
     1280x720, 8 spp (textured, lit, lit with --transparent-shadows, and
     textured with the leaf image's alpha forced to 1), each writing its
     PNG and finite EXR, launching kernel 1 and never kernel 2, no stack
     overflow; the canopy band of the first against the opaque run
     (CUTOUT_BAND_MARGIN); the lit run's first-wave closest-hit launches
     tagged by kind (main, refire_k, shadow_k) and the transparent run's
     shadow-BVH rounds (transparent_k), each held against its plain
     version on at most CHECK_LANES live lanes (TOLERANCE, dead
     lanes miss, 0 overflows) and timed beside its bound;
     render_sample(8) through the Renderer and its peak memory; path
     parity on the textured scene at 128x72; a line of seconds a phase;
 16. instanced PBRT scenes (utils/demo_scene.py write_forest_scene:
     a height field, 64 trees (16,128 triangles, TGA texture) in clusters
     of overlapping instance boxes, 24 rocks (6,080, BMP texture) and an
     emissive panel, instanced: 1,178,114 triangles flattened, so the
     compiler keeps a TLAS): CLI runs at 1280x720, one 4-sample wave, of
     forest.pbrt (which must compile to a TLAS), of its --export-pbf
     .pbf (read back flat; its radiance against the TLAS render's under
     TLAS_PARITY), and of the tree alone as .glb and .obj; every
     closest-hit launch of the TLAS run tagged (main, and the BLAS
     launches by pass, round and object), held against the plain
     version on at most CHECK_LANES live lanes and timed beside its
     bound; s a sample, Mrays/s, peak memory and geometry bytes of the
     TLAS and flat renders; a line of seconds a phase;
 17. a heterogeneous volume (volume_phase): the CLI on lit.pbrt at
     1280x720, --env-nee on, --spp 4 (one merged wave of 3,686,400
     lanes), --volume a 256^3 cloud over the height field written as a
     .vdb by the port's write_vdb and read back bit for bit; the image
     finite in [0, 1]; s a sample, Mrays/s, peak memory, the walk's steps
     per bounce, the device-time shares of the walk and the shadow
     marches, and the same command without --volume timed as the
     control; every closest-hit launch (the walk's segment ends) and
     every any-hit launch (shadow rays from surface and volume-scatter
     vertices, and the env-NEE shadow waves) held against its plain
     version on at most CHECK_LANES live lanes, timed beside its bound:
     0 id mismatches outside ties, 0 occlusion mismatches, 0 overflows;
 18. the estimators on "shadertoy" at 1280x720 (estimators_phase): the
     tent splat (its border loss within 5% of the expected), the
     adaptive burst (counts sum to the budget; its residual wave's
     closest-hit launches held against the plain version as above),
     adaptive sampling under the mask, split planes that partition the
     total (an early share strictly inside (0, 1), bit-equal planes at
     split_early = max_bounces - 1), and a live material edit; s a
     sample of each;
 19. animated geometry (animation_phase), reusing the CLI phase's
     env.pbrt and the instanced phase's forest renderer: on "shadertoy"
     at 1280x720 update_geometry with the load-time vertices, rebuilt on
     the card (accel/bvh_device.py; no host builder may run), validate_bvh
     of the card's build with 0 violations, every closest- and any-hit
     launch of one render_sample(1) held against its plain version on at
     most CHECK_LANES live lanes (0 id mismatches outside ties, 0
     occlusion mismatches, 0 overflows), render_sample(8) against the
     host-built tables' (PARITY), a HEATMAP render through the stats
     kernel, the launches of one build (torch.profiler) and the rebuild's
     split (main build, shadow build, packs, update_geometry, the host
     stack_need read); 8 RealTime frames of a mesh deformed by a sine
     field before each, every image finite in [0, 1], ms a frame against
     static frames; env.pbrt's rebuild timed; update_object_geometry on
     the forest's tree, timed, and the BLAS launches of one render after
     it held against the plain version; app/viewer.py's turntable (three
     1280x720 PNGs of env.pbrt) and ViewerController on the card (w, m,
     o, p, a click, ] on the clicked material);
 20. the ML extras (ml_phase): ml/finetune.py's make_dataset on
     "shadertoy" at 512x320 (4 orbit views, a 64-spp target and two
     8-spp inputs each; every closest-hit and any-hit launch of its
     renders held against the plain version on at most CHECK_LANES live
     lanes: TOLERANCE, each id mismatch outside ties one whose box the
     kernel culled by its slab arithmetic (the box's entry t not below
     the kernel's hit), 0 occlusion mismatches, dead lanes miss, 0
     overflows; s a sample); finetune from the committed
     rt_ldr_ft.npz, 200 Adam steps of batch 4 at full frame (every loss
     and the holdout L2 before and after finite; ms a step by CUDA-event
     spans, peak memory), its .npz read back by load_params_npz and
     denoising the held-out frame to a finite image; fsr_upscale and
     upscale2x (a seeded random weights.bin) of a 1280x720 render to
     2560x1440, timed (FSR NaN exactly on the reference's 0/0 plateaus,
     ROADMAP.md Queue 3, in [0, 1] elsewhere); the CLI's --upscale fsr
     on lit.pbrt at 640x360, a 1280x720 PNG;
 21. tile and sample sharding (sharding_phase) on "shadertoy" at
     1280x720: Renderer(shard="tiles") render_sample(1) twice and
     shard="spp" render_sample(2) on the default mesh (every card), then
     on the mesh ["cuda:0", "cuda:0"] tiles at 1280x720 (pad 0) and
     1279x719 (pad 1) and spp render_sample(4) (two merged waves): each
     tiled accumulator equal (torch.equal) to an unsharded renderer's
     after as many render_sample(1) calls, each spp accumulator to the
     unsharded sum of the same waves in mesh order; every kernel-1 and
     kernel-2 launch of those runs held against its plain version as in
     20; make_mesh of one card more than the machine has raising; the
     CLI with --shard spp --devices 1 on env.pbrt at 640x360; ms a
     sample of the unsharded, tiled and spp runs (host time);
 22. the port's JPEG decoder (jpeg_phase): every fixture of
     tests/data/jpeg (PIL's saves; arithmetic-coded sequential and
     progressive files with DAC conditioning and restarts; lossless files
     of every predictor; progressive files cut short, which libjpeg
     block-smooths) decoded to the sha256 of PIL's array in its
     manifest; the 1024x1024 albedo's decode timed on the host, as PIL's
     progressive 4:2:0 file and as an arithmetic-coded progressive 4:2:0
     one; the CLI on textured_lit.pbrt with each as its albedo, 1280x720,
     2 spp, a finite image, its closest-hit launches held against the
     plain version by kind (main, re-fire, shadow-BVH; the second run's
     kinds prefixed arith_);
 23. the port's DDS reader and TGA/BMP variant readers (dds_phase):
     every fixture of tests/data/dds (DDS of every format PIL reads, the
     TGA and BMP variants) decoded to the sha256 of PIL's array in its
     manifest; the 512x512 BC7 albedo's decode timed on the host; the CLI
     on textured_lit.pbrt with that BC7 albedo and a DXT1 leaf whose
     cutouts are BC1's 1-bit alpha, 1280x720, 2 spp, as in 22;
 24. the port's TIFF, GIF and ICO readers (tiff_phase): every fixture
     of tests/data/tiff (TIFF layouts, JPEG, YCbCr, CIELab, CCITT,
     Zstandard, LZMA, ThunderScan, GIFs, ICOs, the TIFF scenes'
     textures) decoded to the sha256 of PIL's array in its manifest; a
     1024x1024 RGB TIFF written with LZW and Predictor 2, and with
     Deflate, read back equal and its decode timed on the host, and the
     committed GDAL-style 1024x1024 albedos (JPEG YCbCr 4:2:0 tiles,
     Zstandard) timed the same way; the CLI on textured_lit.pbrt with the
     JPEG-YCbCr TIFF albedo and the RGBA Zstandard TIFF leaf whose alpha
     makes the cutouts, as in 22;
 25. the port's WebP, QOI, PNM and PSD readers (webp_phase): every
     fixture of tests/data/webp (WebP layouts, animations, QOI, PNM, PSD
     with Lab among them, the WebP scene's textures) decoded to the
     sha256 of PIL's array in its manifest; the 1024x1024 albedo's host decode as a lossy WebP, a
     lossless WebP and a QOI written by core/qoi.write_qoi (read back
     equal); the CLI on textured_lit.pbrt with the lossy WebP albedo and
     the VP8X + ALPH WebP leaf whose alpha makes the cutouts, as in 22;
 26. the port's JPEG 2000 reader (j2k_phase): every fixture of
     tests/data/j2k (PIL-written codestreams and JP2 files of every save
     option, the box and marker variants, rewritten packets and
     code-block styles, the scene's textures) decoded to the sha256 of
     PIL's array in its manifest; the 1024x1024 albedo's host decode as
     a lossless 5/3 JP2 (read back equal) and as a 9/7 JP2; the CLI on
     textured_lit.pbrt with the 9/7 JP2 albedo and the RGBA raw
     codestream leaf whose lossless alpha makes the cutouts, as in 22;
 27. the port's AVIF reader (avif_phase): every fixture of
     tests/data/avif (Pillow's AVIF of every save option with aom's
     in-loop filters off, aom's tool switches, the box rewrites, the
     scene's textures; Pillow's default saves and each in-loop filter on:
     deblocking, CDEF, Wiener, self-guided and switchable restoration)
     decoded to the sha256 of PIL's array in its manifest; the 1024x1024
     albedo's host decode as a 4:2:0 AVIF, as a 4:4:4 AVIF coded
     lossless (the Walsh-Hadamard path), as Pillow's default save (the
     deblocking filter on), as a plain Image.save (intra block copy) and
     as a default save with film grain; the CLI on textured_lit.pbrt with
     the default-save albedo and the default-save RGBA leaf whose
     deblocked alpha item makes the cutouts, as in 22, again with the
     plain-save albedo and the RGBA leaf saved with film grain, on its
     alpha item too, and again with the albedo as a 3x3 grid image
     through libavif's float routines and the leaf as colour and alpha
     grids (YCgCo), whose stitched alpha makes the cutouts; the grid
     albedo's and an FCC (float-matrix) albedo's host decodes; and part
     1 of the AVIF writer (avif_rewrites): every fixture's AV1 payloads
     decoded to their decision records and written back by
     csrc/av1_encode.cpp equal to the fixtures' bytes, the 1024x1024
     default-save albedo's rewrite timed on the host;
 28. the port's readers of PIL's small texture formats (small_phase):
     every fixture of tests/data/small (SGI, PCX, DCX, CUR, DIB, FTEX, BLP
     and ICNS of every layout the readers take) and tests/data/small2 (IM,
     Sun, XBM, XPM, MSP, PIXAR, GBR, IMT, McIdas, SPIDER and XVThumb)
     decoded to the sha256 of PIL's array in its manifest; the 1024x1024
     albedo written by utils/demo_scene.write_small_textures as an RLE
     SGI, a PCX, a DXT1 BLP2, a DXT1 FTEX and an ICNS (an ic10 PNG
     entry), and by write_small2_textures as a Sun RLE, a raw Sun, a
     planar IM and a 256-colour XPM, and the leaf as a DXT5 BLP2 and an
     RGBA IM, each file's sha256 and decode equal to the manifest's
     (PIL's) and each decode timed on the host; part 3: every fixture of
     tests/data/small3 (FITS, FLI, IPTC, CMYK and YCCK JPEGs, BLP1s of
     them), the albedo written by write_small3_textures as an FLC, a
     PhotoCD, raw and gzip FITS and a raw IPTC image, and the committed
     BLP1 of the albedo as a CMYK JPEG, checked and timed the same way;
     the CLI on textured_lit.pbrt with the RLE SGI albedo and the DXT5
     BLP2 leaf whose alpha makes the cutouts, as in 22, again with the
     Sun RLE albedo and the RGBA IM leaf, and again with the BLP1-CMYK
     albedo and the PNG leaf;
 29. the port's image writer (writers_phase: core/image_save.py behind
     image_io.write_png, JPEG's pixel stages and entropy coder in
     csrc/jpeg_encode.cpp, the JPEG 2000 tile coder in
     csrc/j2k_encode.cpp, GIF's palettes and LZW in csrc/gif_encode.cpp,
     ICO's and ICNS's resampler in csrc/resample.cpp, libwebp's lossy
     VP8 encoder in csrc/webp_encode.cpp and its ALPH plane's lossless
     VP8L encoder in csrc/webp_alpha_encode.cpp):
     every committed input of tests/data/write in L, LA, RGB and RGBA
     written under every extension PIL saves, each file's sha256 equal to
     the manifest's (PIL's; a PNG by its inflated stream and other chunks
     where zlib differs, an ICO or ICNS by its container and embedded
     PNGs likewise; a PDF with its two dates masked), PIL's error class
     where PIL refuses, ROADMAP item 25 where the encoder is not ported
     yet (AVIF only; every WebP by its bytes); the opaque images of
     tests/data/write/webp_extra.json (up to 1280x720) and the images
     with alpha of webp_alpha.json (1x1 to 16383x1 and 1280x720) made
     from their seeds and written as WebP, each equal to PIL's; the CLI on
     "shadertoy" at 1280x720, 2 spp, --out w.jpg --capture-every 2: two
     byte-identical JPEG files, read back at 1280x720; at 1 spp --out
     w.icns, read back at 1024x1024; at 1 spp --out w.webp, read back at
     1280x720 (its PSNR printed), and its image with a soft alpha plane
     written as .webp (VP8X, ALPH, VP8) and read back, the alpha exact
     and the opaque pixels' PSNR at least RGBA_WEBP_PSNR_DB; each run's
     closest- and any-hit launches held against the plain version on at
     most CHECK_LANES live lanes each; write_png of its image as .jpg,
     .png, .bmp, .tif, .jp2, .gif, .pdf, .eps, .ico, .icns and .webp, and
     of the RGBA image as .webp, timed on the host, the .jp2, .ico, .icns
     and both .webp read back;
 30. a JSON line of the seven kernels (launches from the run of the path
     each serves, error statistics, ms against plain_ms, the bound the
     card could reach on the same inputs and what sets it; kernels 1 and
     2 also by the volume run's, the adaptive residual wave's, the
     animation phase's, the ML dataset's, the sharded runs', the JPEG,
     DDS, TIFF, WebP, JPEG 2000, AVIF and small-format scenes' and the
     writers phase's launches), then the result line {"ok": true,
     "device": {...}} last.

Imports nothing of JAX or the JAX package (the UNet weights and the JPEG
and DDS fixtures are data files read by path).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

N_COMPARE = 65_536
FULL_WAVE = (1280, 720)
CORNELL_FILM = (512, 512)
PARITY_FILM = (128, 72)
# Kernel vs twin: both evaluate the same float32 expressions in the same
# order (the kernels are built with --fmad=false), so results agree
# exactly but for rays where rounding in a box test lets one side skip a
# box the other enters, and for exact ties in t (the kernel keeps the
# first triangle found, the twin the lowest id). u and v of the same
# triangle come from the same expressions, hence uv_abs 1e-6.
# Emit: a set mismatch needs a slab test that rounds differently at a
# shared face. Selection: the slot sets differ only where clusters tie at
# the K-th entry t (ties are counted apart); the dropped bound must hold
# on every ray. Dense: the same expressions in the same order, hence
# t_rel and uv_abs 1e-6.
TOLERANCE = dict(hit_mismatch_frac=1e-4, t_rel=1e-6, uv_abs=1e-6,
                 id_mismatch_frac=1e-4, occ_mismatch_frac=1e-4,
                 emit_set_mismatch_frac=1e-4,
                 select_set_mismatch_frac=1e-4,
                 dropped_violations=0, dense_t_rel=1e-6,
                 dense_uv_abs=1e-6)
# The textured phase holds each recorded launch against its plain version
# on a seeded draw of at most this many of its live lanes: the plain
# version walks each ray on its own, so a subset is checked exactly.
CHECK_LANES = 16_384
# The least PSNR (dB) of the opaque pixels of the writers phase's RGBA
# .webp (the 1-spp render with a soft alpha ellipse) read back: the opaque
# file of the same image reads back at 32.21 dB on an NVIDIA H100 80GB
# HBM3 at 700 W.
RGBA_WEBP_PSNR_DB = 28.0
OPT_IN = ("TB_CUT", "TB_BINNED", "TB_CUT_K", "TB_CUT_TRIS")
# Path parity: the CPU tests' bound between the port and the JAX package.
PARITY = dict(pixel_atol=1e-3, pixel_frac=0.99, mean_rel=1e-4)
# Stats kernel: it keeps the serial walk, the stats-free kernel walks in
# another order, so the two are held together as a kernel and its twin
# are (TOLERANCE; ids outside ties); the stats twin repeats the stats
# kernel's walk, so the counts differ only where a slab test rounds
# otherwise.
STATS_TOLERANCE = dict(count_mismatch_frac=1e-4, overflows=0)
UNET_WEIGHTS = (Path(__file__).resolve().parent / "tracerboy_tpu" / "ml"
                / "weights" / "rt_ldr_ft.npz")
# The bound of a kernel: the larger of its bytes (each ray input read
# once, each table row these rays need read once, each output written
# once) over the H100 SXM's 3.35 TB/s and its float32 operations over 67
# TFLOP/s (no tensor cores): bound, walk_ops, select_bound, dense_bound,
# emit_bound and slot_path_rows of
# tracerboy_tpu_torch/utils/bench_traverse.py, which give the rates and
# the operations per step. The rows: those the walk reads (node rows it
# expands, cluster rows it tests; traverse.walk_footprint and
# bench_traverse.emit_walk), for the selection the coarse rows on the
# paths from the root to its slots, for dense pairs the clusters of its
# pairs.
# The demodulation identity on a wave without russian roulette: the two
# traces take the same paths, so the composite differs from the plain
# radiance by float32 rounding of the split sums only.
IDENTITY = dict(pixel_atol=1e-3, pixel_frac=0.999)
STUDY_ARGS = ["--scene", "shadertoy", "--rays", str(1280 * 720), "--sets",
              "primary,bounce,shadow", "--sort", "none,oct-org",
              "--variants", "v1,v2,v2any", "--runs", "10", "--stats"]
RT_FUSED_FRAMES, RT_MOVE_AFTER, RT_PLAIN_FRAMES = 16, 10, 4
RT_MOVE = dict(forward=0.15, strafe=0.05, yaw=0.02, pitch=-0.01)


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except FileNotFoundError:
        fail("nvidia-smi not found: no NVIDIA driver on this machine")
    if res.returncode != 0:
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip()


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed_once(fn):
    """(fn(), its ms by CUDA events): one call, no warm-up."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def row_bytes(table, rows) -> int:
    """Bytes of the rows of table marked in the bool mask rows."""
    return int(rows.sum()) * table[0].numel() * table.element_size()


def bound_keys(n_bytes, ops) -> dict:
    """The kernels line's bound keys; no single PyTorch call computes a
    BVH traversal, so library_ms is null."""
    from tracerboy_tpu_torch.utils.bench_traverse import bound

    ms, by = bound(n_bytes, ops)
    return dict(bound_ms=ms, bound_by=by, bytes=int(n_bytes), ops=float(ops),
                library_ms=None)


def check_image(name, img):
    shape = (FULL_WAVE[1], FULL_WAVE[0], 3)
    if img.shape != shape:
        fail(f"{name}: image shape {img.shape}, expected {shape}")
    if not (np.isfinite(img).all() and img.min() >= 0 and img.max() <= 1):
        fail(f"{name}: image is not finite within [0, 1]")


def primary_rays(scene, width, height, pixel_ids, rng):
    """Camera rays through random jitter inside the given pixels."""
    import torch

    from tracerboy_tpu_torch.core import vec3 as v3
    from tracerboy_tpu_torch.trace.camera import generate_primary_rays_soa

    dev = pixel_ids.device
    n = pixel_ids.shape[0]
    ju = torch.from_numpy(rng.random(n, dtype=np.float32)).to(dev)
    jv = torch.from_numpy(rng.random(n, dtype=np.float32)).to(dev)
    o, d = generate_primary_rays_soa(scene["camera"], width, height,
                                     pixel_ids, ju, jv)
    return v3.to_rows(o).contiguous(), v3.to_rows(d).contiguous()


def compare_rays(scene, rng):
    """N_COMPARE rays: half primary, half random inside the scene bounds,
    with t_max finite, infinite (1e30) or 0 (dead)."""
    import torch

    dev = scene["pk_nodes"].device
    w, h = FULL_WAVE
    half = N_COMPARE // 2
    pix = torch.from_numpy(rng.integers(0, w * h, half)).to(dev)
    o1, d1 = primary_rays(scene, w, h, pix, rng)
    lo = scene["world_lo"].cpu().numpy()
    hi = scene["world_hi"].cpu().numpy()
    o2 = lo + (hi - lo) * rng.random((half, 3))
    d2 = rng.normal(size=(half, 3))
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    tm = np.full(N_COMPARE, 1e30)
    kind = rng.random(N_COMPARE)
    tm[kind < 0.3] = rng.random(int((kind < 0.3).sum())) * float(
        np.linalg.norm(hi - lo))
    tm[kind > 0.9] = 0.0
    o = torch.cat([o1, torch.from_numpy(o2.astype(np.float32)).to(dev)])
    d = torch.cat([d1, torch.from_numpy(d2.astype(np.float32)).to(dev)])
    return (o.contiguous(), d.contiguous(),
            torch.from_numpy(tm.astype(np.float32)).to(dev))


def _max_abs(a, b):
    return float(np.abs(a - b).max()) if a.size else 0.0


def outside_tie_records(o, d, nodes, tris_bw, k, p, rays):
    """For the given rays (both sides hit, ids differ, not a tie): both
    sides' t and id, and the entry t (t_near) of each side's cluster box
    by the kernels' slab arithmetic. The kernel culls a box whose t_near
    is not below its best hit so far, the twin only by t_max."""
    import torch

    from tracerboy_tpu_torch.trace import traverse

    sel = torch.from_numpy(rays).to(o.device)
    lo, hi = traverse.cluster_boxes(nodes, tris_bw.shape[0])
    inv = 1.0 / traverse.fix_dir(d[sel])
    rec = dict(t_kernel=k[0][sel], t_twin=p[0][sel], tri_kernel=k[1][sel],
               tri_twin=p[1][sel])
    for side in ("kernel", "twin"):
        cl = torch.div(rec[f"tri_{side}"].long(), traverse.LEAF,
                       rounding_mode="floor")
        rec[f"box_t_near_{side}"] = traverse.box_entry(o[sel], inv, lo[cl],
                                                       hi[cl])[0]
    cols = {key: val.cpu().tolist() for key, val in rec.items()}
    return [{key: cols[key][i] for key in cols} for i in range(len(rays))]


def check_closest(o, d, tables, k, p, hit_attributes=None):
    """Kernel outputs k against twin outputs p, each (t, tri, u, v), on
    tables (nodes, triangle rows). Where both hit the same id, t, u and v
    are compared; where the ids differ, the kernel's triangle is re-tested
    (hit_attributes, by default traverse.hit_attributes on Baldwin-Weber
    rows): it is a tie if it is hit at the twin's t, and then its u, v are
    compared with the re-test's. Up to 4 id mismatches outside ties are
    listed with their box entry t."""
    import torch

    from tracerboy_tpu_torch.trace import traverse

    nodes, tris_bw = tables
    hit_attributes = hit_attributes or traverse.hit_attributes
    t_k, tri_k, u_k, v_k = (x.cpu().numpy() for x in k)
    t_p, tri_p, u_p, v_p = (x.cpu().numpy() for x in p)
    hit_k, hit_p = tri_k >= 0, tri_p >= 0
    both = hit_k & hit_p
    same = both & (tri_k == tri_p)
    diff = np.flatnonzero(both & (tri_k != tri_p))
    sel = torch.from_numpy(diff).to(o.device)
    t_r, u_r, v_r = (x.cpu().numpy() for x in hit_attributes(
        o[sel], d[sel], k[1][sel], tris_bw))
    tie = (t_r == t_k[diff]) & (t_k[diff] == t_p[diff])
    rel = np.abs(t_k[both] - t_p[both]) / np.maximum(np.abs(t_p[both]),
                                                     1e-30)
    uv_err = max(_max_abs(u_k[same], u_p[same]),
                 _max_abs(v_k[same], v_p[same]),
                 _max_abs(u_k[diff], u_r), _max_abs(v_k[diff], v_r))
    stats = dict(
        rays=int(t_k.shape[0]), hits=int(hit_k.sum()),
        hit_mismatch=int((hit_k != hit_p).sum()),
        max_rel_t_err=float(rel.max()) if rel.size else 0.0,
        max_abs_t_err=_max_abs(t_k[both], t_p[both]),
        max_abs_uv_err=uv_err,
        ties=int(tie.sum()),
        id_mismatch_outside_ties=int((~tie).sum()),
    )
    stats["max_abs_err"] = max(stats["max_abs_t_err"], uv_err)
    if stats["id_mismatch_outside_ties"]:
        stats["outside_ties"] = outside_tie_records(
            o, d, nodes, tris_bw, k, p, diff[~tie][:4])
    n = t_k.shape[0]
    ok = (stats["hit_mismatch"] <= TOLERANCE["hit_mismatch_frac"] * n
          and stats["max_rel_t_err"] <= TOLERANCE["t_rel"]
          and uv_err <= TOLERANCE["uv_abs"]
          and stats["id_mismatch_outside_ties"]
          <= TOLERANCE["id_mismatch_frac"] * n)
    return ok, stats


def check_anyhit(k, p):
    occ_k, occ_p = k.cpu().numpy(), p.cpu().numpy()
    mism = int((occ_k != occ_p).sum())
    # max_abs_err: |occlusion difference| (0 or 1) over the rays.
    stats = dict(rays=int(occ_k.shape[0]), occluded=int(occ_k.sum()),
                 occ_mismatch=mism, max_abs_err=float(mism > 0))
    return mism <= TOLERANCE["occ_mismatch_frac"] * occ_k.shape[0], stats


def shadow_rays(scene, o, d, t, tri, rng):
    """Shadow rays from the primary hits toward random points of the
    scene's light triangles (misses become dead lanes)."""
    import torch

    lights = scene["lights"]
    n = o.shape[0]
    L = lights["p0"].shape[0]
    idx = torch.from_numpy(rng.integers(0, L, n)).to(o.device)
    b = torch.from_numpy(rng.random((n, 2), dtype=np.float32)).to(o.device)
    flip = b.sum(1, keepdim=True) > 1
    b = torch.where(flip, 1 - b, b)
    p = (lights["p0"][idx] * (1 - b.sum(1, keepdim=True))
         + lights["p1"][idx] * b[:, :1] + lights["p2"][idx] * b[:, 1:])
    hit = tri >= 0
    org = o + d * torch.where(hit, t * 0.999, 0.0)[:, None]
    to = p - org
    dist = torch.linalg.norm(to, dim=1)
    sd = to / dist[:, None]
    tm = torch.where(hit, dist * 0.999, 0.0)
    return org.contiguous(), sd.contiguous(), tm.contiguous()


def set_opt_in(**env):
    """Set the opt-in path variables to env; unset the others. The port
    reads them when a scene is compiled and in Renderer.wave_config."""
    for key in OPT_IN:
        os.environ.pop(key, None)
    os.environ.update(env)


def build_kernels():
    """Build the four kernel libraries at once, one nvcc each."""
    from tracerboy_tpu_torch.trace import binned, cut, traverse, traverse_v1

    modules = (traverse, cut, binned, traverse_v1)
    with ThreadPoolExecutor(len(modules)) as ex:
        for f in [ex.submit(m.build_kernels) for m in modules]:
            f.result()


def study_rays(cs, device):
    """The 921,600 bounce and shadow rays of the traversal study
    (bench_traverse.make_ray_sets, default_rng(7)): surface points in no
    order, toward random directions and toward one light."""
    import torch

    from tracerboy_tpu_torch.utils.bench_traverse import make_ray_sets

    w, h = FULL_WAVE
    sets = make_ray_sets(cs, w * h, np.random.default_rng(7))
    return {name: tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                        for x in sets[name])
            for name in ("bounce", "shadow")}


def unordered_phase(main_t, shadow_t, rays):
    """Closest hit on the study's bounce rays and any hit on its shadow
    rays, 921,600 each in no order, against the twins and timed. Returns
    (closest statistics, any-hit statistics, times)."""
    from tracerboy_tpu_torch.trace import kernels, traverse

    kernels.reset_counters()
    bo, so = rays["bounce"], rays["shadow"]
    ok_c, st_c = check_closest(
        bo[0], bo[1], main_t, traverse.closest_hit(*bo, *main_t),
        traverse.closest_hit_plain(*bo, *main_t))
    ok_a, st_a = check_anyhit(traverse.any_hit(*so, *shadow_t),
                              traverse.anyhit_plain(*so, *shadow_t))
    overflows = kernels.stack_overflows()
    times = dict(
        closest_ms=cuda_ms(lambda: traverse.closest_hit(*bo, *main_t), 20),
        closest_plain_ms=cuda_ms(lambda: traverse.closest_hit_plain(
            *bo, *main_t), 1, warmup=0),
        anyhit_ms=cuda_ms(lambda: traverse.any_hit(*so, *shadow_t), 20),
        anyhit_plain_ms=cuda_ms(lambda: traverse.anyhit_plain(
            *so, *shadow_t), 1, warmup=0),
        stack_overflows=overflows)
    print("unordered closest kernel vs twin:", json.dumps(st_c))
    print("unordered anyhit kernel vs twin:", json.dumps(st_a))
    print("timing 921,600 unordered rays:", json.dumps(times))
    if not (ok_c and ok_a) or overflows:
        fail(f"kernel disagrees with its twin on unordered rays beyond "
             f"{TOLERANCE}, or overflowed a stack")
    return st_c, st_a, times


def walks_phase(sets):
    """The walk the closest-hit and any-hit kernels run (octet_walk, plain
    PyTorch) on each (label, rays, tables, any_hit) of sets: its hits
    against the kernel's (the same walk: t, id, u, v or the occlusion,
    within TOLERANCE), and its pops, cluster tests and stack entries held
    beside the serial walk's (walk_footprint)."""
    import torch

    from tracerboy_tpu_torch.trace import traverse

    ok_all = True
    for label, (o, d, tm), tables, any_hit in sets:
        w = traverse.octet_walk(o, d, tm, *tables, any_hit=any_hit)
        serial = traverse.walk_footprint(o, d, tm, *tables, any_hit=any_hit)
        if any_hit:
            k = traverse.any_hit(o, d, tm, *tables)
            differ = int((k != (w[1] >= 0)).sum())
            ok = differ <= TOLERANCE["occ_mismatch_frac"] * o.shape[0]
        else:
            k = traverse.closest_hit(o, d, tm, *tables)
            differ = int(((k[0] != w[0]) | (k[1] != w[1]) | (k[2] != w[2])
                          | (k[3] != w[3])).sum())
            ok = differ <= TOLERANCE["hit_mismatch_frac"] * o.shape[0]
        live = int((tm > 0).sum())
        st = dict(
            rays=int(o.shape[0]), live=live,
            rays_differing_from_kernel=differ,
            octet=dict(pops=int(w[4].sum()), clusters=int(w[5].sum()),
                       max_held=int(w[6].max())),
            serial=dict(pops=int(serial[2].sum()),
                        clusters=int(serial[3].sum())),
            stack_need=traverse.stack_need(tables[0]))
        st["excess_pops_share"] = (st["octet"]["pops"]
                                   / max(st["serial"]["pops"], 1) - 1)
        st["excess_clusters_share"] = (st["octet"]["clusters"]
                                       / max(st["serial"]["clusters"], 1) - 1)
        print(f"octet walk beside the serial walk, {label}:", json.dumps(st))
        ok_all &= ok and st["octet"]["max_held"] <= st["stack_need"]
        del w, serial, k
        torch.cuda.empty_cache()
    if not ok_all:
        fail("the octet walk disagrees with the kernels, or holds more "
             "stack entries than stack_need allows")


def wave_bounce_phase():
    """The closest-hit and any-hit launches of one 8-sample wave of the
    default path at 1280x720 (7,372,800 lanes), recorded by
    bench_traverse.record_wave_rays and timed one by one: ms per bounce
    and the sums."""
    import torch

    from tracerboy_tpu_torch.trace import traverse
    from tracerboy_tpu_torch.utils.bench_traverse import record_wave_rays

    set_opt_in()
    calls = record_wave_rays("shadertoy", FULL_WAVE, 8, torch.device("cuda"))
    rows = []
    for kind, o, d, tm, nodes, tris in calls:
        fn = traverse.closest_hit if kind == "closest" else traverse.any_hit
        rows.append(dict(kind=kind, lanes=int(o.shape[0]),
                         live=int((tm > 0).sum()),
                         ms=cuda_ms(lambda: fn(o, d, tm, nodes, tris), 5)))
    res = dict(launches=rows,
               closest_ms=sum(r["ms"] for r in rows if r["kind"] == "closest"),
               anyhit_ms=sum(r["ms"] for r in rows if r["kind"] == "shadow"))
    print("traversal per bounce of one 8-spp wave:", json.dumps(res))
    if not rows or not all(np.isfinite(r["ms"]) and r["ms"] > 0 for r in rows):
        fail(f"wave bounce times malformed: {res}")
    return res


def stats_phase(tables, sets, timed):
    """The stats kernel on each (label, (o, d, t_max)) of sets against
    the stats-free kernel (another walk order: compared as a kernel with
    its twin, ids outside ties, within TOLERANCE) and its twin (the hits
    and the counts, each mismatching ray listed), with no stack overflow;
    on each set named in timed (a dict label: key prefix) the kernels are
    timed beside the twin's comparison call ({prefix}_ms,
    {prefix}_free_ms). Returns (statistics by label, times)."""
    import torch

    from tracerboy_tpu_torch.trace import kernels, traverse

    kernels.reset_counters()
    stats, times, ok_all = {}, {}, True
    for label, (o, d, tm) in sets:
        k = traverse.closest_hit_stats(o, d, tm, *tables)
        free = traverse.closest_hit(o, d, tm, *tables)
        p, plain_ms = timed_once(lambda: traverse.closest_hit_stats_plain(
            o, d, tm, *tables))
        n = o.shape[0]
        both = (k[1] >= 0) & (p[1] >= 0)
        cnt_k, cnt_p = torch.stack(k[4:], 1), torch.stack(p[4:], 1)
        mism = (cnt_k != cnt_p).any(1).nonzero(as_tuple=True)[0]
        errs = [(k[j][both] - p[j][both]).abs() for j in (0, 2, 3)]
        errs.append((cnt_k - cnt_p).abs().to(torch.float32))
        st = dict(
            rays=n, live=int((tm > 0).sum()), hits=int((k[1] >= 0).sum()),
            pops=int(k[4].sum()), clusters=int(k[5].sum()),
            max_pops=int(k[4].max()), max_clusters=int(k[5].max()),
            hits_equal_twin=all(torch.equal(a, b)
                                for a, b in zip(k[:4], p[:4])),
            count_mismatch=int(mism.numel()),
            max_abs_err=max(float(e.max()) if e.numel() else 0.0
                            for e in errs))
        if mism.numel():
            rows = torch.cat([mism[:200, None].to(torch.int32),
                              cnt_k[mism[:200]], cnt_p[mism[:200]]], 1)
            st["mismatches"] = [
                dict(ray=r[0], pops_kernel=r[1], clusters_kernel=r[2],
                     pops_twin=r[3], clusters_twin=r[4])
                for r in rows.cpu().tolist()]
        ok_free, st["vs_stats_free"] = check_closest(o, d, tables, free,
                                                     k[:4])
        stats[label] = st
        print(f"stats kernel vs twin, {label}:", json.dumps(st))
        ok_all &= (ok_free and st["count_mismatch"]
                   <= STATS_TOLERANCE["count_mismatch_frac"] * n)
        times[f"{label}_plain_ms"] = plain_ms
    overflows = kernels.stack_overflows()
    for label, (o, d, tm) in sets:
        if label not in timed:
            continue
        times[f"{timed[label]}_ms"] = cuda_ms(
            lambda: traverse.closest_hit_stats(o, d, tm, *tables), 20)
        times[f"{timed[label]}_free_ms"] = cuda_ms(
            lambda: traverse.closest_hit(o, d, tm, *tables), 20)
    times["stack_overflows"] = overflows
    print("timing stats kernel:", json.dumps(times))
    if overflows > STATS_TOLERANCE["overflows"]:
        fail(f"stats phase: {overflows} traversal stack overflows")
    if not ok_all:
        fail(f"the stats kernel disagrees beyond {STATS_TOLERANCE}")
    return stats, times


def check_emit(k, p):
    """Emit kernel ids against the twin's: rays whose sorted subtree sets
    differ, and rays whose slot order differs."""
    n = k.shape[0]
    set_mism = int((k.sort(1).values != p.sort(1).values).any(1).sum())
    # max_abs_err: 1 if any ray's subtree set differs, else 0.
    stats = dict(rays=n, with_emits=int((k >= 0).any(1).sum()),
                 set_mismatch=set_mism,
                 order_mismatch=int((k != p).any(1).sum()),
                 max_abs_err=float(set_mism > 0))
    return set_mism <= TOLERANCE["emit_set_mismatch_frac"] * n, stats


def outside_min_entry(o, d, tm, nodes, slot_c, chunk=1 << 15):
    """Per ray, the least entry t of a cluster it enters outside its
    slots, by an exhaustive box test (1e30 if none)."""
    import torch

    from tracerboy_tpu_torch.trace import binned, traverse

    lo, hi = traverse.cluster_boxes(nodes, binned.n_clusters(nodes))
    out = torch.empty(o.shape[0], dtype=torch.float32, device=o.device)
    for s in range(0, o.shape[0], chunk):
        sl = slice(s, s + chunk)
        entry = binned.cluster_entries(o[sl], d[sl], tm[sl], lo, hi)
        sc = slot_c[sl]
        rows = torch.arange(sc.shape[0], device=o.device)[:, None]
        keep = sc >= 0
        entry[rows.expand_as(sc)[keep], sc[keep].long()] = 1e30
        out[sl] = entry.min(1).values
    return out


def check_select(o, d, tm, nodes, k, p):
    """Selection kernel against the twin: slot sets (apart from ties at
    the K-th entry t, where the set is not unique), the entry t of the
    slots where the sets agree, and the dropped bound on every ray:
    K-th nearest entry t <= dropped <= every entered cluster outside."""
    import torch

    st_k, sc_k, dr_k = k
    st_p, sc_p, dr_p = p
    full_p = (sc_p >= 0).all(1)
    tie = full_p & (dr_p == torch.where(full_p, st_p.max(1).values, 1e30))
    differ = (sc_k.sort(1).values != sc_p.sort(1).values).any(1)
    kth_k = torch.where((sc_k >= 0).all(1), st_k.max(1).values, 1e30)
    outside = outside_min_entry(o, d, tm, nodes, sc_k)
    violations = int(((kth_k > dr_k) | (dr_k > outside)).sum())
    err = (st_k.gather(1, sc_k.argsort(1))
           - st_p.gather(1, sc_p.argsort(1)))[~differ].abs()
    n = o.shape[0]
    stats = dict(rays=n, slots_filled=int((sc_k >= 0).sum()),
                 set_mismatch=int((differ & ~tie).sum()),
                 ties=int((differ & tie).sum()),
                 dropped_violations=violations,
                 max_abs_err=float(err.max()) if err.numel() else 0.0)
    ok = (stats["set_mismatch"] <= TOLERANCE["select_set_mismatch_frac"] * n
          and violations <= TOLERANCE["dropped_violations"])
    return ok, stats


def check_dense(k, p):
    """Dense kernel against the twin, pair by pair: hit masks, ids (a
    different id at the same t is a tie), t, u and v."""
    t_k, i_k, u_k, v_k = (x.cpu().numpy() for x in k)
    t_p, i_p, u_p, v_p = (x.cpu().numpy() for x in p)
    both = (i_k >= 0) & (i_p >= 0)
    same = both & (i_k == i_p)
    tie = both & (i_k != i_p) & (t_k == t_p)
    rel = np.abs(t_k[both] - t_p[both]) / np.abs(t_p[both])
    uv = max(_max_abs(u_k[same], u_p[same]), _max_abs(v_k[same], v_p[same]))
    n = t_k.shape[0]
    stats = dict(pairs=n, hits=int((i_k >= 0).sum()),
                 hit_mismatch=int(((i_k >= 0) != (i_p >= 0)).sum()),
                 max_rel_t_err=float(rel.max()) if rel.size else 0.0,
                 max_abs_uv_err=uv, ties=int(tie.sum()),
                 id_mismatch_outside_ties=int((both & (i_k != i_p)
                                               & ~tie).sum()))
    stats["max_abs_err"] = max(_max_abs(t_k[both], t_p[both]), uv)
    ok = (stats["hit_mismatch"] <= TOLERANCE["hit_mismatch_frac"] * n
          and stats["max_rel_t_err"] <= TOLERANCE["dense_t_rel"]
          and uv <= TOLERANCE["dense_uv_abs"]
          and stats["id_mismatch_outside_ties"]
          <= TOLERANCE["id_mismatch_frac"] * n)
    return ok, stats


def sorted_pairs(o, d, tm, slot_c):
    """binned_closest's (ray, cluster) pairs of all slots, by cluster."""
    import torch

    from tracerboy_tpu_torch.trace import kernels

    pos, cl = kernels.bin_pairs(slot_c)
    ray = torch.div(pos, slot_c.shape[1], rounding_mode="floor")
    return o[ray], d[ray], tm[ray], cl


def opt_in_kernel_phase(scene, compare, primary, shadow):
    """The cut and binned paths' kernels against their twins on the
    65,536 compare rays and the 921,600-ray primary (closest hit) and
    shadow (any hit) waves; each timed at the wave's shape."""
    import torch

    from tracerboy_tpu_torch.trace import binned, cut, kernels, traverse
    from tracerboy_tpu_torch.utils.bench_traverse import (
        dense_bound,
        emit_bound,
        select_bound,
        slot_path_rows,
    )

    K = 8
    main_t = (scene["pk_nodes"], scene["pk_tris_bw"])
    shadow_t = (scene["pk_sh_nodes"], scene["pk_sh_tris_bw"])
    cuts = {"main": (scene["pk_cut_top"], scene["pk_cut_roots"]),
            "shadow": (scene["pk_sh_cut_top"], scene["pk_sh_cut_roots"])}
    nodes = scene["bn_nodes"]
    dense_tables = (scene["bn_mot"], scene["bn_base"])
    stats, times = {}, {}
    ok_all = True

    def pairs(o, d, tm, which):
        top, roots = cuts[which]
        ids = cut.emit_cuts(o, d, tm, top, roots.shape[0] - 1, K)
        pos, key = kernels.bin_pairs(ids)
        ray = torch.div(pos, K, rounding_mode="floor")
        return o[ray], d[ray], tm[ray], roots[key.long()]

    for label, rays, which in (("compare", compare, "main"),
                               ("primary", primary, "main"),
                               ("compare_shadow", compare, "shadow"),
                               ("shadow", shadow, "shadow")):
        o, d, tm = rays
        top, roots = cuts[which]
        S = roots.shape[0] - 1
        ek = cut.emit_cuts(o, d, tm, top, S, K)
        ep = cut.emit_cuts_plain(o, d, tm, top, S, K)
        ok, stats[f"emit_{label}"] = check_emit(ek, ep)
        ok_all &= ok
        po, pd, pt, pr = pairs(o, d, tm, which)
        if which == "main":
            tables = main_t
            ck = traverse.closest_hit(po, pd, pt, *tables, pr)
            cp = traverse.closest_hit_plain(po, pd, pt, *tables, pr)
            ok, stats[f"closest_roots_{label}"] = check_closest(
                po, pd, tables, ck, cp)
        else:
            tables = shadow_t
            ok, stats[f"anyhit_roots_{label}"] = check_anyhit(
                traverse.any_hit(po, pd, pt, *tables, pr),
                traverse.anyhit_plain(po, pd, pt, *tables, pr))
        ok_all &= ok
        if which == "main":
            sk = binned.select_clusters(o, d, tm, nodes)
            sp = binned.select_clusters_plain(o, d, tm, nodes)
            ok, stats[f"select_{label}"] = check_select(o, d, tm, nodes, sk,
                                                        sp)
            ok_all &= ok
            dpairs = sorted_pairs(o, d, tm, sk[1])
            dk = binned.dense_pairs(*dpairs, *dense_tables)
            dp = binned.dense_pairs_plain(*dpairs, *dense_tables)
            ok, stats[f"dense_{label}"] = check_dense(dk, dp)
            ok_all &= ok
        if label == "primary":
            emit_cost = emit_bound(o, d, tm, top, K)
            select_cost = select_bound(o, d, tm, nodes, sk[1])
            dense_cost = dense_bound(*dpairs, dense_tables[0])
            times.update(
                emit_ms=cuda_ms(lambda: cut.emit_cuts(o, d, tm, top, S, K),
                                20),
                emit_plain_ms=cuda_ms(lambda: cut.emit_cuts_plain(
                    o, d, tm, top, S, K), 1, warmup=0),
                closest_roots_ms=cuda_ms(lambda: traverse.closest_hit(
                    po, pd, pt, *tables, pr), 20),
                closest_roots_plain_ms=cuda_ms(
                    lambda: traverse.closest_hit_plain(po, pd, pt, *tables,
                                                       pr), 1, warmup=0),
                closest_roots_rays=int(po.shape[0]),
                select_ms=cuda_ms(lambda: binned.select_clusters(
                    o, d, tm, nodes), 20),
                select_plain_ms=cuda_ms(lambda: binned.select_clusters_plain(
                    o, d, tm, nodes), 1, warmup=0),
                dense_ms=cuda_ms(lambda: binned.dense_pairs(
                    *dpairs, *dense_tables), 20),
                dense_plain_ms=cuda_ms(lambda: binned.dense_pairs_plain(
                    *dpairs, *dense_tables), 1, warmup=0),
                dense_pairs=int(dpairs[3].shape[0]),
                primary_live=int((tm > 0).sum()),
                emit_node_visits=emit_cost[2]["visits"],
                emit_rows=emit_cost[2]["rows"],
                select_rows=int(slot_path_rows(nodes, sk[1]).sum()),
                dense_clusters=int(torch.unique(dpairs[3]).numel()),
                emit_bytes=emit_cost[0], emit_ops=emit_cost[1],
                select_bytes=select_cost[0], select_ops=select_cost[1],
                dense_bytes=dense_cost[0], dense_ops=dense_cost[1])
        if label == "shadow":
            times.update(
                anyhit_roots_ms=cuda_ms(lambda: traverse.any_hit(
                    po, pd, pt, *tables, pr), 20),
                anyhit_roots_plain_ms=cuda_ms(lambda: traverse.anyhit_plain(
                    po, pd, pt, *tables, pr), 1, warmup=0),
                anyhit_roots_rays=int(po.shape[0]))
    for key, value in stats.items():
        print(f"{key} kernel vs twin:", json.dumps(value))
    print("timing opt-in kernels, 921,600-ray waves:", json.dumps(times))
    if not ok_all:
        fail(f"an opt-in kernel disagrees with its twin beyond {TOLERANCE}")
    return stats, times


def binned_bounce_phase():
    """The selection and dense kernels against their plain versions on the
    launches of one TB_BINNED=1 render_sample(1) at 1280x720 (its bounce
    waves; bench_traverse.record_binned_launches), each compared with
    check_select / check_dense and timed (CUDA events), beside its bound.
    Returns (statistics by launch, sums: ms, plain ms, bound ms, launches
    of each kernel)."""
    import torch

    from tracerboy_tpu_torch.trace import binned, kernels
    from tracerboy_tpu_torch.utils.bench_traverse import (
        bound,
        dense_bound,
        record_binned_launches,
        select_bound,
    )

    set_opt_in()
    calls = record_binned_launches("shadertoy", FULL_WAVE, 1,
                                   torch.device("cuda"))
    stats, ok_all = {}, True
    sums = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, launches=0)
            for k in ("select", "dense")}
    seen = dict(select=0, dense=0)
    for kind, call in calls:
        label = f"{kind}_{seen[kind]}"
        seen[kind] += 1
        kernels.reset_counters()
        if kind == "select":
            o, d, tm, nodes = call
            got = binned.select_clusters(*call)
            want, plain_ms = timed_once(
                lambda: binned.select_clusters_plain(*call))
            ok, st = check_select(o, d, tm, nodes, got, want)
            st["stack_overflows"] = kernels.stack_overflows()
            ok &= st["stack_overflows"] == 0
            ms = cuda_ms(lambda: binned.select_clusters(*call), 10)
            cost = select_bound(o, d, tm, nodes, got[1])
            st.update(lanes=int(o.shape[0]), live=int((tm > 0).sum()))
        else:
            got = binned.dense_pairs(*call)
            want, plain_ms = timed_once(
                lambda: binned.dense_pairs_plain(*call))
            ok, st = check_dense(got, want)
            ms = cuda_ms(lambda: binned.dense_pairs(*call), 10)
            cost = dense_bound(*call[:5])
        st.update(ms=ms, plain_ms=plain_ms, bound_ms=bound(*cost)[0])
        stats[label] = st
        ok_all &= ok
        for k in ("ms", "plain_ms", "bound_ms"):
            sums[kind][k] += st[k]
        sums[kind]["launches"] += 1
        print(f"binned bounce launch {label} kernel vs plain:", json.dumps(st))
    print("binned bounce launches of render_sample(1):", json.dumps(sums))
    if not all(sums[k]["launches"] > 0 for k in sums):
        fail(f"the binned render launched no bounce selection or dense: {sums}")
    if not ok_all:
        fail(f"a binned kernel disagrees with its plain version on the bounce "
             f"launches beyond {TOLERANCE}, or overflowed its stack")
    return stats, sums


def cut_bounce_phase():
    """The emit kernel against its plain version on every launch of one
    TB_CUT=1 render_sample(1) at 1280x720 (one before each closest-hit and
    each shadow wave; bench_traverse.record_cut_launches): the id tables
    equal bit for bit (no set and no order mismatch) and no stack
    overflow, each launch timed (CUDA events) beside its bound
    (bench_traverse.emit_bound). Then a cut table too large for the
    kernel's shared memory (TB_CUT_TRIS=64, read in place by the same
    walk) on the first closest-hit and shadow launches' rays, equal bit for
    bit too. Returns (statistics by launch, sums: ms, plain ms, bound ms,
    launches, and the large table's rows and ms)."""
    import torch

    from tracerboy_tpu_torch.scene.compile import load_scene
    from tracerboy_tpu_torch.trace import cut, kernels
    from tracerboy_tpu_torch.utils.bench_traverse import (
        bound,
        emit_bound,
        record_cut_launches,
    )

    set_opt_in()
    calls = record_cut_launches("shadertoy", FULL_WAVE, 1,
                                torch.device("cuda"))
    stats, ok_all = {}, True
    sums = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, launches=0)
    seen = dict(main=0, shadow=0)
    firsts = {}
    for table, _, call in calls:
        label = f"{table}_{seen[table]}"
        seen[table] += 1
        firsts.setdefault(table, call)
        kernels.reset_counters()
        got = cut.emit_cuts(*call)
        want, plain_ms = timed_once(lambda: cut.emit_cuts_plain(*call))
        _, st = check_emit(got, want)
        st["stack_overflows"] = kernels.stack_overflows()
        ok_all &= (st["set_mismatch"] == 0 and st["order_mismatch"] == 0
                   and st["stack_overflows"] == 0)
        o, d, tm, top, _, K = call
        st.update(lanes=int(o.shape[0]), live=int((tm > 0).sum()),
                  ms=cuda_ms(lambda: cut.emit_cuts(*call), 10),
                  plain_ms=plain_ms,
                  bound_ms=bound(*emit_bound(o, d, tm, top, K)[:2])[0])
        stats[label] = st
        for k in ("ms", "plain_ms", "bound_ms"):
            sums[k] += st[k]
        sums["launches"] += 1
        print(f"cut bounce launch {label} kernel vs plain:", json.dumps(st))

    # A table above the shared-memory budget: the same walk, in place.
    set_opt_in(TB_CUT="1", TB_CUT_TRIS="64")
    big = load_scene("shadertoy", film_size=FULL_WAVE).as_tensors("cuda")
    set_opt_in()
    sums.update(over_budget_rows=0, over_budget_ms=0.0)
    for table, prefix in (("main", "pk_"), ("shadow", "pk_sh_")):
        top = big[prefix + "cut_top"]
        o, d, tm, _, _, K = firsts[table]
        S = int(big[prefix + "cut_roots"].shape[0]) - 1
        rows = int(cut.compact_rows(top)[0].shape[0])
        kernels.reset_counters()
        got = cut.emit_cuts(o, d, tm, top, S, K)
        _, st = check_emit(got, cut.emit_cuts_plain(o, d, tm, top, S, K))
        st.update(stack_overflows=kernels.stack_overflows(), rows=rows,
                  staged=rows * cut.CUT_ROW * 4 <= cut.STAGED_BYTES,
                  ms=cuda_ms(lambda: cut.emit_cuts(o, d, tm, top, S, K), 10))
        ok_all &= (st["set_mismatch"] == 0 and st["order_mismatch"] == 0
                   and st["stack_overflows"] == 0 and not st["staged"])
        stats[f"over_budget_{table}"] = st
        sums["over_budget_rows"] = max(sums["over_budget_rows"], rows)
        sums["over_budget_ms"] += st["ms"]
        print(f"cut table above the budget, {table} (TB_CUT_TRIS=64) "
              f"kernel vs plain:", json.dumps(st))
    print("cut bounce launches of render_sample(1):", json.dumps(sums))
    if sums["launches"] == 0 or seen["shadow"] == 0:
        fail(f"the cut render launched no emit on both tables: {seen}")
    if not ok_all:
        fail("the emit kernel differs from its plain version on a launch "
             "of the cut render or on the table above the budget, or "
             "overflowed its stack")
    return stats, sums


def render_slice(torch, Renderer, name, env, required, heatmap=False):
    """Renderer("shadertoy", (1280, 720)) under the opt-in variables env:
    render_sample(1), render_sample(8), current_image(), with the launch
    counts set to 0 just before and read just after. Every kernel in
    `required` must launch, and no stack may overflow. With heatmap, one
    more render_sample(1) in the HEATMAP view, whose primary wave must
    take the stats kernel once."""
    from tracerboy_tpu_torch.trace import binned, cut, kernels

    set_opt_in(**env)
    kernels.reset_counters()
    cut.reset_stats()
    binned.reset_stats()
    torch.cuda.reset_peak_memory_stats()
    r = Renderer("shadertoy", film_size=FULL_WAVE, device="cuda")
    cfg = r.wave_config()
    if (cfg.cut, cfg.binned_bounces) != ("TB_CUT" in env,
                                         "TB_BINNED" in env):
        fail(f"{name}: wave config cut={cfg.cut} "
             f"binned_bounces={cfg.binned_bounces} under {env}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.render_sample(1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rays1 = r.rays_traced
    r.render_sample(8)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    img = r.current_image()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    overflow = kernels.stack_overflows()
    acc = r.state.accum
    mean = float(acc[..., :3].mean())
    if not bool(torch.isfinite(acc).all()):
        fail(f"{name}: accumulator is not finite")
    if not mean > 0:
        fail(f"{name}: accumulator mean {mean} is not positive")
    check_image(name, img)
    missing = [k for k in required if launches[k] <= 0]
    if missing:
        fail(f"{name}: the slice did not launch {missing}: {launches}")
    if overflow != 0:
        fail(f"{name}: {overflow} traversal stack overflows")
    rays8 = r.rays_traced - rays1
    results = dict(
        env=env, spp=r.state.spp, accum_mean=mean, launches=launches,
        stack_overflows=overflow, rays_traced=r.rays_traced,
        s_sample1=t1 - t0, s_per_sample_8=(t2 - t1) / 8,
        mrays_s_sample1=rays1 / (t1 - t0) / 1e6,
        mrays_s_8=rays8 / (t2 - t1) / 1e6,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
    )
    if "TB_CUT" in env:
        results["emit_overflow_share"] = (int(cut.STATS["overflow_rays"])
                                          / max(int(cut.STATS["rays"]), 1))
    if "TB_BINNED" in env:
        results["binned_fallback_share"] = (
            int(binned.STATS["fallback_rays"])
            / max(int(binned.STATS["rays"]), 1))
    if heatmap:
        from dataclasses import replace

        from tracerboy_tpu_torch import OutputType

        r.settings = replace(r.settings, output_type=OutputType.HEATMAP)
        kernels.reset_counters()
        r.render_sample(1)
        check_image(f"{name} HEATMAP", r.current_image())
        torch.cuda.synchronize()
        hl = dict(kernels.LAUNCHES)
        if hl["closest_stats"] != 1 or any(hl[k] <= 0 for k in required):
            fail(f"{name} HEATMAP: launches {hl}, expected closest_stats 1 "
                 f"and {required}")
        if kernels.stack_overflows():
            fail(f"{name} HEATMAP: traversal stack overflows")
        results["heatmap_launches"] = hl
    print(f"render shadertoy 1280x720 {name}:", json.dumps(results))
    del r
    set_opt_in()
    return results, launches


def cornell_phase(torch, Renderer):
    c = Renderer("shadertoy:cornell", film_size=CORNELL_FILM,
                 device="cuda")
    if c.traversal != "brute":
        fail(f"cornell took the {c.traversal} path, not brute force")
    t0 = time.perf_counter()
    c.render_sample(4)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cacc = c.state.accum
    cmean = float(cacc[..., :3].mean())
    if not (bool(torch.isfinite(cacc).all()) and cmean > 0):
        fail(f"cornell accumulator not finite/positive (mean {cmean})")
    cimg = c.current_image()
    if (cimg.shape != (CORNELL_FILM[1], CORNELL_FILM[0], 3)
            or not np.isfinite(cimg).all()):
        fail("cornell image malformed")
    print("render cornell 512x512 4 spp (brute):", json.dumps(dict(
        accum_mean=cmean, s_per_sample=(t1 - t0) / 4,
        mrays_s=c.rays_traced / (t1 - t0) / 1e6)))


def aov_slice_phase(torch, Renderer):
    """The first-hit AOV slice on one renderer at 1280x720: every
    OutputType's render_sample(1) (and (8) in LIT and HEATMAP) and
    current_image(), with the launch counts set to 0 just before each
    render and read just after; then pixel inspection and the ray-path
    overlay in LIT. Returns (renderer, results, stats kernel launches of
    the HEATMAP renders)."""
    from dataclasses import replace

    from tracerboy_tpu_torch import OutputType
    from tracerboy_tpu_torch.trace import kernels

    set_opt_in()
    r = Renderer("shadertoy", film_size=FULL_WAVE, device="cuda")
    bounces = r.wave_config().max_bounces
    results, heat_launches = {}, 0
    for view in OutputType:
        r.settings = replace(r.settings, output_type=view)
        heat = view == OutputType.HEATMAP
        eight = view in (OutputType.LIT, OutputType.HEATMAP)
        for n in (1, 8) if eight else (1,):
            kernels.reset_counters()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r.render_sample(n)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            peak = torch.cuda.max_memory_allocated() / 2**30
            check_image(f"{view.name} {n} spp", r.current_image())
            # Either call traces one wave at this film size (8 samples
            # merge into one 7.4M-lane wave): one closest hit per bounce,
            # the primary's through the stats kernel in HEATMAP.
            want = dict(closest_stats=int(heat),
                        closest=bounces - int(heat))
            got = {k: launches[k] for k in want}
            if got != want:
                fail(f"{view.name} render_sample({n}): launches {got}, "
                     f"expected {want}")
            heat_launches += launches["closest_stats"]
            results[f"{view.name}_{n}"] = dict(
                s_per_sample=dt / n, peak_gib=peak,
                closest_stats=launches["closest_stats"],
                closest=launches["closest"], anyhit=launches["anyhit"])
    if kernels.stack_overflows():
        fail("AOV slice: traversal stack overflows")

    r.settings = replace(r.settings, output_type=OutputType.LIT)
    x, y = FULL_WAVE[0] // 2, FULL_WAVE[1] // 2
    sel = r.select_pixel(x, y)
    if set(sel) != {"material_id", "depth", "albedo", "normal",
                    "world_pos"} or not all(
            np.isfinite(sel[k]).all()
            for k in ("depth", "albedo", "normal", "world_pos")):
        fail(f"select_pixel({x}, {y}) malformed: {sel}")
    kernels.reset_counters()
    overlay = r.visualize_selected_ray_path(x, y)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    if (launches["closest"], launches["closest_stats"]) != (bounces, 0):
        fail(f"visualize_selected_ray_path: launches {launches}, expected "
             f"one wave")
    check_image("visualize_selected_ray_path", overlay)
    drawn = int((overlay != r.current_image()).any(-1).sum())
    if drawn == 0:
        fail("visualize_selected_ray_path drew no path")
    err = r.convergence_error()
    if not (np.isfinite(err) and err >= 0):
        fail(f"convergence_error {err}")
    results["inspection"] = dict(
        pixel=[x, y], material_id=sel["material_id"],
        depth=sel["depth"], overlay_pixels_drawn=drawn,
        convergence_error=err, spp=r.state.spp)
    print("AOV slice shadertoy 1280x720:", json.dumps(results))
    return r, results, heat_launches


def denoise_phase(torch, lin):
    """The OIDN UNet with the committed fine-tuned weights on the linear
    image lin (H, W, 3) through the Reinhard transfer, in bfloat16 and in
    float32: finite outputs of lin's shape, warm ms per call (CUDA
    events) and the bf16-vs-f32 max |d| in the network's [0, 1] space and
    in linear radiance."""
    from tracerboy_tpu_torch.ml.finetune import (
        load_params_npz,
        reinhard_fwd,
        reinhard_inv,
    )
    from tracerboy_tpu_torch.ml.oidn import denoise_image

    enc = reinhard_fwd(lin)
    dens, res = {}, dict(shape=list(lin.shape))
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        net = load_params_npz(str(UNET_WEIGHTS), dtype).to(lin.device)
        den = denoise_image(net, enc)
        out = reinhard_inv(den)
        torch.cuda.synchronize()
        if tuple(out.shape) != tuple(lin.shape):
            fail(f"denoise {name}: shape {tuple(out.shape)}")
        if not (bool(torch.isfinite(out).all()) and float(out.min()) >= 0):
            fail(f"denoise {name}: output not finite and non-negative")
        res[f"{name}_ms"] = cuda_ms(lambda: denoise_image(net, enc), 5,
                                    warmup=2)
        dens[name] = (den, out)
        del net
    res["bf16_vs_f32_max_abs"] = float(
        (dens["bf16"][0] - dens["f32"][0]).abs().max())
    res["bf16_vs_f32_max_abs_linear"] = float(
        (dens["bf16"][1] - dens["f32"][1]).abs().max())
    res["input_vs_f32_mean_abs"] = float((dens["f32"][0] - enc).abs().mean())
    print("denoise 1280x720 (rt_ldr_ft.npz, Reinhard):", json.dumps(res))
    return res


def parity_phase(torch, Renderer, scene="shadertoy", film=PARITY_FILM,
                 label="128x72"):
    """One renderer's 2-sample merged wave (what render_sample(2)
    accumulates) on the kernel path against the twin path, and on the
    cut and binned paths against the default kernel path. Returns the
    kernel launches of the cut and binned waves."""
    from dataclasses import replace

    from tracerboy_tpu_torch.trace import kernels
    from tracerboy_tpu_torch.trace.wavefront import render_wave_merged

    set_opt_in(TB_CUT="1", TB_BINNED="1")
    r = Renderer(scene, film_size=film, device="cuda")
    set_opt_in()
    if r.traversal != "kernel":
        fail(f"{scene} took the {r.traversal} path, not the kernels")
    cfg, params = r.wave_config(), r.frame_params()
    paths = {"kernel": replace(cfg, cut=False, binned_bounces=False)}
    paths["twin"] = replace(paths["kernel"], traversal="twin")
    paths["cut"] = replace(paths["kernel"], cut=True)
    paths["binned"] = replace(paths["kernel"], binned_bounces=True)
    accs, launches = {}, {}
    for path, pcfg in paths.items():
        kernels.reset_counters()
        out = render_wave_merged(r.scene, params, r.pixel_ids, 0, 2, pcfg)
        accs[path] = torch.cat([out["radiance"],
                                out["filter_weight"][:, None]],
                               dim=1).cpu().numpy()
        launches[path] = dict(kernels.LAUNCHES)
        if kernels.stack_overflows():
            fail(f"path parity {scene} {path}: stack overflow")
    for path, ref_path in (("kernel", "twin"), ("cut", "kernel"),
                           ("binned", "kernel")):
        ref, got = accs[ref_path], accs[path]
        close = (np.abs(got - ref) <= PARITY["pixel_atol"]
                 * (1 + np.abs(ref))).all(-1).mean()
        mean_rel = abs(got.mean() - ref.mean()) / abs(ref.mean())
        stats = dict(pixels_within=float(close), mean_rel=float(mean_rel))
        print(f"path parity {path} vs {ref_path} {label} 2 spp:",
              json.dumps(stats))
        if close < PARITY["pixel_frac"] or mean_rel > PARITY["mean_rel"]:
            fail(f"path parity {path} vs {ref_path} outside tolerance: "
                 f"{stats}")
    return launches


def v1_phase(cs, scene, compare, primary, unordered):
    """The first-generation closest-hit kernel against its plain version
    on the compare rays, the primary wave and the unordered bounce rays,
    over the raw 9-float rows packed from the scene's triangles (the node
    table must be the scene's); timed beside the closest-hit kernel of the
    waves on the primary wave and the unordered rays. Returns (statistics
    by label, times, bound keys of the primary wave)."""
    import torch

    from tracerboy_tpu_torch.accel.pack import pack_scene
    from tracerboy_tpu_torch.trace import kernels, traverse, traverse_v1
    from tracerboy_tpu_torch.utils.bench_traverse import (
        MT_OPS,
        differ_outside_ties,
        walk_ops,
    )

    pk, _ = pack_scene(cs.tri_v0, cs.tri_v1, cs.tri_v2, raw_rows=True)
    nodes = scene["pk_nodes"]
    if not torch.equal(torch.from_numpy(pk["nodes"]).to(nodes.device), nodes):
        fail("v1: the repacked node table is not the scene's")
    tris = torch.from_numpy(pk["tris"]).to(nodes.device)
    need = traverse.stack_need(nodes)
    if need > traverse_v1.STACK_DEPTH:
        fail(f"v1: the tree can ask for {need} stack entries, the kernel "
             f"has {traverse_v1.STACK_DEPTH}")
    stats, times, ok_all = {}, dict(stack_need=need), True
    for label, (o, d, tm) in (("compare", compare), ("primary", primary),
                              ("unordered", unordered)):
        kernels.reset_counters()
        k = traverse_v1.closest_hit_v1(o, d, tm, nodes, tris)
        overflows = kernels.stack_overflows()      # the kernel's alone
        p, plain_ms = timed_once(lambda: traverse_v1.closest_hit_v1_plain(
            o, d, tm, nodes, tris))
        ok, st = check_closest(o, d, (nodes, tris), k, p,
                               traverse_v1.hit_attributes_v1)
        st["stack_overflows"] = overflows
        # Another triangle test than the waves' kernel: counted, no failure.
        st["differs_from_closest_hit"] = differ_outside_ties(
            k, traverse.closest_hit(o, d, tm, nodes, scene["pk_tris_bw"]))
        stats[label] = st
        times[f"{label}_plain_ms"] = plain_ms
        ok_all &= ok and overflows == 0
        print(f"v1 closest kernel vs plain, {label}:", json.dumps(st))
    uo, ud, utm = unordered
    times.update(
        unordered_ms=cuda_ms(lambda: traverse_v1.closest_hit_v1(
            uo, ud, utm, nodes, tris), 20),
        unordered_closest_ms=cuda_ms(lambda: traverse.closest_hit(
            uo, ud, utm, nodes, scene["pk_tris_bw"]), 20))
    o, d, tm = primary
    node_rows, cluster_rows, pops, clusters = traverse_v1.walk_footprint_v1(
        o, d, tm, nodes, tris)
    live = int((tm > 0).sum())
    times.update(
        v1_ms=cuda_ms(lambda: traverse_v1.closest_hit_v1(o, d, tm, nodes,
                                                         tris), 20),
        closest_ms=cuda_ms(lambda: traverse.closest_hit(
            o, d, tm, nodes, scene["pk_tris_bw"]), 20),
        node_rows=int(node_rows.sum()), cluster_rows=int(cluster_rows.sum()),
        pops=int(pops.sum()), clusters=int(clusters.sum()),
        max_pops=int(pops.max()), max_clusters=int(clusters.max()))
    print("timing v1 kernel, 921,600-ray primary wave and unordered rays:",
          json.dumps(times))
    if not ok_all:
        fail(f"the v1 kernel disagrees with its plain version beyond "
             f"{TOLERANCE}, or overflowed its stack")
    n_bytes = (nbytes(o, d, tm) + row_bytes(nodes, node_rows)
               + row_bytes(tris, cluster_rows) + 16 * o.shape[0])
    ops = walk_ops(live, times["pops"], times["clusters"], nodes, MT_OPS)
    return stats, times, bound_keys(n_bytes, ops)


def study_phase():
    """The traversal study entry point at 921,600 rays, in this process
    so that its launches are counted: set to 0 just before, read just
    after. The v1, closest-hit and any-hit kernels must all launch, and
    no stack may overflow. Returns (results, launches)."""
    from tracerboy_tpu_torch.trace import kernels
    from tracerboy_tpu_torch.utils import bench_traverse

    kernels.reset_counters()
    results = bench_traverse.main(STUDY_ARGS)
    launches = dict(kernels.LAUNCHES)
    overflows = kernels.stack_overflows()
    missing = [k for k in ("closest_v1", "closest", "anyhit")
               if launches[k] <= 0]
    if missing:
        fail(f"the traversal study did not launch {missing}: {launches}")
    if overflows:
        fail(f"the traversal study: {overflows} traversal stack overflows")
    for key, res in results.items():
        if isinstance(res, dict) and "ms" in res and not (
                np.isfinite(res["ms"]) and res["ms"] > 0
                and res.get("hits", 1) > 0):
            fail(f"the traversal study: {key} gave {res}")
    print("traversal study launches:", json.dumps(launches))
    return results, launches


def realtime_phase(torch, Renderer):
    """RealTime mode on "shadertoy" at 1280x720: the fused entry point
    with a camera move part-way, then render_realtime_frame with another;
    then the demodulated batch trace and the demodulation identity.
    Returns (results, launches of the frames)."""
    from dataclasses import replace

    from tracerboy_tpu_torch import OutputSettings, RenderMode
    from tracerboy_tpu_torch.post.realtime import composite_albedo
    from tracerboy_tpu_torch.renderer import _demod_ratio
    from tracerboy_tpu_torch.trace import kernels
    from tracerboy_tpu_torch.trace.wavefront import render_wave

    set_opt_in()
    w, h = FULL_WAVE
    r = Renderer("shadertoy", film_size=FULL_WAVE, device="cuda",
                 settings=OutputSettings(render_mode=RenderMode.REAL_TIME))
    if r.traversal != "kernel" or not r.wave_config().decouple_albedo:
        fail(f"RealTime: traversal {r.traversal}, decouple_albedo "
             f"{r.wave_config().decouple_albedo}")
    r.time_realtime_stages = True
    kernels.reset_counters()
    torch.cuda.reset_peak_memory_stats()

    def frame(fn, label, history):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = fn(as_numpy=False)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        ev = r.rt_stage_events
        check_image(label, img.cpu().numpy())
        return dict(ms=ms, trace_ms=ev[0].elapsed_time(ev[1]),
                    post_ms=ev[1].elapsed_time(ev[2]),
                    # a history sample count above 1: the pixel blended a
                    # valid history tap this frame
                    valid_history=float(
                        (history()["moments"][..., 2] > 1.5).float().mean()))

    fused = []
    for i in range(RT_FUSED_FRAMES):
        if i == RT_MOVE_AFTER:
            r.move_camera(**RT_MOVE)
        rec = frame(r.render_realtime_frame_fused, f"RealTime fused {i}",
                    lambda: r._rt_hist_fused)
        rec["live_share"] = int(r._rt_live_pixels) / (w * h)
        fused.append(rec)
    plain = []
    for i in range(RT_PLAIN_FRAMES):
        if i == RT_PLAIN_FRAMES // 2:
            r.move_camera(**RT_MOVE)
        plain.append(frame(r.render_realtime_frame, f"RealTime frame {i}",
                           lambda: r._rt_history))
    launches = dict(kernels.LAUNCHES)
    overflows = kernels.stack_overflows()
    if launches["closest"] <= 0 or launches["anyhit"] <= 0:
        fail(f"RealTime: the frames did not launch both kernels: {launches}")
    if overflows:
        fail(f"RealTime: {overflows} traversal stack overflows")

    def quartiles(recs, key):
        v = np.asarray([x[key] for x in recs])
        return dict(median=float(np.median(v)),
                    q1=float(np.percentile(v, 25)),
                    q3=float(np.percentile(v, 75)), n=int(v.size))

    steady = fused[2:RT_MOVE_AFTER] + fused[RT_MOVE_AFTER + 1:]
    results = dict(
        frames=dict(fused=RT_FUSED_FRAMES, plain=RT_PLAIN_FRAMES),
        fused_ms=quartiles(steady, "ms"),
        fused_trace_ms=quartiles(steady, "trace_ms"),
        fused_post_ms=quartiles(steady, "post_ms"),
        first_frame_ms=fused[0]["ms"],
        plain_ms=quartiles(plain[1:], "ms"),
        valid_history_before_move=fused[RT_MOVE_AFTER - 1]["valid_history"],
        # The fused entry point restarts on a move (its frame 0 ignores
        # the history), so the history is valid again one frame later.
        valid_history_on_move=fused[RT_MOVE_AFTER]["valid_history"],
        valid_history_after_move=fused[-1]["valid_history"],
        # render_realtime_frame keeps its history across the move and
        # reprojects it through the previous camera.
        plain_valid_history_on_move=plain[RT_PLAIN_FRAMES // 2][
            "valid_history"],
        live_share_by_frame=[x["live_share"] for x in fused],
        governor_pad=r._governor.pad,
        launches=launches, peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    for key in ("valid_history_before_move", "valid_history_after_move",
                "plain_valid_history_on_move"):
        if not results[key] > 0:
            fail(f"RealTime: {key} is {results[key]}")

    # The batch form: 8 demodulated samples in one merged wave.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc = r.trace_decoupled(8)
    torch.cuda.synchronize()
    results["trace_decoupled_8_ms_per_sample"] = (
        (time.perf_counter() - t0) / 8 * 1e3)
    fw = torch.clamp_min(acc["fw"], 1e-8)[:, None]
    illum, illum_d = acc["radiance"] / fw, acc["radiance_d"] / fw
    comp = composite_albedo(
        torch.clamp(acc["albedo"] / 8, 0.0, 1.0),
        _demod_ratio(illum_d, illum), illum, acc["emissive"] / 8)
    if not (bool(torch.isfinite(comp).all()) and float(comp.min()) >= 0
            and float(comp.mean()) > 0
            and bool((illum_d <= illum * (1 + 1e-5) + 1e-6).all())):
        fail("trace_decoupled(8): planes not finite, or D above I")
    results["decoupled_composite_mean"] = float(comp.mean())

    # The identity, per sample, on a wave without russian roulette.
    cfg = replace(r.wave_config(), use_russian_roulette=False,
                  decouple_albedo=False)
    params = r.frame_params()
    ref = render_wave(r.scene, params, r.pixel_ids, 1, cfg)["radiance"]
    dw = render_wave(r.scene, params, r.pixel_ids, 1,
                     replace(cfg, decouple_albedo=True))
    got = composite_albedo(
        dw["albedo"], _demod_ratio(dw["radiance_d"], dw["radiance"]),
        dw["radiance"], dw["emissive"] * dw["filter_weight"][:, None])
    err = (got - ref).abs()
    close = float((err <= IDENTITY["pixel_atol"] * (1 + ref.abs()))
                  .all(-1).float().mean())
    results["identity"] = dict(pixels_within=close,
                               max_abs_err=float(err.max()),
                               mean_radiance=float(ref.mean()))
    print("RealTime shadertoy 1280x720:", json.dumps(results))
    if close < IDENTITY["pixel_frac"]:
        fail(f"demodulation identity outside {IDENTITY}: "
             f"{results['identity']}")
    return results, launches


def png_facts(path):
    """(width, height, colour type, inflated IDAT bytes) of a PNG file,
    read with zlib and struct only."""
    import struct
    import zlib

    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        fail(f"{path}: not a PNG file")
    pos, idat, ihdr = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if zlib.crc32(kind + body) & 0xFFFFFFFF != struct.unpack(
                ">I", data[pos + 8 + n:pos + 12 + n])[0]:
            fail(f"{path}: CRC of {kind} is wrong")
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    if ihdr is None:
        fail(f"{path}: no IHDR")
    return ihdr[0], ihdr[1], ihdr[3], len(zlib.decompress(idat))


def check_cli_outputs(name, png, exr):
    from tracerboy_tpu_torch.core.image_io import read_exr_rgb

    w, h = FULL_WAVE
    pw, ph, ctype, raw = png_facts(png)
    if (pw, ph, ctype, raw) != (w, h, 2, h * (1 + 3 * w)):
        fail(f"CLI {name}: PNG {pw}x{ph} colour type {ctype}, {raw} "
             f"inflated bytes; expected {w}x{h} RGB, {h * (1 + 3 * w)}")
    rad = read_exr_rgb(exr)
    if rad.shape != (h, w, 3) or not np.isfinite(rad).all():
        fail(f"CLI {name}: EXR radiance {rad.shape}, finite "
             f"{bool(np.isfinite(rad).all())}")
    return float(rad.mean())


def env_nee_defaults(samples):
    """A context in which the CLI's settings start from
    environment_nee_samples = samples (the CLI has no flag for it)."""
    import contextlib
    from dataclasses import replace

    from tracerboy_tpu_torch.utils import config

    @contextlib.contextmanager
    def ctx():
        real = config.default_output_settings

        def patched():
            s = real()
            return s.replace(performance_settings=replace(
                s.performance_settings, environment_nee_samples=samples))

        config.default_output_settings = patched
        try:
            yield
        finally:
            config.default_output_settings = real

    return ctx()


def live_subset(tm, rng):
    """The live lanes of a launch (t_max > 0) and a seeded draw of at most
    CHECK_LANES of them, in lane order (all of them where fewer)."""
    import torch

    live_idx = torch.nonzero(tm > 0)[:, 0]
    if live_idx.numel() <= CHECK_LANES:
        return live_idx, live_idx
    pick = np.sort(rng.choice(live_idx.numel(), CHECK_LANES, replace=False))
    return live_idx, live_idx[torch.from_numpy(pick).to(tm.device)]


def cli_launch_check(calls, any_hit):
    """Each launch (o, d, t_max, nodes, tris_bw) recorded in the CLI's env
    run through the any-hit kernel (any_hit: the env-NEE shadow waves) or
    the closest-hit kernel against its plain version (any hit: 0
    occlusion mismatches; closest hit: check_closest's TOLERANCE), with 0
    stack overflows; timed (kernel: CUDA events, 5 runs; plain version:
    one run), beside its bound (bench_traverse.walk_bound of the walk,
    live rays only, counted in chunks of 2^20 rays)."""
    import functools

    from tracerboy_tpu_torch.trace import kernels, traverse
    from tracerboy_tpu_torch.utils.bench_traverse import walk_bound

    label = "env-NEE any-hit" if any_hit else "env-run closest-hit"
    kernel = traverse.any_hit if any_hit else traverse.closest_hit
    plain = traverse.anyhit_plain if any_hit else traverse.closest_hit_plain
    footprint = functools.partial(traverse.walk_footprint, any_hit=any_hit)
    rows, bad, overflows = [], 0, 0
    for o, d, tm, nodes, tris in calls:
        kernels.reset_counters()
        k = kernel(o, d, tm, nodes, tris)
        overflows += kernels.stack_overflows()
        p, plain_ms = timed_once(lambda: plain(o, d, tm, nodes, tris))
        if any_hit:
            _, st = check_anyhit(k, p)
            bad += st["occ_mismatch"] > 0
        else:
            ok, st = check_closest(o, d, (nodes, tris), k, p)
            bad += not ok
        del k, p
        b_ms, b_by, n_bytes, ops = walk_bound(
            o, d, tm, nodes, tris, footprint, 1 if any_hit else 16,
            chunk=1 << 20, live_rays_only=True)
        rows.append(dict(
            st, live=int((tm > 0).sum()),
            ms=cuda_ms(lambda: kernel(o, d, tm, nodes, tris), 5),
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, bytes=n_bytes,
            ops=ops))
    res = dict(launches=len(rows), stack_overflows=overflows,
               ms=sum(r["ms"] for r in rows),
               plain_ms=sum(r["plain_ms"] for r in rows),
               bound_ms=sum(r["bound_ms"] for r in rows),
               max_abs_err=max((r["max_abs_err"] for r in rows), default=0.0))
    for key in (("occ_mismatch",) if any_hit else
                ("hit_mismatch", "id_mismatch_outside_ties", "ties")):
        res[key] = sum(r[key] for r in rows)
    res["per_launch"] = rows
    print(f"{label} launches vs plain:", json.dumps(res))
    if not rows or bad or overflows:
        fail(f"{label} launches: {len(rows)} recorded, {bad} disagree "
             f"with the plain version, {overflows} stack overflows")
    return res


def cli_phase(torch, work):
    """cli_runs in work/cli (the animation phase reuses its env.pbrt)."""
    tmp = os.path.join(work, "cli")
    os.makedirs(tmp)
    return cli_runs(torch, tmp)


def cli_runs(torch, tmp):
    """The command-line renderer, tracerboy_tpu_torch.app.cli.main, in
    this process at 1280x720 on a PBRT scene written here
    (utils/demo_scene.py: a 256x256-quad height field as a binary PLY,
    three spheres, a curve, a checkerboard texture, an .hdr sky as the
    infinite light; lit.pbrt adds a distant and a point light by
    Include). Runs: (1) the sky alone, --spp 8 (env NEE on by auto, the
    closest- and any-hit launches recorded: with no light records each
    any-hit one is an env-NEE shadow wave); (2) --env-nee on with environment_nee_samples
    4; (3) the lit scene; (4) --mode realtime --frames 8; (5)
    --checkpoint at 4 spp, then a second process resuming to 8. Each run
    must write a 1280x720 RGB PNG and finite EXR radiance, launch the
    closest- and any-hit kernels and overflow no stack. Then the recorded
    launches of run (1) against the plain version (cli_launch_check),
    and the peak memory of
    render_sample(8) at M = 1 and M = 8. Returns (results, launches of
    the in-process runs plus the resuming process's)."""
    from tracerboy_tpu_torch import Renderer
    from tracerboy_tpu_torch.app import cli
    from tracerboy_tpu_torch.trace import kernels, traverse
    from tracerboy_tpu_torch.utils.demo_scene import write_demo_scene

    set_opt_in()
    env_scene, lit_scene = write_demo_scene(tmp)
    size = f"{FULL_WAVE[0]}x{FULL_WAVE[1]}"
    total = dict.fromkeys(kernels.LAUNCHES, 0)
    results = {}
    recorded = {"any_hit": [], "closest_hit": []}
    real = {key: getattr(traverse, key) for key in recorded}

    def recorder(key):
        def recording(o, d, t_max, nodes, tris_bw, roots=None):
            if roots is not None:
                fail(f"CLI env run: a {key} launch with per-ray roots")
            recorded[key].append((o.clone(), d.clone(), t_max.clone(),
                                  nodes, tris_bw))
            return real[key](o, d, t_max, nodes, tris_bw)
        return recording

    def run(name, scene, extra, record=False):
        out = os.path.join(tmp, f"{name}.png")
        exr = os.path.join(tmp, f"{name}.exr")
        kernels.reset_counters()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        last = {}
        if record:
            for key in recorded:
                setattr(traverse, key, recorder(key))
        try:
            rc = cli.main([scene, "--size", size, "--out", out, "--hdr-out",
                           exr, "--quiet", *extra], stats=last)
        finally:
            for key, fn in real.items():
                setattr(traverse, key, fn)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        overflow = kernels.stack_overflows()
        if rc != 0:
            fail(f"CLI {name}: exit {rc}")
        mean = check_cli_outputs(name, out, exr)
        if launches["closest"] <= 0 or launches["anyhit"] <= 0 or overflow:
            fail(f"CLI {name}: launches {launches}, {overflow} stack "
                 f"overflows")
        for k, v in launches.items():
            total[k] += v
        res = dict(seconds=time.perf_counter() - t0,
                   render_seconds=last["seconds"], spp=last["spp"],
                   s_per_sample=last["seconds"] / max(last["spp"], 1),
                   mrays_s=last["rays_traced"] / last["seconds"] / 1e6,
                   radiance_mean=mean, launches=launches,
                   stack_overflows=overflow,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   recorded_gib=sum(nbytes(*c[:3]) for calls in
                                    recorded.values() for c in calls)
                   / 2**30 if record else 0.0)
        print(f"CLI {name}:", json.dumps(res))
        results[name] = res
        return res

    run("env", env_scene, ["--spp", "8"], record=True)
    with env_nee_defaults(4):
        run("env_m4", env_scene, ["--spp", "8", "--env-nee", "on"])
    run("lit", lit_scene, ["--spp", "8"])
    run("realtime", env_scene, ["--mode", "realtime", "--frames", "8"])
    ck = os.path.join(tmp, "ck.npz")
    run("checkpoint4", env_scene, ["--spp", "4", "--checkpoint", ck])
    code = ("import json, sys\n"
            "from tracerboy_tpu_torch.app import cli\n"
            "from tracerboy_tpu_torch.trace import kernels\n"
            "run = {}\n"
            "rc = cli.main(sys.argv[1:], stats=run)\n"
            "print(json.dumps(dict(rc=rc, launches=kernels.LAUNCHES,\n"
            "    overflows=kernels.stack_overflows(), run=run)))\n")
    out8, exr8 = (os.path.join(tmp, "resumed.png"),
                  os.path.join(tmp, "resumed.exr"))
    proc = subprocess.run(
        [sys.executable, "-c", code, env_scene, "--size", size, "--spp", "8",
         "--checkpoint", ck, "--out", out8, "--hdr-out", exr8],
        capture_output=True, text=True, timeout=600,
        cwd=str(Path(__file__).resolve().parent))
    if proc.returncode != 0:
        fail(f"CLI resume: exit {proc.returncode}\n{proc.stdout[-3000:]}"
             f"\n{proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    rep = json.loads(lines[-1])
    spp = int(np.load(ck)["spp"])
    if not any("resumed from checkpoint at 4 spp" in ln for ln in lines):
        fail(f"CLI resume: no resume at 4 spp in {lines[:4]}")
    if (spp != 8 or rep["run"]["spp"] != 4 or rep["overflows"]
            or rep["launches"]["closest"] <= 0
            or rep["launches"]["anyhit"] <= 0):
        fail(f"CLI resume: checkpoint spp {spp}, process {rep}")
    check_cli_outputs("resumed", out8, exr8)
    for k, v in rep["launches"].items():
        total[k] += v
    results["resumed"] = dict(checkpoint_spp=spp, launches=rep["launches"],
                              render_seconds=rep["run"]["seconds"])
    print("CLI resumed process:", json.dumps(results["resumed"]))

    env_nee = cli_launch_check(recorded.pop("any_hit"), any_hit=True)
    env_closest = cli_launch_check(recorded.pop("closest_hit"),
                                   any_hit=False)

    # Peak memory of the 8-sample merged wave (7,372,800 lanes) with M
    # env-NEE samples: the shadow wave is M x 7,372,800 rays.
    from dataclasses import replace

    mem = {}
    for M in (1, 8):
        r = Renderer(env_scene, film_size=FULL_WAVE, device="cuda")
        r.settings = r.settings.replace(performance_settings=replace(
            r.settings.performance_settings, environment_nee_samples=M))
        cfg = r.wave_config()
        if not (cfg.env_nee and cfg.env_nee_samples == M
                and r.traversal == "kernel"):
            fail(f"env NEE M={M}: wave config {cfg}")
        r.render_sample(1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        r.render_sample(8)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        mem[f"M{M}"] = dict(
            peak_gib=torch.cuda.max_memory_allocated() / 2**30,
            s_per_sample=dt / 8, accum_finite=bool(
                torch.isfinite(r.state.accum).all()))
        if not mem[f"M{M}"]["accum_finite"]:
            fail(f"env NEE M={M}: accumulator not finite")
        del r
    print("env NEE render_sample(8) at 1280x720:", json.dumps(mem))
    results["env_nee_memory"] = mem
    results["env_nee"] = env_nee
    results["env_closest"] = env_closest
    results["env_scene"] = env_scene
    return results, total


# The alpha-cut canopy must let the sky through: the mean radiance of the
# top band of the image (rows [0, h/5), the canopy in front of the sky)
# differs from the run with the leaf image's alpha forced to 1 by more
# than this share of the opaque run's band mean.
CUTOUT_BAND_MARGIN = 0.1


def tag_closest_launches(nodes_seq, shadow_kind):
    """Kinds of a wave's closest-hit launches from the tables each walked
    (the data pointers of its node tables, in launch order): a run of
    main-BVH launches is the bounce's closest hit ("main") and its alpha
    re-fires ("refire_k"); a run of shadow-BVH launches is one shadow march
    (shadow_kind + "_k", round k)."""
    main = nodes_seq[0]
    kinds, run = [], 0
    for i, ptr in enumerate(nodes_seq):
        same = i > 0 and (ptr == main) == (nodes_seq[i - 1] == main)
        run = run + 1 if same else 0
        if ptr == main:
            kinds.append("main" if run == 0 else f"refire_{run}")
        else:
            kinds.append(f"{shadow_kind}_{run}")
    return kinds


def textured_launch_check(calls, kinds, rng, chunk=1 << 20, measure=True):
    """Each recorded closest-hit launch (o, d, t_max, nodes, tris_bw)
    through the kernel, held against closest_hit_plain on at most
    CHECK_LANES of its live lanes (check_closest's TOLERANCE;
    dead lanes must miss), and with measure timed on the card alone
    (time_runs, ahead=True) beside its bound (bench_traverse.walk_bound
    of the walk of every lane, live rays only, counted in chunks of
    `chunk` rays); sums by kind (ms and bound_ms None unmeasured)."""
    from tracerboy_tpu_torch.trace import kernels, traverse
    from tracerboy_tpu_torch.utils.bench_traverse import (
        time_runs,
        walk_bound,
    )

    by_kind = {}
    bad = []
    for (o, d, tm, nodes, tris), kind in zip(calls, kinds):
        kernels.reset_counters()
        k = traverse.closest_hit(o, d, tm, nodes, tris)
        overflows = kernels.stack_overflows()
        live_idx, sel = live_subset(tm, rng)
        live = live_idx.numel()
        p = traverse.closest_hit_plain(o[sel], d[sel], tm[sel], nodes, tris)
        ok, st = check_closest(o[sel], d[sel], (nodes, tris),
                               tuple(x[sel] for x in k), p)
        dead_hits = int((k[1][tm <= 0] >= 0).sum())
        ms, b_ms, b_by = 0.0, 0.0, "not measured"
        if measure:
            ms = float(np.median(time_runs(
                lambda: traverse.closest_hit(o, d, tm, nodes, tris), 5,
                o.device, ahead=True)))
            b_ms, b_by, _, _ = walk_bound(
                o, d, tm, nodes, tris, traverse.walk_footprint, 16,
                chunk=chunk, live_rays_only=True)
        row = by_kind.setdefault(kind, dict(
            launches=0, lanes=0, live=0, checked=0, ms=0.0, bound_ms=0.0,
            bound_by=[], hit_mismatch=0,
            id_mismatch_outside_ties=0, ties=0, max_rel_t_err=0.0,
            max_abs_err=0.0, overflows=0, dead_lane_hits=0))
        row["launches"] += 1
        row["lanes"] += o.shape[0]
        row["live"] += live
        row["checked"] += st["rays"]
        row["ms"] += ms
        row["bound_ms"] += b_ms
        row["bound_by"].append(b_by)
        for key in ("hit_mismatch", "id_mismatch_outside_ties", "ties"):
            row[key] += st[key]
        row["max_rel_t_err"] = max(row["max_rel_t_err"], st["max_rel_t_err"])
        row["max_abs_err"] = max(row["max_abs_err"], st["max_abs_err"])
        row["overflows"] += overflows
        row["dead_lane_hits"] += dead_hits
        if not ok or overflows or dead_hits:
            bad.append((kind, st, overflows, dead_hits))
        del k, p
    for row in by_kind.values():
        row["live_share"] = row["live"] / max(row["lanes"], 1)
        if not measure:
            row["ms"] = row["bound_ms"] = None
    return by_kind, bad


def textured_phase(torch, Renderer):
    """textured_runs in a temporary directory that is removed after it."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="tb_tex_") as tmp:
        return textured_runs(torch, Renderer, tmp)


def textured_runs(torch, Renderer, tmp):
    """The textured PBRT scene of utils/demo_scene.py (150,338 triangles:
    the height field with a 1024x1024 sRGB albedo and a 512x512 normal
    map, 8,192 alpha-cut leaf quads sharing a 512x512 RGBA image, a
    screen cut by a "texture alpha" mask, an fbm and a marble sphere, a
    glass sphere, the .hdr sky as the only light; textured_lit.pbrt adds
    a distant light). Load times cold and from the .tbcache.npz; CLI runs
    at 1280x720, 8 spp: (1) textured.pbrt (env NEE through the alpha
    shadow rounds), (2) textured_lit.pbrt (light NEE), (3) the same with
    --transparent-shadows, (4) textured.pbrt with the leaf image's alpha
    forced to 1; each must write its PNG and finite EXR, launch the
    closest-hit kernel (and never the any-hit one: with cutouts every
    shadow wave is a closest-hit march) and overflow no stack; the
    canopy band of (1) against (4). The first wave's closest-hit
    launches of (2), and the shadow-BVH launches of (3)'s first wave,
    tagged by kind and checked (textured_launch_check). Then
    Renderer(textured.pbrt, (1280, 720)).render_sample(8), its peak
    memory, and path parity at 128x72."""
    from tracerboy_tpu_torch.app import cli
    from tracerboy_tpu_torch.core import image_io
    from tracerboy_tpu_torch.scene.compile import load_scene
    from tracerboy_tpu_torch.trace import kernels, traverse
    from tracerboy_tpu_torch.trace.wavefront import WaveConfig
    from tracerboy_tpu_torch.utils.config import default_output_settings
    from tracerboy_tpu_torch.utils.demo_scene import write_textured_scene

    set_opt_in()
    results = {}
    t0 = time.perf_counter()
    tex_scene, lit_scene = write_textured_scene(tmp)
    results["write_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cs = load_scene(tex_scene)
    cold = time.perf_counter() - t0
    cache = tex_scene + ".tbcache.npz"
    if not os.path.exists(cache):
        fail(f"textured scene: no cache written at {cache}")
    t0 = time.perf_counter()
    again = load_scene(tex_scene)
    cached = time.perf_counter() - t0
    if not np.array_equal(cs.tri_v0, again.tri_v0):
        fail("textured scene: the cached load differs from the compile")
    results["load"] = dict(cold_s=cold, cached_s=cached,
                           triangles=int(cs.num_tris),
                           images=list(cs.tex_images.shape),
                           cache_mib=os.path.getsize(cache) / 2**20)
    print("textured scene load:", json.dumps(results["load"]))
    del cs, again

    # The opaque twin of the scene: the leaf image with alpha 1.
    leaf = image_io.read_ldr(os.path.join(tmp, "leaf.png"))
    leaf[..., 3] = 1.0
    image_io.write_png(os.path.join(tmp, "leaf_opaque.png"), leaf)
    opaque_scene = os.path.join(tmp, "textured_opaque.pbrt")
    with open(tex_scene) as f:
        text = f.read().replace('"leaf.png"', '"leaf_opaque.png"')
    with open(opaque_scene, "w") as f:
        f.write(text)

    size = f"{FULL_WAVE[0]}x{FULL_WAVE[1]}"
    perf = default_output_settings().performance_settings
    rounds = WaveConfig(width=1, height=1).alpha_rounds
    per_bounce = 1 + rounds + (rounds + 1)
    per_wave = perf.max_bounces * per_bounce
    total = dict.fromkeys(kernels.LAUNCHES, 0)
    real = traverse.closest_hit

    def run(name, scene, extra, record=None):
        """record: None, "all" (the first wave's launches) or "shadow"
        (only its shadow-BVH launches); returns (result, recorded calls,
        their node-table pointers in launch order)."""
        out = os.path.join(tmp, f"{name}.png")
        exr = os.path.join(tmp, f"{name}.exr")
        seq, calls = [], []

        def recording(o, d, t_max, nodes, tris_bw, roots=None):
            if roots is not None:
                fail(f"textured {name}: a launch with per-ray roots")
            if len(seq) < per_wave:
                seq.append(nodes.data_ptr())
                if record == "all" or (record == "shadow"
                                       and nodes.data_ptr() != seq[0]):
                    calls.append((o.clone(), d.clone(), t_max.clone(),
                                  nodes, tris_bw))
                else:
                    calls.append(None)
            return real(o, d, t_max, nodes, tris_bw)

        kernels.reset_counters()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        last = {}
        if record:
            traverse.closest_hit = recording
        try:
            rc = cli.main([scene, "--size", size, "--spp", "8", "--out", out,
                           "--hdr-out", exr, "--quiet", *extra], stats=last)
        finally:
            traverse.closest_hit = real
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        overflow = kernels.stack_overflows()
        if rc != 0:
            fail(f"textured CLI {name}: exit {rc}")
        mean = check_cli_outputs(f"textured {name}", out, exr)
        img = image_io.read_ldr(out)
        check_image(f"textured {name}", img)
        if launches["closest"] <= 0 or launches["anyhit"] or overflow:
            fail(f"textured CLI {name}: launches {launches}, {overflow} "
                 "stack overflows (with cutouts every shadow wave is a "
                 "closest-hit march: no any-hit launch)")
        waves = last["spp"] // 4
        if launches["closest"] != waves * per_wave:
            fail(f"textured CLI {name}: {launches['closest']} closest-hit "
                 f"launches, expected {waves} waves x {per_wave}")
        for k, v in launches.items():
            total[k] += v
        rad = image_io.read_exr_rgb(exr)
        res = dict(seconds=time.perf_counter() - t0,
                   render_seconds=last["seconds"], spp=last["spp"],
                   s_per_sample=last["seconds"] / max(last["spp"], 1),
                   mrays_s=last["rays_traced"] / last["seconds"] / 1e6,
                   radiance_mean=mean,
                   band_mean=float(rad[:FULL_WAVE[1] // 5].mean()),
                   launches=launches, stack_overflows=overflow,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        print(f"textured CLI {name}:", json.dumps(res))
        results[name] = res
        return res, calls, seq

    run("textured", tex_scene, [])
    _, lit_calls, lit_seq = run("lit", lit_scene, [], record="all")
    _, tr_calls, tr_seq = run("transparent", lit_scene,
                              ["--transparent-shadows"], record="shadow")
    run("opaque", opaque_scene, [])
    band = dict(cutout=results["textured"]["band_mean"],
                opaque=results["opaque"]["band_mean"])
    band["rel_diff"] = abs(band["cutout"] - band["opaque"]) / band["opaque"]
    print("textured canopy band vs opaque leaves:", json.dumps(band))
    if band["rel_diff"] <= CUTOUT_BAND_MARGIN:
        fail(f"the alpha-cut canopy does not show the sky: {band}")
    results["band"] = band

    rng = np.random.default_rng(20261017)
    kinds = tag_closest_launches(lit_seq, "shadow")
    tr_kinds = tag_closest_launches(tr_seq, "transparent")
    calls = [c for c in lit_calls if c is not None]
    kinds = [k for c, k in zip(lit_calls, kinds) if c is not None]
    calls += [c for c in tr_calls if c is not None]
    kinds += [k for c, k in zip(tr_calls, tr_kinds) if c is not None]
    del lit_calls, tr_calls
    t0 = time.perf_counter()
    by_kind, bad = textured_launch_check(calls, kinds, rng)
    results["check_s"] = time.perf_counter() - t0
    del calls
    torch.cuda.empty_cache()
    print(f"textured closest-hit launches by kind "
          f"({results['check_s']:.1f} s):", json.dumps(by_kind))
    if bad:
        fail(f"textured launches disagree with the plain version: {bad}")
    checked = sum(r["checked"] for r in by_kind.values())
    outside = sum(r["id_mismatch_outside_ties"] for r in by_kind.values())
    if outside > TOLERANCE["id_mismatch_frac"] * checked:
        fail(f"textured launches: {outside} id mismatches outside ties in "
             f"{checked} checked lanes")
    results["kinds"] = by_kind

    # The full merged wave: render_sample(8) through the Renderer.
    r = Renderer(tex_scene, film_size=FULL_WAVE, device="cuda")
    cfg = r.wave_config()
    if not (cfg.has_alpha and cfg.has_normal_maps and cfg.env_nee
            and r.traversal == "kernel"):
        fail(f"textured Renderer: wave config {cfg}")
    r.render_sample(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counters()
    t0 = time.perf_counter()
    r.render_sample(8)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    for k, v in launches.items():
        total[k] += v
    results["render_sample8"] = dict(
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        s_per_sample=dt / 8, launches=launches,
        stack_overflows=kernels.stack_overflows())
    img = r.current_image()
    img = img.cpu().numpy() if hasattr(img, "cpu") else np.asarray(img)
    check_image("textured render_sample(8)", img)
    if (launches["closest"] <= 0 or launches["anyhit"]
            or kernels.stack_overflows()):
        fail(f"textured render_sample(8): {results['render_sample8']}")
    print("textured render_sample(8) at 1280x720:",
          json.dumps(results["render_sample8"]))
    del r

    results["parity_launches"] = parity_phase(
        torch, Renderer, tex_scene, PARITY_FILM, "textured 128x72")
    return results, total


# tests/test_instanced.py's rule for a TLAS render against the flat one.
TLAS_PARITY = dict(rtol=1e-3, atol=5e-3, share=0.98)


def expand_launch(rec):
    """A recorded launch (lanes, live lane ids, their o, d, t_max, nodes,
    tris_bw) back at its full width: dead lanes get t_max 0, a zero origin
    and a unit direction (a dead lane walks nothing)."""
    import torch

    n, live, o, d, tm, nodes, tris = rec
    dev = o.device
    full_o = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    full_d = torch.ones((n, 3), dtype=torch.float32, device=dev)
    full_t = torch.zeros((n,), dtype=torch.float32, device=dev)
    full_o[live], full_d[live], full_t[live] = o, d, tm
    return full_o, full_d, full_t, nodes, tris


def tag_instanced_launches(records, scene, names):
    """Kinds of a TLAS wave's closest-hit launches: "main" on the flat
    scene's BVH, and each BLAS launch "<pass>_r<round>_<object>": the pass
    "closest" where its group of launches (one an object a round) follows
    a main launch (the instanced hit merged into the bounce's closest
    hit), "occluder" where it does not (the instanced occluders of a
    shadow wave)."""
    from tracerboy_tpu_torch.trace import instanced

    objs = {o["packed"]["nodes"].data_ptr(): k
            for k, o in enumerate(scene["inst_objs"])}
    n_obj = len(objs)
    k_eff = min(instanced.KI * instanced.ROUNDS, scene["inst_obj"].shape[0])
    group = -(-k_eff // instanced.KI) * n_obj
    kinds, j, pass_kind, prev = [], 0, None, None
    for rec in records:
        ptr = rec[5].data_ptr()
        if ptr not in objs:
            if ptr != scene["pk_nodes"].data_ptr():
                fail(f"instanced run: a closest-hit launch on tables "
                     f"{ptr:#x}, neither the flat BVH nor an object's")
            kinds.append("main")
            j, prev = 0, "main"
            continue
        if j % group == 0:
            pass_kind = "closest" if prev == "main" else "occluder"
        kinds.append(f"{pass_kind}_r{j % group // n_obj}_{names[objs[ptr]]}")
        j, prev = j + 1, "blas"
    return kinds


def geometry_bytes(scene) -> int:
    """Bytes of the geometry tables a render holds: every pk_, bn_, tri and
    bvh leaf and the objects' packed tables (tests/test_instanced.py's
    count)."""
    import torch

    total, stack = 0, [v for k, v in scene.items()
                       if k.startswith(("pk_", "bn_", "tri", "bvh"))
                       or k == "inst_objs"]
    while stack:
        x = stack.pop()
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, list):
            stack.extend(x)
        elif isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
    return total


def instanced_phase(torch, work):
    """instanced_runs in work/instanced."""
    tmp = os.path.join(work, "instanced")
    os.makedirs(tmp)
    return instanced_runs(torch, tmp)


def instanced_runs(torch, tmp):
    """The instanced PBRT scene of utils/demo_scene.py (forest.pbrt: a
    131,072-triangle height field; 64 instances of a 16,128-triangle tree
    with a TGA texture in clusters of overlapping boxes, 24 of a
    6,080-triangle rock with a BMP texture, one emissive panel; 1,178,114
    triangles flattened, so "auto" keeps a TLAS) and the tree alone as
    .glb and .obj. CLI runs at 1280x720, 4 spp (one wave): (1) forest.pbrt,
    which must compile to a TLAS, every closest-hit launch recorded (the
    live lanes only); (2) --export-pbf, then (3) the .pbf, which reads
    back flat, its radiance against (1)'s under TLAS_PARITY; (4) tree.glb
    and (5) tree.obj. Each must write its PNG and finite EXR (the PNGs read
    back in [0, 1]), launch kernel 1 and overflow no stack. Then (1)'s
    launches tagged (tag_instanced_launches) and held against the plain
    version on at most CHECK_LANES live lanes each, timed beside their
    bound (textured_launch_check). Returns (results, launches); results
    ["forest"] holds the TLAS renderer and its object names."""
    from tracerboy_tpu_torch import renderer as renderer_mod
    from tracerboy_tpu_torch.app import cli
    from tracerboy_tpu_torch.core import image_io
    from tracerboy_tpu_torch.trace import kernels, traverse
    from tracerboy_tpu_torch.utils.demo_scene import (
        write_forest_scene,
        write_mesh_scenes,
    )

    set_opt_in()
    results = {}
    t0 = time.perf_counter()
    forest = write_forest_scene(os.path.join(tmp, "forest"))
    meshes = write_mesh_scenes(os.path.join(tmp, "meshes"))
    results["write_s"] = time.perf_counter() - t0
    with open(forest) as f:
        names = sorted(line.split('"')[1] for line in f
                       if line.strip().startswith("ObjectBegin"))
    size = f"{FULL_WAVE[0]}x{FULL_WAVE[1]}"
    total = dict.fromkeys(kernels.LAUNCHES, 0)
    real_closest = traverse.closest_hit
    real_init = renderer_mod.Renderer.__init__
    built = []

    def capturing_init(self, *args, **kwargs):
        real_init(self, *args, **kwargs)
        built.append(self)

    def run(name, scene, record=None):
        out = os.path.join(tmp, f"{name}.png")
        exr = os.path.join(tmp, f"{name}.exr")

        def recording(o, d, t_max, nodes, tris_bw, roots=None):
            if roots is not None:
                fail(f"instanced {name}: a launch with per-ray roots")
            live = torch.nonzero(t_max > 0)[:, 0]
            record.append((o.shape[0], live, o[live], d[live], t_max[live],
                           nodes, tris_bw))
            return real_closest(o, d, t_max, nodes, tris_bw)

        kernels.reset_counters()
        torch.cuda.reset_peak_memory_stats()
        built.clear()
        renderer_mod.Renderer.__init__ = capturing_init
        if record is not None:
            traverse.closest_hit = recording
        last = {}
        t0 = time.perf_counter()
        try:
            rc = cli.main([scene, "--size", size, "--spp", "4", "--out", out,
                           "--hdr-out", exr, "--quiet"], stats=last)
        finally:
            traverse.closest_hit = real_closest
            renderer_mod.Renderer.__init__ = real_init
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        overflow = kernels.stack_overflows()
        if rc != 0 or len(built) != 1:
            fail(f"instanced CLI {name}: exit {rc}, {len(built)} renderers")
        mean = check_cli_outputs(f"instanced {name}", out, exr)
        check_image(f"instanced {name}", image_io.read_ldr(out))
        if launches["closest"] <= 0 or overflow or last["spp"] != 4:
            fail(f"instanced CLI {name}: launches {launches}, {overflow} "
                 f"stack overflows, {last['spp']} samples")
        for k, v in launches.items():
            total[k] += v
        r = built[0]
        res = dict(seconds=time.perf_counter() - t0,
                   render_seconds=last["seconds"], spp=last["spp"],
                   s_per_sample=last["seconds"] / last["spp"],
                   mrays_s=last["rays_traced"] / last["seconds"] / 1e6,
                   radiance_mean=mean, launches=launches,
                   stack_overflows=overflow,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   triangles=int(r.compiled.num_tris),
                   has_instances=bool(r.compiled.has_instances),
                   geometry_bytes=geometry_bytes(r.scene),
                   recorded_gib=sum(nbytes(*c[1:5]) for c in record) / 2**30
                   if record is not None else 0.0)
        print(f"instanced CLI {name}:", json.dumps(res))
        results[name] = res
        return res, r, exr

    records = []
    tlas, r_tlas, tlas_exr = run("forest", forest, record=records)
    cfg = r_tlas.wave_config()
    if not (r_tlas.compiled.has_instances and cfg.has_instances
            and r_tlas.traversal == "kernel"):
        fail(f"forest: not a TLAS render ({cfg})")
    tables = r_tlas.compiled.inst_tables
    results["forest_scene"] = dict(
        flat_triangles=int(r_tlas.compiled.num_tris),
        instances=int(tables["inst_obj"].shape[0]),
        objects=names,
        object_rows=[int(o["attrs"].shape[0])
                     for o in r_tlas.compiled.inst_objects],
        instanced_triangles_flattened=int(sum(
            len(r_tlas.compiled.inst_objects[k]["verts"])
            for k in tables["inst_obj"])))
    print("forest scene:", json.dumps(results["forest_scene"]))
    scene_tlas = r_tlas.scene
    # The TLAS renderer and its object names, for the animation phase.
    results["forest"] = (r_tlas, names)
    del r_tlas

    pbf = os.path.join(tmp, "forest", "forest.pbf")
    if cli.main([forest, "--export-pbf", pbf]) != 0 or not os.path.exists(
            pbf):
        fail("forest: --export-pbf wrote nothing")
    flat, r_flat, flat_exr = run("forest_pbf", pbf)
    if r_flat.compiled.has_instances:
        fail("forest.pbf: read back with instances (read_pbf flattens)")
    del r_flat
    a = image_io.read_exr_rgb(tlas_exr)
    b = image_io.read_exr_rgb(flat_exr)
    share = float(np.isclose(a, b, rtol=TLAS_PARITY["rtol"],
                             atol=TLAS_PARITY["atol"]).mean())
    results["tlas_vs_pbf"] = dict(
        close_share=share, tlas_s_per_sample=tlas["s_per_sample"],
        flat_s_per_sample=flat["s_per_sample"],
        tlas_mrays_s=tlas["mrays_s"], flat_mrays_s=flat["mrays_s"],
        tlas_peak_gib=tlas["peak_gib"], flat_peak_gib=flat["peak_gib"],
        tlas_geometry_bytes=tlas["geometry_bytes"],
        flat_geometry_bytes=flat["geometry_bytes"],
        geometry_ratio=tlas["geometry_bytes"] / flat["geometry_bytes"])
    print("forest TLAS vs .pbf (flat):", json.dumps(results["tlas_vs_pbf"]))
    if share <= TLAS_PARITY["share"]:
        fail(f"forest: the TLAS and .pbf renders agree on {share:.4f} of "
             f"the values, at most {TLAS_PARITY['share']}")

    for kind in ("glb", "obj"):
        run(f"tree_{kind}", meshes[kind])

    rng = np.random.default_rng(20261018)
    kinds = tag_instanced_launches(records, scene_tlas, names)
    t0 = time.perf_counter()
    # Chunks of 2^22 rays: each launch's live lanes in one walk (its steps,
    # not its rays, set the walk's time).
    by_kind, bad = textured_launch_check(
        (expand_launch(rec) for rec in records), kinds, rng, chunk=1 << 22)
    results["check_s"] = time.perf_counter() - t0
    del records, scene_tlas
    torch.cuda.empty_cache()
    print(f"forest closest-hit launches by kind "
          f"({results['check_s']:.1f} s):", json.dumps(by_kind))
    if bad:
        fail(f"forest launches disagree with the plain version: {bad}")
    blas = [row for kind, row in by_kind.items() if kind != "main"]
    if not blas or "main" not in by_kind:
        fail(f"forest: launch kinds {sorted(by_kind)}")
    checked = sum(r["checked"] for r in by_kind.values())
    outside = sum(r["id_mismatch_outside_ties"] for r in by_kind.values())
    if outside > TOLERANCE["id_mismatch_frac"] * checked:
        fail(f"forest launches: {outside} id mismatches outside ties in "
             f"{checked} checked lanes")
    results["kinds"] = by_kind
    results["blas"] = {key: sum(r[key] for r in blas) for key in (
        "launches", "lanes", "live", "checked", "ms", "bound_ms",
        "hit_mismatch", "id_mismatch_outside_ties", "ties", "overflows")}
    results["blas"]["live_share"] = (results["blas"]["live"]
                                     / max(results["blas"]["lanes"], 1))
    results["blas"]["max_abs_err"] = max(r["max_abs_err"] for r in blas)
    print("forest BLAS launches:", json.dumps(results["blas"]))
    return results, total


# Grid of the volume phase's cloud: a 256^3 density grid over the height
# field of utils/demo_scene.py, in the camera's view, at a density scale
# that gives the .vdb's default coefficients (sigma_s 8, sigma_a 0.5) an
# optical depth of a few across the box.
VOLUME_GRID = 256
VOLUME_BOX = ((-6.0, 1.0, -6.0), (6.0, 4.0, 2.0))
VOLUME_DENSITY_SCALE = 0.25
# The splat's border loss against its expected value, relative.
SPLAT_LOSS_RTOL = 0.05


def anyhit_launch_check(calls, rng, chunk=1 << 20, measure=True):
    """Each recorded any-hit launch (o, d, t_max, nodes, tris_bw) through
    the kernel, held against anyhit_plain on at most CHECK_LANES of its
    live lanes (0 occlusion mismatches; dead lanes unoccluded), with
    measure timed on the card alone beside its bound (walk_bound, live
    rays only); sums (ms and bound_ms None unmeasured)."""
    import functools

    from tracerboy_tpu_torch.trace import kernels, traverse
    from tracerboy_tpu_torch.utils.bench_traverse import (
        time_runs,
        walk_bound,
    )

    tot = dict(launches=0, lanes=0, live=0, checked=0, ms=0.0,
               plain_ms=0.0, bound_ms=0.0, bound_by=[], occ_mismatch=0,
               occluded=0, overflows=0, dead_lane_hits=0, max_abs_err=0.0)
    footprint = functools.partial(traverse.walk_footprint, any_hit=True)
    for o, d, tm, nodes, tris in calls:
        kernels.reset_counters()
        k = traverse.any_hit(o, d, tm, nodes, tris)
        overflows = kernels.stack_overflows()
        live_idx, sel = live_subset(tm, rng)
        p, plain_ms = timed_once(
            lambda: traverse.anyhit_plain(o[sel], d[sel], tm[sel], nodes,
                                          tris))
        _, st = check_anyhit(k[sel], p)
        ms, b_ms, b_by = 0.0, 0.0, "not measured"
        if measure:
            ms = float(np.median(time_runs(
                lambda: traverse.any_hit(o, d, tm, nodes, tris), 5,
                o.device, ahead=True)))
            b_ms, b_by, _, _ = walk_bound(o, d, tm, nodes, tris, footprint,
                                          1, chunk=chunk,
                                          live_rays_only=True)
        tot["launches"] += 1
        tot["lanes"] += o.shape[0]
        tot["live"] += live_idx.numel()
        tot["checked"] += st["rays"]
        tot["ms"] += ms
        tot["plain_ms"] += plain_ms
        tot["bound_ms"] += b_ms
        tot["bound_by"].append(b_by)
        tot["occ_mismatch"] += st["occ_mismatch"]
        tot["occluded"] += st["occluded"]
        tot["overflows"] += overflows
        tot["dead_lane_hits"] += int(k[tm <= 0].sum())
        tot["max_abs_err"] = max(tot["max_abs_err"], st["max_abs_err"])
        del k, p
    tot["live_share"] = tot["live"] / max(tot["lanes"], 1)
    if not measure:
        tot["ms"] = tot["bound_ms"] = None
    return tot


def closest_launch_summary(label, calls, rng):
    """textured_launch_check of recorded closest-hit launches of one kind,
    its sums; fatal unless every checked lane agrees with the plain
    version (TOLERANCE, and 0 id mismatches outside ties), dead lanes
    miss and no stack overflows."""
    by_kind, bad = textured_launch_check(calls, [label] * len(calls), rng)
    row = by_kind.get(label)
    if (bad or row is None or row["id_mismatch_outside_ties"]
            or row["overflows"] or row["dead_lane_hits"]):
        fail(f"{label} closest-hit launches: {row}, disagreeing {bad}")
    return row


class CudaSpans:
    """CUDA-event spans around every call of module attributes (a
    function that syncs inside still counts the card's idle time between
    its start and end events)."""

    def __init__(self, torch, targets):
        self.torch = torch
        self.targets = targets           # name -> (module, attribute)
        self.events = {name: [] for name in targets}
        self.real = {name: getattr(m, a) for name, (m, a) in targets.items()}

    def wrap(self, name):
        real = self.real[name]

        def spanned(*args, **kwargs):
            start = self.torch.cuda.Event(enable_timing=True)
            end = self.torch.cuda.Event(enable_timing=True)
            start.record()
            out = real(*args, **kwargs)
            end.record()
            self.events[name].append((start, end))
            return out
        return spanned

    def __enter__(self):
        for name, (m, a) in self.targets.items():
            setattr(m, a, self.wrap(name))
        return self

    def __exit__(self, *exc):
        for name, (m, a) in self.targets.items():
            setattr(m, a, self.real[name])

    def ms(self, name) -> float:
        self.torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events[name])


def volume_phase(torch):
    """volume_runs in a temporary directory that is removed after it."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="tb_vol_") as tmp:
        return volume_runs(torch, tmp)


def volume_runs(torch, tmp):
    """A heterogeneous volume through the CLI: utils/demo_scene.py's
    lit.pbrt (133,970 triangles, the .hdr sky, a distant and a point
    light) at 1280x720 with --env-nee on and --spp 4 (one merged wave of
    3,686,400 lanes) and --volume a 256^3 .vdb written here by the port's
    write_vdb (a procedural cloud over the height field; read back bit
    for bit). Every closest-hit launch (kernel 1, the walk's segment ends
    among them) and every any-hit launch (kernel 2: NEE shadow rays from
    surface and volume-scatter vertices, and the env-NEE shadow wave) of
    the run is recorded and held against its plain version on at most
    CHECK_LANES live lanes, timed beside its bound. Prints s a sample,
    Mrays/s, peak memory, the walk's steps per bounce, the device-time
    shares of the walk and the marches (CUDA events), and checks the
    image; then times the same CLI command without --volume (the
    control: the wave's device time without the medium). Returns
    (results, launches)."""
    from tracerboy_tpu_torch import renderer as renderer_mod
    from tracerboy_tpu_torch.app import cli
    from tracerboy_tpu_torch.scene.vdb import read_vdb, write_vdb
    from tracerboy_tpu_torch.scene.volume import procedural_cloud
    from tracerboy_tpu_torch.trace import kernels, traverse, wavefront
    from tracerboy_tpu_torch.utils.demo_scene import write_demo_scene

    set_opt_in()
    results = {}
    _, lit_scene = write_demo_scene(tmp)
    vol = procedural_cloud(VOLUME_GRID, seed=12)
    vol.density *= np.float32(VOLUME_DENSITY_SCALE)
    vol.lo = np.array(VOLUME_BOX[0], np.float32)
    vol.hi = np.array(VOLUME_BOX[1], np.float32)
    path = os.path.join(tmp, "cloud.vdb")
    t0 = time.perf_counter()
    write_vdb(path, vol)
    t1 = time.perf_counter()
    back = read_vdb(path)
    t2 = time.perf_counter()
    if not (np.array_equal(back.density, vol.density)
            and np.array_equal(back.lo, vol.lo)
            and np.array_equal(back.hi, vol.hi)):
        fail("volume: the .vdb does not read back bit for bit")
    results["vdb"] = dict(grid=list(vol.density.shape),
                          bytes=os.path.getsize(path), write_s=t1 - t0,
                          read_s=t2 - t1)
    print("volume .vdb:", json.dumps(results["vdb"]))
    del back

    size = f"{FULL_WAVE[0]}x{FULL_WAVE[1]}"
    recorded = {"any_hit": [], "closest_hit": []}
    real = {key: getattr(traverse, key) for key in recorded}
    real_init = renderer_mod.Renderer.__init__
    built, walk_steps = [], []
    real_walk = wavefront.delta_track

    def recorder(key):
        def recording(o, d, t_max, nodes, tris_bw, roots=None):
            if roots is not None:
                fail(f"volume run: a {key} launch with per-ray roots")
            recorded[key].append((o.clone(), d.clone(), t_max.clone(),
                                  nodes, tris_bw))
            return real[key](o, d, t_max, nodes, tris_bw)
        return recording

    def capturing_init(self, *args, **kwargs):
        real_init(self, *args, **kwargs)
        built.append(self)

    def counting_walk(scene, o, d, t_lim, active, rng2, steps):
        """The walk, counting its steps (its calls of rng2)."""
        walk_steps.append(0)

        def counted(k):
            walk_steps[-1] += 1
            return rng2(k)
        return real_walk(scene, o, d, t_lim, active, counted, steps)

    out = os.path.join(tmp, "volume.png")
    exr = os.path.join(tmp, "volume.exr")
    wavefront.delta_track = counting_walk
    spans = CudaSpans(torch, dict(
        wave=(renderer_mod, "render_wave_merged"),
        walk=(wavefront, "delta_track"),
        march=(wavefront, "transmittance")))
    kernels.reset_counters()
    torch.cuda.reset_peak_memory_stats()
    last = {}
    renderer_mod.Renderer.__init__ = capturing_init
    for key in recorded:
        setattr(traverse, key, recorder(key))
    try:
        with spans:
            rc = cli.main([lit_scene, "--size", size, "--spp", "4",
                           "--env-nee", "on", "--volume", path, "--out", out,
                           "--hdr-out", exr, "--quiet"], stats=last)
    finally:
        renderer_mod.Renderer.__init__ = real_init
        for key, fn in real.items():
            setattr(traverse, key, fn)
        wavefront.delta_track = real_walk
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    overflow = kernels.stack_overflows()
    if rc != 0 or len(built) != 1:
        fail(f"volume CLI: exit {rc}, {len(built)} renderers")
    r = built[0]
    cfg = r.wave_config()
    if not (cfg.has_volume and cfg.env_nee and cfg.num_lights > 0
            and r.traversal == "kernel" and last["spp"] == 4):
        fail(f"volume CLI: wave config {cfg}, {last['spp']} samples")
    mean = check_cli_outputs("volume", out, exr)
    check_image("volume", r.current_image())
    if launches["closest"] <= 0 or launches["anyhit"] <= 0 or overflow:
        fail(f"volume CLI: launches {launches}, {overflow} overflows")
    wave_ms = spans.ms("wave")
    walk_ms, march_ms = spans.ms("walk"), spans.ms("march")
    results["run"] = dict(
        render_seconds=last["seconds"], spp=last["spp"],
        s_per_sample=last["seconds"] / last["spp"],
        mrays_s=last["rays_traced"] / last["seconds"] / 1e6,
        radiance_mean=mean, launches=launches, stack_overflows=overflow,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        recorded_gib=sum(nbytes(*c[:3]) for calls in recorded.values()
                         for c in calls) / 2**30,
        wave_ms=wave_ms, walk_ms=walk_ms, march_ms=march_ms,
        walk_share=walk_ms / wave_ms, march_share=march_ms / wave_ms,
        walk_calls=len(spans.events["walk"]),
        march_calls=len(spans.events["march"]),
        walk_steps_per_bounce=walk_steps,
        vol_oct_gib=nbytes(r.scene["vol_oct"]) / 2**30,
        vol_majorant=float(r.scene["vol_majorant"]))
    print("volume CLI lit.pbrt + 256^3 .vdb:", json.dumps(results["run"]))
    del built, r

    # The control: the same command without the volume, its waves timed
    # by the same spans.
    control = CudaSpans(torch, dict(wave=(renderer_mod, "render_wave_merged")))
    plain = {}
    out, exr = (os.path.join(tmp, f"control.{e}") for e in ("png", "exr"))
    with control:
        rc = cli.main([lit_scene, "--size", size, "--spp", "4",
                       "--env-nee", "on", "--out", out, "--hdr-out", exr,
                       "--quiet"], stats=plain)
    if rc != 0 or plain["spp"] != 4:
        fail(f"volume control CLI: exit {rc}, {plain['spp']} samples")
    check_cli_outputs("volume control", out, exr)
    results["control"] = dict(
        render_seconds=plain["seconds"],
        s_per_sample=plain["seconds"] / plain["spp"],
        wave_ms=control.ms("wave"),
        waves=len(control.events["wave"]),
        volume_over_control=wave_ms / control.ms("wave"))
    print("volume control (the same command without --volume):",
          json.dumps(results["control"]))

    rng = np.random.default_rng(20261019)
    t0 = time.perf_counter()
    results["closest"] = closest_launch_summary(
        "volume", recorded.pop("closest_hit"), rng)
    results["anyhit"] = anyhit_launch_check(recorded.pop("any_hit"), rng)
    results["check_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    print("volume closest-hit launches:", json.dumps(results["closest"]))
    print("volume any-hit launches:", json.dumps(results["anyhit"]))
    a = results["anyhit"]
    if (a["launches"] == 0 or a["occ_mismatch"] or a["overflows"]
            or a["dead_lane_hits"]):
        fail(f"volume any-hit launches: {a}")
    return results, launches


def estimators_phase(torch, Renderer):
    """The JAX package's estimators on "shadertoy" at 1280x720 (kernel
    backend): (1) the tent splat, render_sample(8): finite image, and the
    folded filter weight sums to 8 N less what the film's border loses,
    within SPLAT_LOSS_RTOL of its expected value; (2) the adaptive
    burst render_sample_adaptive(8): the counts sum to the residual
    budget exactly, and the residual wave's closest-hit launches (lanes
    that repeat pixels) are held against the plain version on at most
    CHECK_LANES live lanes and timed beside their bound; (3) adaptive
    sampling: render_sample(64), which reaches ADAPTIVE_MIN_SPP, then
    render_sample(8) under the mask: masked-out pixels gain no filter
    weight; (4) one split_early = 1 merged 8-sample wave, clamp off:
    0 <= early <= total per channel to float tolerance, the early share
    of the total strictly between 0 and 1, and a second wave at
    split_early = max_bounces - 1 whose planes are bit-equal; (5) set_material,
    then render_sample(1). Seconds a sample of each. Returns (results,
    launches of the runs, counted from 0 before each)."""
    from dataclasses import replace

    from tracerboy_tpu_torch import renderer as renderer_mod
    from tracerboy_tpu_torch.trace import kernels, traverse
    from tracerboy_tpu_torch.trace.wavefront import render_wave_merged

    set_opt_in()
    results = {}
    total = dict.fromkeys(kernels.LAUNCHES, 0)
    w, h = FULL_WAVE
    N = w * h

    def renderer(**perf):
        r = Renderer("shadertoy", film_size=FULL_WAVE, device="cuda")
        if perf:
            r.settings = r.settings.replace(performance_settings=replace(
                r.settings.performance_settings, **perf))
        if r.traversal != "kernel":
            fail(f"estimators: traversal {r.traversal}")
        return r

    def timed(fn):
        kernels.reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        if kernels.stack_overflows():
            fail(f"estimators: {kernels.stack_overflows()} overflows")
        for k, v in launches.items():
            total[k] += v
        return out, dt, launches

    # (1) the tent splat.
    r = renderer()
    r.settings = r.settings.replace(camera_settings=replace(
        r.settings.camera_settings, filter_splat=True))
    if not r.wave_config().filter_splat:
        fail("estimators: filter_splat is off in the wave config")
    _, dt, launches = timed(lambda: r.render_sample(8))
    check_image("splat", r.current_image())
    fw_sum = float(r.state.accum[..., 3].double().sum())
    loss = 8 * N - fw_sum
    # A sample's tent weight past its pixel's outer edge is max(0, 0.5 -
    # j) for a jitter j uniform in [0, 1): 1/8 on average. Each edge pixel
    # loses that, a corner 1 - (7/8)^2 = 15/64.
    expected = 8 * ((2 * (w - 2) + 2 * (h - 2)) / 8.0 + 4 * 15 / 64.0)
    results["splat"] = dict(s_per_sample=dt / 8, fw_sum=fw_sum,
                            border_loss=loss, expected_loss=expected,
                            loss_rel_err=abs(loss - expected) / expected,
                            launches=launches)
    print("estimators splat render_sample(8):", json.dumps(results["splat"]))
    if not abs(loss - expected) <= SPLAT_LOSS_RTOL * expected:
        fail(f"splat: filter weight {fw_sum} is not 8 N = {8 * N} less the "
             f"border loss {expected} (within {SPLAT_LOSS_RTOL:.0%})")
    del r

    # (2) the adaptive burst; the residual wave's launches recorded.
    r = renderer()
    real_closest = traverse.closest_hit
    real_residual = renderer_mod.render_wave
    residual, in_residual = [], [False]

    def recording(o, d, t_max, nodes, tris_bw, roots=None):
        if in_residual[0]:
            residual.append((o.clone(), d.clone(), t_max.clone(), nodes,
                             tris_bw))
        return real_closest(o, d, t_max, nodes, tris_bw, roots=roots)

    def residual_wave(*args, **kwargs):
        in_residual[0] = True
        try:
            return real_residual(*args, **kwargs)
        finally:
            in_residual[0] = False

    traverse.closest_hit = recording
    renderer_mod.render_wave = residual_wave
    try:
        _, dt, launches = timed(lambda: r.render_sample_adaptive(8))
    finally:
        traverse.closest_hit = real_closest
        renderer_mod.render_wave = real_residual
    counts = r._last_adaptive_counts
    budget = (8 - 4) * N
    check_image("adaptive burst", r.current_image())
    results["adaptive_burst"] = dict(
        s_per_sample=dt / 8, budget=budget, counts_sum=int(counts.sum()),
        max_count=int(counts.max()), pixels_with_residual=int(
            (counts > 0).sum()), residual_lanes=int(counts.sum()),
        launches=launches, spp=r.state.spp)
    if int(counts.sum()) != budget or counts.min() < 0 or r.state.spp != 8:
        fail(f"adaptive burst: counts sum {counts.sum()} != budget "
             f"{budget} (or spp {r.state.spp})")
    del r
    rng = np.random.default_rng(20261020)
    results["adaptive_burst"]["closest"] = closest_launch_summary(
        "adaptive", residual, rng)
    del residual
    torch.cuda.empty_cache()
    print("estimators adaptive burst render_sample_adaptive(8):",
          json.dumps(results["adaptive_burst"]))

    # (3) adaptive sampling: warm up to ADAPTIVE_MIN_SPP, then a masked
    # 8-sample wave.
    r = renderer(enable_adaptive_sampling=True)
    _, dt64, _ = timed(lambda: r.render_sample(r.ADAPTIVE_MIN_SPP))
    mask = r.active_pixel_mask()
    if mask is None:
        fail("adaptive sampling: no mask at ADAPTIVE_MIN_SPP")
    fw_before = r.state.accum[..., 3].clone()
    _, dt8, launches = timed(lambda: r.render_sample(8))
    gained = (r.state.accum[..., 3] - fw_before).reshape(-1)
    off_gain = float(gained[~mask].abs().max()) if bool(
        (~mask).any()) else 0.0
    check_image("adaptive sampling", r.current_image())
    results["adaptive_sampling"] = dict(
        warmup_s_per_sample=dt64 / r.ADAPTIVE_MIN_SPP,
        s_per_sample=dt8 / 8, live_share=float(mask.float().mean()),
        masked_out_max_gain=off_gain, launches=launches)
    print("estimators adaptive sampling render_sample(64) + (8):",
          json.dumps(results["adaptive_sampling"]))
    if off_gain != 0.0 or not bool(mask.any()):
        fail(f"adaptive sampling: masked-out pixels gained filter weight "
             f"{off_gain} (live share {mask.float().mean()})")
    del r, fw_before, gained, mask

    # (4) split planes: one merged 8-sample wave, clamp off.
    r = renderer()
    cfg = replace(r.wave_config(), split_early=1)
    params = r.frame_params()
    if params["firefly_clamp"] != 0.0:
        fail("split planes: the firefly clamp is on")
    out, dt, launches = timed(lambda: render_wave_merged(
        r.scene, params, r.pixel_ids, 0, 8, cfg))
    tot, early = out["radiance"].double(), out["radiance_early"].double()
    tol = 1e-5 * tot.abs() + 1e-6
    below = int((early < -tol).sum())
    above = int((early > tot + tol).sum())
    share = float(early.sum() / tot.sum())
    # At split_early = max_bounces - 1 every contribution is early: the
    # planes must then be bit-equal (the JAX partition test's rule).
    last = replace(cfg, split_early=cfg.max_bounces - 1)
    out_all, _, _ = timed(lambda: render_wave_merged(
        r.scene, params, r.pixel_ids, 0, 8, last))
    same = bool(torch.equal(out_all["radiance_early"], out_all["radiance"]))
    results["split"] = dict(
        s_per_sample=dt / 8, early_share=share,
        below_zero=below, above_total=above,
        finite=bool(torch.isfinite(tot).all()
                    and torch.isfinite(early).all()), launches=launches,
        all_early_bit_equal=same)
    print("estimators split_early=1 8-sample wave:",
          json.dumps(results["split"]))
    if (below or above or not results["split"]["finite"]
            or not 0.0 < share < 1.0 or not same):
        fail(f"split planes do not partition the total: {results['split']}")
    del out, out_all, tot, early, tol

    # (5) a live material edit, then one sample.
    before = r.get_material(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.set_material(0, albedo=np.array([0.9, 0.1, 0.1], np.float32))
    torch.cuda.synchronize()
    edit_ms = (time.perf_counter() - t0) * 1e3
    _, dt, launches = timed(lambda: r.render_sample(1))
    check_image("set_material", r.current_image())
    got = r.scene["materials"]["albedo"][0].cpu().numpy()
    results["set_material"] = dict(
        edit_ms=edit_ms, s_per_sample=dt, spp=r.state.spp,
        albedo_before=before["albedo"].tolist(), albedo_after=got.tolist(),
        launches=launches)
    print("estimators set_material + render_sample(1):",
          json.dumps(results["set_material"]))
    if r.state.spp != 1 or not np.allclose(got, [0.9, 0.1, 0.1]):
        fail(f"set_material: {results['set_material']}")
    del r
    return results, total


# Animated geometry (animation_phase): the RealTime frames of a deforming
# mesh (each after a static one) and the sine field's amplitude, a share
# of the scene's extent.
ANIM_FRAMES, ANIM_SHARE = 8, 0.01
TURNTABLE_FRAMES = 3


def sine_field(torch, v0, v1, v2, phase, share=ANIM_SHARE):
    """Each vertex moved by a smooth sine field of `share` of the scene's
    extent, on the card (a function of position: shared vertices stay
    shared)."""
    lo = torch.minimum(torch.minimum(v0, v1), v2).amin(0)
    hi = torch.maximum(torch.maximum(v0, v1), v2).amax(0)
    ext = (hi - lo).max()
    k = 4.0 * np.pi / ext

    def move(p):
        return p + share * ext * torch.sin(k * p[:, [1, 2, 0]] + phase)

    return move(v0), move(v1), move(v2)


def build_launches(torch, fn):
    """torch.profiler of one call of fn: the kernel launches it issues
    (the CUDA runtime's launch calls), the device events (kernels, copies
    and fills), the host waits on the card (stream synchronisations and
    blocking copies), the device's busy time (the union of its events)
    and its span (first start to last end)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = prof.events()
    dev = sorted((e for e in evs if str(getattr(
        e, "device_type", "")).endswith("CUDA")),
        key=lambda e: e.time_range.start)
    busy, end = 0.0, float("-inf")
    for e in dev:
        if e.time_range.end > end:
            busy += e.time_range.end - max(e.time_range.start, end)
            end = e.time_range.end
    return dict(
        kernel_launches=sum(e.name.startswith(("cudaLaunchKernel",
                                               "cuLaunchKernel"))
                            for e in evs),
        device_events=len(dev),
        copies_and_fills=sum(("Memcpy" in e.name) or ("Memset" in e.name)
                             for e in dev),
        host_waits=sum(e.name in ("cudaStreamSynchronize", "cudaMemcpy")
                       for e in evs),
        device_busy_ms=busy / 1e3,
        device_span_ms=(dev[-1].time_range.end - dev[0].time_range.start)
        / 1e3 if dev else 0.0)


def rebuild_times(torch, r, v, runs=3):
    """The rebuild of update_geometry on vertices v, split into the main
    BVH's build, the shadow BVH's build and the two packs, then
    update_geometry itself and the host stack_need read of its two new
    node tables (the kernels' first launch on a table reads it): each the
    host's wall clock from a synchronised start to a synchronised end,
    the latency a frame waits (the card waits on the host's launches
    here; build_launches gives its busy time). Medians of `runs`."""
    from tracerboy_tpu_torch.accel import bvh_device as bd
    from tracerboy_tpu_torch.trace import traverse

    def wall(fn):
        out = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(out))

    so = r._shadow_idx
    sh = tuple(x[so] for x in v)
    built = bd.build_bvh_device(*v)
    built_sh = bd.build_bvh_device(*sh)
    res = dict(
        main_build_ms=wall(lambda: bd.build_bvh_device(*v)),
        shadow_build_ms=wall(lambda: bd.build_bvh_device(*sh)),
        pack_ms=wall(lambda: (bd.pack_for_pallas_device(built, *v),
                              bd.pack_for_pallas_device(built_sh, *sh))))
    walls, stacks = [], []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.update_geometry(*v)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        need = (traverse.stack_entries(r.scene["pk_nodes"]),
                traverse.stack_entries(r.scene["pk_sh_nodes"]))
        t2 = time.perf_counter()
        walls.append((t1 - t0) * 1e3)
        stacks.append((t2 - t1) * 1e3)
    res.update(update_geometry_ms=float(np.median(walls)),
               stack_need_read_ms=float(np.median(stacks)),
               stack_need=dict(main=need[0], shadow=need[1]),
               num_wide=dict(main=int(built["num_wide"]),
                             shadow=int(built_sh["num_wide"])),
               triangles=dict(main=int(v[0].shape[0]),
                              shadow=int(so.shape[0])))
    res["stack_need_share"] = res["stack_need_read_ms"] / (
        res["update_geometry_ms"] + res["stack_need_read_ms"])
    return res


def animation_phase(torch, Renderer, env_scene, forest):
    """Animated geometry: the on-device LBVH rebuild (accel/bvh_device.py)
    feeding kernels 1 and 2. (a) "shadertoy" at 1280x720: update_geometry
    with the load-time vertices on the kernel path, no host builder
    allowed to run; the new tables on the card; validate_bvh of the card's
    build (to_host_widebvh): 0 violations; every closest- and any-hit
    launch of one render_sample(1) held against its plain version on at
    most CHECK_LANES live lanes (0 id mismatches outside ties, 0 occlusion
    mismatches, 0 overflows); the render_sample(8) image against the same
    scene's render on the host-built tables (PARITY); a HEATMAP
    render_sample(1) through the stats kernel with no overflow; the
    launches of one rebuild (torch.profiler) and its split
    (rebuild_times). (b) ANIM_FRAMES RealTime frames, the vertices moved
    by sine_field before each render_realtime_frame_fused: each image
    finite in [0, 1]; ms per animated frame (rebuild, stack_need read,
    frame) against a static frame before each. (c) env.pbrt's rebuild
    timed the same way, a HEATMAP render after it. (d) forest (the
    instanced phase's renderer and object names): update_object_geometry
    on the tree, timed; the tree's BLAS launches of one render_sample(1)
    after it, tagged and held against the plain version (unmeasured: the
    instanced phase times such launches). (e)
    viewer.main's turntable of TURNTABLE_FRAMES 1280x720 PNGs of env.pbrt,
    then ViewerController on the card: w, m, a fused frame, m, o,
    render_sample(1), p, a click, ] on the clicked material. Returns
    (results, launches of the driven runs, counted from 0 before each)."""
    from tracerboy_tpu_torch import OutputSettings, RenderMode
    from tracerboy_tpu_torch.accel import bvh_device as bd
    from tracerboy_tpu_torch.accel import native, pack
    from tracerboy_tpu_torch.accel.validate import validate_bvh
    from tracerboy_tpu_torch.app import viewer
    from tracerboy_tpu_torch.core import image_io
    from tracerboy_tpu_torch.scene.compile import from_jax_pytree
    from tracerboy_tpu_torch.trace import kernels, traverse
    from tracerboy_tpu_torch.utils.config import OutputType

    set_opt_in()
    results = {}
    total = dict.fromkeys(kernels.LAUNCHES, 0)
    rng = np.random.default_rng(20261021)

    def driven(label, fn, stats=False):
        """fn() with the counts from 0; its launches added to the phase's
        total; fatal on a stack overflow."""
        kernels.reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        if kernels.stack_overflows():
            fail(f"animation {label}: {kernels.stack_overflows()} stack "
                 f"overflows")
        for k, v in launches.items():
            total[k] += v
        return out, dt, launches

    def no_host_build(*args, **kwargs):
        fail("animation: a host BVH builder ran during update_geometry")

    seconds, last = {}, [time.perf_counter()]

    def lap(part):
        now = time.perf_counter()
        seconds[part] = now - last[0]
        last[0] = now

    # (a) the identity rebuild on "shadertoy".
    r = Renderer("shadertoy", film_size=FULL_WAVE, device="cuda")
    if r.traversal != "kernel":
        fail(f"animation: traversal {r.traversal}")
    sc = r.scene
    v = tuple(sc[k].clone() for k in ("tri_v0", "tri_v1", "tri_v2"))
    host_need = (traverse.stack_need(sc["pk_nodes"]),
                 traverse.stack_need(sc["pk_sh_nodes"]))
    real_build = (native.build_bvh_native, pack.pack_scene)
    native.build_bvh_native = pack.pack_scene = no_host_build
    try:
        r.update_geometry(*v)
        torch.cuda.synchronize()
    finally:
        native.build_bvh_native, pack.pack_scene = real_build
    keys = ("pk_nodes", "pk_tris_bw", "pk_tri_map", "pk_attr_rows",
            "pk_sh_nodes", "pk_sh_tris_bw", "pk_sh_tri_map",
            "pk_sh_attr_rows", "tri9", "tri_attr_rows", "tri_attr_t")
    off_card = [k for k in keys if r.scene[k].device.type != "cuda"]
    if off_card:
        fail(f"animation: tables off the card after the rebuild: {off_card}")
    built = bd.build_bvh_device(*v)
    dev_nodes = r.scene["pk_nodes"]
    if not torch.equal(bd.pack_for_pallas_device(built, *v)["nodes"],
                       dev_nodes):
        fail("animation: the renderer's rebuilt nodes are not the build's")
    vh = [x.cpu().numpy() for x in v]
    t0 = time.perf_counter()
    violations = validate_bvh(bd.to_host_widebvh(built, vh[0].shape[0]),
                              *vh)
    results["validate"] = dict(
        violations=len(violations), first=violations[:3],
        num_wide=int(built["num_wide"]), rows=int(dev_nodes.shape[0]),
        seconds=time.perf_counter() - t0,
        stack_need_host_tree=dict(main=host_need[0], shadow=host_need[1]),
        stack_need_device_tree=dict(
            main=traverse.stack_need(dev_nodes),
            shadow=traverse.stack_need(r.scene["pk_sh_nodes"])))
    print("animation shadertoy identity rebuild:",
          json.dumps(results["validate"]))
    if violations:
        fail(f"animation: validate_bvh of the card's build: {violations[:5]}")
    del built

    recorded = {"closest_hit": [], "any_hit": []}
    real = {key: getattr(traverse, key) for key in recorded}

    def recorder(key):
        def recording(o, d, t_max, nodes, tris_bw, roots=None):
            if roots is not None:
                fail(f"animation: a {key} launch with per-ray roots")
            recorded[key].append((o.clone(), d.clone(), t_max.clone(),
                                  nodes, tris_bw))
            return real[key](o, d, t_max, nodes, tris_bw)
        return recording

    for key in recorded:
        setattr(traverse, key, recorder(key))
    try:
        _, dt1, launches1 = driven("render_sample(1)",
                                   lambda: r.render_sample(1))
    finally:
        for key, fn in real.items():
            setattr(traverse, key, fn)
    if launches1["closest"] <= 0 or launches1["anyhit"] <= 0:
        fail(f"animation render_sample(1): launches {launches1}")
    r.invalidate_history()
    _, dt8, _ = driven("render_sample(8)", lambda: r.render_sample(8))
    img_dev = r.state.accum.cpu().numpy()
    check_image("animation rebuilt", r.current_image())
    # The same scene (the update's flat normals) on the host-built tables.
    host = from_jax_pytree(r.compiled.packed_tables(
        r.scene["tri_attr_rows"].cpu().numpy()), "cuda")
    saved = {k: r.scene[k] for k in host}
    r.scene.update(host)
    r.invalidate_history()
    _, dt8h, _ = driven("render_sample(8) host tables",
                        lambda: r.render_sample(8))
    img_host = r.state.accum.cpu().numpy()
    r.scene.update(saved)
    r.invalidate_history()
    close = float((np.abs(img_dev - img_host) <= PARITY["pixel_atol"]
                   * (1 + np.abs(img_host))).all(-1).mean())
    mean_rel = abs(img_dev.mean() - img_host.mean()) / abs(img_host.mean())
    results["parity"] = dict(pixels_within=close, mean_rel=float(mean_rel),
                             s_per_sample=dt8 / 8,
                             host_tables_s_per_sample=dt8h / 8,
                             render_sample_1_s=dt1)
    print("animation render_sample(8), device-built vs host-built tables:",
          json.dumps(results["parity"]))
    if close < PARITY["pixel_frac"] or mean_rel > PARITY["mean_rel"]:
        fail(f"animation: device-built tables outside {PARITY}: "
             f"{results['parity']}")
    del saved, host, img_dev, img_host

    def heatmap(rr, label):
        rr.settings = rr.settings.replace(output_type=OutputType.HEATMAP)
        rr.invalidate_history()
        _, _, hl = driven(f"{label} HEATMAP", lambda: rr.render_sample(1))
        check_image(f"animation {label} HEATMAP", rr.current_image())
        rr.settings = rr.settings.replace(output_type=OutputType.LIT)
        if hl["closest_stats"] != 1:
            fail(f"animation {label} HEATMAP: launches {hl}")
        return dict(launches=hl, stack_depth=traverse.STACK_DEPTH,
                    stack_need=traverse.stack_need(rr.scene["pk_nodes"]))

    results["heatmap_shadertoy"] = heatmap(r, "shadertoy")
    results["launches_per_build"] = build_launches(
        torch, lambda: bd.build_bvh_device(*v))
    results["launches_per_update"] = build_launches(
        torch, lambda: r.update_geometry(*v))
    results["rebuild_shadertoy"] = rebuild_times(torch, r, v)
    lap("a")
    print("animation shadertoy rebuild:", json.dumps(
        {k: results[k] for k in ("heatmap_shadertoy", "launches_per_build",
                                 "launches_per_update",
                                 "rebuild_shadertoy")}))

    # (e, part) the viewer's controller on this renderer, on the card.
    captures = []
    ctl = viewer.ViewerController(r, capture_writer=captures.append)
    pos = r.compiled.camera.position.copy()
    did = [ctl.on_key("w"), ctl.on_key("m")]
    frame_img, _, _ = driven("controller RealTime frame",
                             lambda: r.render_realtime_frame_fused(
                                 as_numpy=True))
    check_image("controller RealTime frame", frame_img)
    did += [ctl.on_key("m"), ctl.on_key("o")]
    driven("controller render_sample(1)", lambda: r.render_sample(1))
    did.append(ctl.on_key("p"))
    info = ctl.on_click(FULL_WAVE[0] // 2, FULL_WAVE[1] // 2)
    if not info:
        fail("animation viewer controller: the click selected nothing")
    alb = np.array(r.get_material(ctl.selected_mat)["albedo"])
    did.append(ctl.on_key("]"))
    alb_after = np.array(r.get_material(ctl.selected_mat)["albedo"])
    results["controller"] = dict(
        keys=did, moved=float(np.linalg.norm(r.compiled.camera.position
                                             - pos)),
        output_type=r.settings.output_type.name, captures=len(captures),
        material=info["material_id"],
        albedo=[alb.tolist(), alb_after.tolist()])
    print("animation viewer controller:", json.dumps(results["controller"]))
    if (did != ["camera", "mode", "mode", "aov", "capture", "material"]
            or not results["controller"]["moved"] > 0 or len(captures) != 1
            or not np.allclose(alb_after, np.clip(alb * 1.25, 0, 1),
                               atol=1e-6)):
        fail(f"animation viewer controller: {results['controller']}")
    check_image("animation viewer capture", captures[0])
    del ctl, captures, r

    # The recorded launches of (a)'s render_sample(1) against the plain
    # versions.
    t0 = time.perf_counter()
    closest = closest_launch_summary("animation", recorded.pop(
        "closest_hit"), rng)
    anyhit = anyhit_launch_check(recorded.pop("any_hit"), rng)
    results["check_s"] = time.perf_counter() - t0
    print("animation closest-hit launches vs plain:", json.dumps(closest))
    print("animation any-hit launches vs plain:", json.dumps(anyhit))
    if (not anyhit["launches"] or anyhit["occ_mismatch"]
            or anyhit["overflows"] or anyhit["dead_lane_hits"]):
        fail(f"animation any-hit launches: {anyhit}")
    results["closest"], results["anyhit"] = closest, anyhit
    torch.cuda.empty_cache()
    lap("a_controller_and_checks")

    # (b) RealTime frames of the deforming mesh.
    rt = Renderer("shadertoy", film_size=FULL_WAVE, device="cuda",
                  settings=OutputSettings(render_mode=RenderMode.REAL_TIME))
    base = tuple(rt.scene[k].clone() for k in ("tri_v0", "tri_v1",
                                               "tri_v2"))

    def rt_frame(label):
        img, dt, _ = driven(label, lambda: rt.render_realtime_frame_fused(
            as_numpy=False))
        check_image(label, img.cpu().numpy())
        return dt * 1e3

    for i in range(2):
        rt_frame(f"animation static warm-up {i}")
    # A static frame before each animated one, so that both run at the
    # same point of the governor's and the adaptive mask's warm-up.
    static, frames = [], []
    for f in range(ANIM_FRAMES):
        static.append(rt_frame(f"animation static {f}"))
        moved = sine_field(torch, *base, phase=0.5 + 0.7 * f)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rt.update_geometry(*moved)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        traverse.stack_entries(rt.scene["pk_nodes"])
        traverse.stack_entries(rt.scene["pk_sh_nodes"])
        t2 = time.perf_counter()
        frame_ms = rt_frame(f"animation frame {f}")
        frames.append(dict(update_ms=(t1 - t0) * 1e3,
                           stack_need_ms=(t2 - t1) * 1e3,
                           frame_ms=frame_ms,
                           total_ms=(t2 - t0) * 1e3 + frame_ms))
    med = {k: float(np.median([x[k] for x in frames])) for k in frames[0]}
    results["realtime"] = dict(
        frames=ANIM_FRAMES, static_frame_ms=float(np.median(static)),
        animated=med, per_frame=frames,
        rebuild_share_of_animated_frame=(med["update_ms"]
                                         + med["stack_need_ms"])
        / med["total_ms"])
    print(f"animation RealTime {FULL_WAVE[0]}x{FULL_WAVE[1]}, "
          f"{ANIM_FRAMES} deforming frames:",
          json.dumps(results["realtime"]))
    del rt, base
    torch.cuda.empty_cache()
    lap("b")

    # (c) env.pbrt: the second point on the triangle axis.
    re = Renderer(env_scene, film_size=FULL_WAVE, device="cuda")
    if re.traversal != "kernel":
        fail(f"animation env: traversal {re.traversal}")
    ve = sine_field(torch, *(re.scene[k] for k in ("tri_v0", "tri_v1",
                                                   "tri_v2")), phase=0.5)
    re.update_geometry(*ve)
    results["rebuild_env"] = rebuild_times(torch, re, ve)
    results["heatmap_env"] = heatmap(re, "env")
    results["launches_per_build_env"] = build_launches(
        torch, lambda: bd.build_bvh_device(*ve))
    print("animation env.pbrt rebuild:", json.dumps(
        {k: results[k] for k in ("rebuild_env", "heatmap_env",
                                 "launches_per_build_env")}))
    del re, ve
    lap("c")

    # (d) the forest's tree: one object's BLAS rebuilt on the card.
    rf, names = forest
    obj = names.index("tree")
    verts = torch.from_numpy(rf.compiled.inst_objects[obj]["verts"]).cuda()
    walls = []
    for f in range(3):
        vo = sine_field(torch, verts[:, 0], verts[:, 1], verts[:, 2],
                        phase=0.5 + f)
        _, dt, _ = driven("update_object_geometry",
                          lambda: rf.update_object_geometry(obj, *vo))
        walls.append(dt * 1e3)
    real_closest = traverse.closest_hit
    records = []

    def recording(o, d, t_max, nodes, tris_bw, roots=None):
        live = torch.nonzero(t_max > 0)[:, 0]
        records.append((o.shape[0], live, o[live], d[live], t_max[live],
                        nodes, tris_bw))
        return real_closest(o, d, t_max, nodes, tris_bw, roots=roots)

    traverse.closest_hit = recording
    try:
        _, dtf, fl = driven("forest render_sample(1)",
                            lambda: rf.render_sample(1))
    finally:
        traverse.closest_hit = real_closest
    check_image("animation forest", rf.current_image())
    # The rebuilt object's BLAS launches (the tree's) against the plain
    # version (the instanced phase times such launches beside their bound).
    kinds = tag_instanced_launches(records, rf.scene, names)
    tree = [(rec, kind) for rec, kind in zip(records, kinds)
            if kind.endswith("_tree")]
    del records
    by_kind, bad = textured_launch_check(
        (expand_launch(rec) for rec, _ in tree), [k for _, k in tree], rng,
        measure=False)
    del tree
    blas = list(by_kind.values())
    if bad or not blas:
        fail(f"animation forest tree launches: kinds {sorted(by_kind)}, "
             f"disagreeing {bad}")
    results["forest"] = dict(
        tree_triangles=int(verts.shape[0]),
        update_object_geometry_ms=walls,
        render_sample_1_s=dtf, launches=fl,
        blas={key: sum(row[key] for row in blas) for key in (
            "launches", "lanes", "live", "checked", "hit_mismatch",
            "id_mismatch_outside_ties", "ties", "overflows")})
    results["forest"]["blas"]["max_abs_err"] = max(
        row["max_abs_err"] for row in blas)
    results["forest"]["blas"]["live_share"] = (
        results["forest"]["blas"]["live"]
        / max(results["forest"]["blas"]["lanes"], 1))
    print("animation forest tree rebuild:", json.dumps(results["forest"]))
    if results["forest"]["blas"]["id_mismatch_outside_ties"]:
        fail(f"animation forest BLAS launches: {results['forest']}")
    del rf, verts
    torch.cuda.empty_cache()
    lap("d")

    # (e) the viewer's headless turntable on env.pbrt.
    out_dir = os.path.join(os.path.dirname(env_scene), "turntable")
    _, dtt, _ = driven("turntable", lambda: viewer.main([
        env_scene, "--turntable", str(TURNTABLE_FRAMES), "--size",
        f"{FULL_WAVE[0]}x{FULL_WAVE[1]}", "--spp", "1", "--out-dir",
        out_dir]))
    pngs = sorted(os.listdir(out_dir))
    if len(pngs) != TURNTABLE_FRAMES:
        fail(f"turntable: {pngs}")
    for name in pngs:
        check_image(f"turntable {name}",
                    image_io.read_ldr(os.path.join(out_dir, name)))
    results["turntable"] = dict(pngs=pngs, seconds=dtt)
    print("animation turntable:", json.dumps(results["turntable"]))
    lap("e")
    results["seconds"] = seconds
    print("animation parts, seconds:", json.dumps(seconds))
    return results, total


# The ML extras (ml_phase): the fine-tune's dataset, training and the
# upscalers, sized to stay cheap.
ML_DATASET = dict(film=(512, 320), n_views=4, input_spp=8, target_spp=64,
                  inputs_per_view=2)
ML_TRAIN = dict(steps=200, batch=4, lr=1e-4, holdout_views=1)
ML_CLI_SIZE = (640, 360)


def write_superres_weights(path, seed):
    """A weights.bin of the super-resolution network (int32 count, then
    per tensor u32 name length, name, u32 float count, float32 data):
    He-scaled random kernels, BatchNorm scale and shift on the ReLU
    layers but conv_up1/conv."""
    import struct

    from tracerboy_tpu_torch.ml.superres import _LAYERS

    rng = np.random.default_rng(seed)
    tensors = {}
    for name, k, cin, cout, relu, _up in _LAYERS:
        gain = 1.0 if relu else 0.3
        tensors[f"{name}/weights"] = (
            rng.normal(size=k * k * cin * cout) * gain
            * np.sqrt(2.0 / (k * k * cin))).astype(np.float32)
        if relu and name != "conv_up1/conv":
            tensors[f"{name}/BatchNorm/scale"] = rng.uniform(
                0.5, 1.5, cout).astype(np.float32)
            tensors[f"{name}/BatchNorm/shift"] = (
                rng.normal(size=cout) * 0.05).astype(np.float32)
    blob = bytearray(struct.pack("<i", len(tensors)))
    for name, arr in tensors.items():
        blob += struct.pack("<I", len(name)) + name.encode("ascii")
        blob += struct.pack("<I", arr.size) + arr.astype("<f4").tobytes()
    Path(path).write_bytes(bytes(blob))


class LaunchRecorder:
    """While active (a with block), every closest_hit (kernel 1) and
    any_hit (kernel 2) launch goes through the kernel and keeps a seeded
    draw of at most CHECK_LANES of its live lanes (live_subset) with the
    kernel's outputs there, and counts hits on dead lanes; check() then
    holds each launch against its plain version."""

    KEYS = ("closest_hit", "any_hit")

    def __init__(self, label, rng):
        self.label, self.rng = label, rng
        self.recorded = {key: [] for key in self.KEYS}
        self.dead_hits = 0

    def __enter__(self):
        from tracerboy_tpu_torch.trace import traverse

        self.real = {key: getattr(traverse, key) for key in self.KEYS}
        for key in self.KEYS:
            setattr(traverse, key, self._recorder(key))
        return self

    def __exit__(self, *exc):
        from tracerboy_tpu_torch.trace import traverse

        for key, fn in self.real.items():
            setattr(traverse, key, fn)
        return False

    def _recorder(self, key):
        def recording(o, d, t_max, nodes, tris_bw, roots=None):
            if roots is not None:
                fail(f"{self.label}: a {key} launch with per-ray roots")
            out = self.real[key](o, d, t_max, nodes, tris_bw)
            live_idx, sel = live_subset(t_max, self.rng)
            dead = t_max <= 0
            if key == "closest_hit":
                self.dead_hits += int((out[1][dead] >= 0).sum())
                k = tuple(x[sel] for x in out)
            else:
                self.dead_hits += int(out[dead].sum())
                k = out[sel]
            self.recorded[key].append(dict(
                o=o[sel], d=d[sel], tm=t_max[sel], k=k, nodes=nodes,
                tris=tris_bw, lanes=o.shape[0], live=live_idx.numel()))
            return out
        return recording

    def check(self, launches, overflows):
        """Each recorded launch against its plain version: check_closest's
        TOLERANCE with every id mismatch outside ties explained by the
        kernel's box cull, 0 occlusion mismatches, no hit on a dead lane,
        0 stack overflows, and as many recorded launches as the counters
        (launches) saw. Returns the (closest, anyhit) sums; fails
        otherwise."""
        from tracerboy_tpu_torch.trace import traverse

        closest = dict(launches=0, lanes=0, live=0, checked=0,
                       hit_mismatch=0, id_mismatch_outside_ties=0, ties=0,
                       max_rel_t_err=0.0, max_abs_err=0.0, outside_ties=[])
        anyhit = dict(launches=0, lanes=0, live=0, checked=0,
                      occ_mismatch=0, occluded=0, max_abs_err=0.0)
        bad = 0
        for rec in self.recorded["closest_hit"]:
            p = traverse.closest_hit_plain(rec["o"], rec["d"], rec["tm"],
                                           rec["nodes"], rec["tris"])
            ok, st = check_closest(rec["o"], rec["d"],
                                   (rec["nodes"], rec["tris"]), rec["k"], p)
            # An id mismatch outside ties is explained when the kernel
            # culled the twin's box by its own slab arithmetic: the box's
            # entry t not below the kernel's hit (check_closest lists up
            # to 4 a launch).
            listed = st.get("outside_ties", [])
            explained = [r for r in listed
                         if r["box_t_near_twin"] >= r["t_kernel"]]
            closest["outside_ties"] += listed
            bad += (not ok
                    or len(explained) != st["id_mismatch_outside_ties"])
            closest["launches"] += 1
            for key in ("lanes", "live"):
                closest[key] += rec[key]
            closest["checked"] += st["rays"]
            for key in ("hit_mismatch", "id_mismatch_outside_ties", "ties"):
                closest[key] += st[key]
            for key in ("max_rel_t_err", "max_abs_err"):
                closest[key] = max(closest[key], st[key])
        for rec in self.recorded["any_hit"]:
            p = traverse.anyhit_plain(rec["o"], rec["d"], rec["tm"],
                                      rec["nodes"], rec["tris"])
            _, st = check_anyhit(rec["k"], p)
            bad += st["occ_mismatch"] > 0
            anyhit["launches"] += 1
            for key in ("lanes", "live"):
                anyhit[key] += rec[key]
            anyhit["checked"] += st["rays"]
            for key in ("occ_mismatch", "occluded"):
                anyhit[key] += st[key]
            anyhit["max_abs_err"] = max(anyhit["max_abs_err"],
                                        st["max_abs_err"])
        self.recorded = {key: [] for key in self.KEYS}
        for row in (closest, anyhit):
            row["live_share"] = row["live"] / max(row["lanes"], 1)
            row["overflows"] = overflows
        closest["outside_ties_explained"] = sum(
            r["box_t_near_twin"] >= r["t_kernel"]
            for r in closest["outside_ties"])
        print(f"{self.label} closest-hit launches:", json.dumps(closest))
        print(f"{self.label} any-hit launches:", json.dumps(anyhit))
        if (bad or overflows or self.dead_hits
                or closest["launches"] != launches.get("closest", 0)
                or anyhit["launches"] != launches.get("anyhit", 0)):
            fail(f"{self.label} launches: {bad} disagree with the plain "
                 f"version, {overflows} overflows, {self.dead_hits} "
                 f"dead-lane hits, counters {launches}")
        return closest, anyhit


def ml_phase(torch):
    """ml_runs in a temporary directory that is removed after it."""
    with tempfile.TemporaryDirectory(prefix="tb_ml_") as tmp:
        return ml_runs(torch, tmp)


def ml_runs(torch, tmp):
    """The ML extras on the card. (a) make_dataset on "shadertoy" at
    512x320 (4 orbit views, each a 64-spp target and two 8-spp inputs):
    every closest-hit and any-hit launch of its renders recorded, each
    held against its plain version on at most CHECK_LANES live lanes
    (TOLERANCE, every id mismatch outside ties explained by the kernel's
    box cull, 0 occlusion mismatches, dead lanes miss, 0 overflows); s a
    sample. (b) finetune from the committed
    rt_ldr_ft.npz, 200 steps of batch 4 at full frame, lr 1e-4: every
    loss and the holdout L2 before and after finite; ms a training step
    (CUDA-event spans of train_step, steps 10-199) and peak memory; the
    written .npz loads back through load_params_npz and denoises the
    held-out frame to a finite image. (c) fsr_upscale and upscale2x (a
    seeded random weights.bin) of the slice's 1280x720 image to
    2560x1440, with their ms; FSR's output is NaN exactly where the
    reference's RCAS divides 0 by 0 (a pixel and its four neighbours
    all exactly 1: ROADMAP.md Queue 3) and in [0, 1] elsewhere. (d) the
    CLI on lit.pbrt at 640x360, 2 spp, --upscale fsr: a 1280x720 PNG.
    Returns (results, launches of (a))."""
    from tracerboy_tpu_torch import Renderer
    from tracerboy_tpu_torch.app import cli
    from tracerboy_tpu_torch.ml import finetune as ft
    from tracerboy_tpu_torch.ml import fsr, superres
    from tracerboy_tpu_torch.ml.oidn import denoise_image
    from tracerboy_tpu_torch.trace import kernels
    from tracerboy_tpu_torch.utils.demo_scene import write_demo_scene

    set_opt_in()
    results = {}
    rng = np.random.default_rng(20261020)

    # (a) the dataset's renders, their launches recorded on a subset.
    data = os.path.join(tmp, "pairs.npz")
    ds = ML_DATASET
    samples = ds["n_views"] * (ds["target_spp"]
                               + ds["inputs_per_view"] * ds["input_spp"])
    logs = []
    kernels.reset_counters()
    with LaunchRecorder("ml dataset", rng) as recorder:
        t0 = time.perf_counter()
        ft.make_dataset("shadertoy", data, seed=1, progress=logs.append,
                        **ds)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    overflows = kernels.stack_overflows()
    if launches.get("closest", 0) <= 0 or launches.get("anyhit", 0) <= 0:
        fail(f"ml dataset: launches {launches}")
    with np.load(data) as z:
        shapes = {key: (list(z[key].shape), str(z[key].dtype))
                  for key in z.files}
        finite = all(np.isfinite(z[key]).all() for key in ("inp", "tgt"))
        tgt_mean = float(z["tgt"].astype(np.float32).mean())
    n_pairs = ds["n_views"] * ds["inputs_per_view"]
    film_hw = [ds["film"][1], ds["film"][0], 3]
    want = ([n_pairs, *film_hw], "float16")
    if shapes["inp"] != want or shapes["tgt"] != want or not finite:
        fail(f"ml dataset: arrays {shapes}, finite {finite}")
    t1 = time.perf_counter()
    closest, anyhit = recorder.check(launches, overflows)
    results["dataset"] = dict(
        seconds=seconds, samples=samples, s_per_sample=seconds / samples,
        launches=launches, stack_overflows=overflows,
        dead_lane_hits=recorder.dead_hits, arrays=shapes, tgt_mean=tgt_mean,
        check_s=time.perf_counter() - t1)
    results["closest"], results["anyhit"] = closest, anyhit
    print("ml dataset (make_dataset shadertoy 512x320, 4 views):",
          json.dumps(results["dataset"]))

    # (b) the fine-tune from the committed weights, each step spanned.
    init = ft.load_params_npz(str(UNET_WEIGHTS)).to("cuda")
    out_npz = os.path.join(tmp, "ft.npz")
    real_step, step_losses, step_events = ft.train_step, [], []

    def spanned_step(*args):
        """train_step between two CUDA events; its loss kept on the card."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = real_step(*args)
        end.record()
        step_events.append((start, end))
        step_losses.append(loss)
        return loss

    logs = []
    torch.cuda.reset_peak_memory_stats()
    ft.train_step = spanned_step
    try:
        t0 = time.perf_counter()
        h0, h1 = ft.finetune(data, out_npz, init_tza=init, seed=0,
                             log_every=50, progress=logs.append, **ML_TRAIN)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    finally:
        ft.train_step = real_step
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = torch.stack(step_losses).cpu().tolist()
    step_ms = [s.elapsed_time(e) for s, e in step_events]
    if not (len(losses) == ML_TRAIN["steps"] == len(step_ms)
            and np.isfinite(losses).all() and np.isfinite([h0, h1]).all()):
        fail(f"ml fine-tune: {len(losses)} losses, {len(step_ms)} steps, "
             f"finite {np.isfinite(losses).all()}, holdout {h0} -> {h1}")
    with np.load(data) as z:
        hold = z["view"] >= z["view"].max() + 1 - ML_TRAIN["holdout_views"]
        x = ft._net_space(z["inp"][hold][:1], z["expo"][hold][:1], "cuda")[0]
    net = ft.load_params_npz(out_npz).to("cuda")
    den = denoise_image(net, x)
    torch.cuda.synchronize()
    if den.shape != x.shape or not bool(torch.isfinite(den).all()):
        fail(f"ml fine-tune: the reloaded weights denoise to {den.shape}, "
             f"finite {bool(torch.isfinite(den).all())}")
    results["finetune"] = dict(
        steps=len(losses), batch=ML_TRAIN["batch"], lr=ML_TRAIN["lr"],
        holdout_before=h0, holdout_after=h1, loss_first=losses[0],
        loss_last=losses[-1], loss_mean_first10=float(np.mean(losses[:10])),
        loss_mean_last10=float(np.mean(losses[-10:])),
        step_ms_median=float(np.median(step_ms[10:])),
        step_ms_quartiles=[float(q) for q in
                           np.percentile(step_ms[10:], [25, 75])],
        step_ms_first=step_ms[0], seconds=train_s, peak_gib=peak,
        reload_denoise_mean=float(den.mean()))
    print("ml fine-tune (rt_ldr_ft.npz, 200 steps):",
          json.dumps(results["finetune"]))
    del init, net, den, x

    # (c) the upscalers on the slice's 1280x720 image.
    r = Renderer("shadertoy", film_size=FULL_WAVE, device="cuda")
    r.render_sample(8)
    img = torch.from_numpy(r.current_image()).to("cuda")
    del r
    out_hw = (2 * FULL_WAVE[1], 2 * FULL_WAVE[0], 3)
    up = fsr.fsr_upscale(img)
    easu = torch.clamp(fsr.easu_upscale(img, *out_hw[:2]), 0.0, 1.0)
    one = easu == 1.0
    plateau = (one & one.roll(1, 0) & one.roll(-1, 0) & one.roll(1, 1)
               & one.roll(-1, 1))
    nan = torch.isnan(up)
    ok = (tuple(up.shape) == out_hw and bool(torch.equal(nan, plateau))
          and float(up[~nan].min()) >= 0 and float(up[~nan].max()) <= 1)
    results["fsr"] = dict(
        shape=list(up.shape), undefined_plateau_values=int(plateau.sum()),
        ms=cuda_ms(lambda: fsr.fsr_upscale(img), 10))
    if not ok:
        fail(f"ml FSR: {results['fsr']}, NaN {int(nan.sum())} against "
             f"{int(plateau.sum())} plateau values")
    weights = os.path.join(tmp, "weights.bin")
    write_superres_weights(weights, seed=7)
    sr = superres.load_superres(weights).to("cuda")
    up2 = superres.upscale2x(sr, img)
    torch.cuda.synchronize()
    results["superres"] = dict(
        shape=list(up2.shape), mean=float(up2.mean()),
        ms=cuda_ms(lambda: superres.upscale2x(sr, img), 5))
    if (tuple(up2.shape) != out_hw or not bool(torch.isfinite(up2).all())
            or float(up2.min()) < 0 or float(up2.max()) > 1):
        fail(f"ml superres: {results['superres']}")
    print("ml upscalers (1280x720 -> 2560x1440):",
          json.dumps({k: results[k] for k in ("fsr", "superres")}))
    del up, up2, easu, sr, img

    # (d) the CLI's --upscale fsr.
    _, lit_scene = write_demo_scene(tmp)
    png = os.path.join(tmp, "upscaled.png")
    t0 = time.perf_counter()
    rc = cli.main([lit_scene, "--size", "x".join(map(str, ML_CLI_SIZE)),
                   "--spp", "2", "--upscale", "fsr", "--out", png,
                   "--quiet"])
    w, h, ctype, _ = png_facts(png)
    results["cli"] = dict(rc=rc, png=[w, h], colour_type=ctype,
                          seconds=time.perf_counter() - t0)
    print("ml CLI lit.pbrt 640x360 --upscale fsr:", json.dumps(results["cli"]))
    if rc != 0 or (w, h) != (2 * ML_CLI_SIZE[0], 2 * ML_CLI_SIZE[1]):
        fail(f"ml CLI --upscale fsr: {results['cli']}")
    torch.cuda.empty_cache()
    return results, launches


SHARD_ODD_FILM = (1279, 719)   # (N + pad) % 2 == 0 with pad 1
JPEG_DIR = Path(__file__).resolve().parent / "tests" / "data" / "jpeg"
DDS_DIR = Path(__file__).resolve().parent / "tests" / "data" / "dds"
TIFF_DIR = Path(__file__).resolve().parent / "tests" / "data" / "tiff"
WEBP_DIR = Path(__file__).resolve().parent / "tests" / "data" / "webp"
J2K_DIR = Path(__file__).resolve().parent / "tests" / "data" / "j2k"
AVIF_DIR = Path(__file__).resolve().parent / "tests" / "data" / "avif"
SMALL_DIR = Path(__file__).resolve().parent / "tests" / "data" / "small"
SMALL2_DIR = Path(__file__).resolve().parent / "tests" / "data" / "small2"
SMALL3_DIR = Path(__file__).resolve().parent / "tests" / "data" / "small3"
WRITE_DIR = Path(__file__).resolve().parent / "tests" / "data" / "write"


def spp_reference(r, D, n):
    """The accumulator sample of Renderer(shard="spp") on a mesh of D
    entries for render_sample(n) from spp 0, traced unsharded on r: entry
    i's waves (one merged wave of spd = ceil(n / D) samples at base i *
    spd while that fits, else spd single-sample waves), summed in mesh
    order."""
    import torch

    from tracerboy_tpu_torch.renderer import MERGED_WAVE_LANES
    from tracerboy_tpu_torch.trace.wavefront import (
        render_wave,
        render_wave_merged,
    )

    cfg, params, ids = r.wave_config(), r.frame_params(), r.pixel_ids
    spd = -(-n // D)
    merged = spd > 1 and spd * ids.shape[0] <= MERGED_WAVE_LANES
    total = None
    for i in range(D):
        if merged:
            outs = [render_wave_merged(r.scene, params, ids, i * spd, spd,
                                       cfg)]
        else:
            outs = [render_wave(r.scene, params, ids, i * spd + k, cfg)
                    for k in range(spd)]
        for out in outs:
            part = torch.cat([out["radiance"],
                              out["filter_weight"][:, None]], 1)
            total = part if total is None else total + part
    return total.reshape(r.height, r.width, 4)


def sharding_phase(torch, Renderer, env_scene):
    """Tile and sample sharding (parallel/sharding.py) on the card, the
    "shadertoy" scene (43,792 triangles, the packed backend). (a) The
    default mesh (every card): shard="tiles" render_sample(1) twice, then
    shard="spp" render_sample(2). (b) The mesh ["cuda:0", "cuda:0"]
    (two entries on one card, each with its own replica of the scene):
    tiles at 1280x720 (pad 0) and at 1279x719 (pad 1), render_sample(1)
    each; spp render_sample(4) (2 samples an entry, one merged wave
    each). Every tiled accumulator must equal (torch.equal) an unsharded
    renderer's after as many render_sample(1) calls on the same card,
    and every spp accumulator the unsharded sum of the same waves in mesh
    order (spp_reference). Every kernel-1 and kernel-2 launch of (a) and
    (b) is recorded and held against its plain version (LaunchRecorder).
    make_mesh asked for one card more than the machine has must raise.
    (c) The CLI on the CLI phase's env.pbrt at 640x360, 4 spp, --shard
    spp --devices 1. (d) ms a sample of the unsharded, tiled and spp
    render_sample at 1280x720 (host time, synchronised; on one card the
    host cost of the split, not a speed-up). Returns (results, launches
    of (a) and (b))."""
    from tracerboy_tpu_torch.app import cli
    from tracerboy_tpu_torch.parallel.sharding import make_mesh
    from tracerboy_tpu_torch.scene.compile import load_scene
    from tracerboy_tpu_torch.trace import kernels

    set_opt_in()
    results = {}
    rng = np.random.default_rng(20261021)
    cs = load_scene("shadertoy", film_size=FULL_WAVE)
    n_cards = torch.cuda.device_count()
    try:
        make_mesh(n_devices=n_cards + 1)
    except ValueError as e:
        results["too_many_cards"] = str(e)
    else:
        fail(f"sharding: make_mesh({n_cards + 1}) did not raise with "
             f"{n_cards} cards")

    # The unsharded references, traced before the recorded runs.
    ref = Renderer(cs, film_size=FULL_WAVE, device="cuda")
    ref.render_sample(1)
    want_tiles = [ref.state.accum.clone()]
    ref.render_sample(1)
    want_tiles.append(ref.state.accum.clone())
    ref_odd = Renderer(cs, film_size=SHARD_ODD_FILM, device="cuda")
    ref_odd.render_sample(1)
    want_odd = ref_odd.state.accum
    want_spp = {D: spp_reference(ref, D, n) for D, n in
                ((n_cards, 2), (2, 4))}
    del ref_odd
    pair = make_mesh(devices=["cuda:0", "cuda:0"])
    runs = []

    def run(name, r, n, want):
        """r.render_sample(n), then its accumulator against want and its
        sample count against the spp step's rounding (n up to a multiple
        of the mesh)."""
        before = r.state.spp
        r.render_sample(n)
        step = -(-n // r.mesh.size) * r.mesh.size if r.shard == "spp" else n
        runs.append(dict(run=name, mesh=r.mesh.size, spp=r.state.spp,
                         equal=bool(r.state.spp == before + step
                                    and torch.equal(r.state.accum, want))))

    kernels.reset_counters()
    with LaunchRecorder("sharding", rng) as recorder:
        r = Renderer(cs, film_size=FULL_WAVE, device="cuda", shard="tiles")
        run("tiles default mesh, 1 sample", r, 1, want_tiles[0])
        run("tiles default mesh, 2 samples", r, 1, want_tiles[1])
        r = Renderer(cs, film_size=FULL_WAVE, device="cuda", shard="spp")
        run("spp default mesh, render_sample(2)", r, 2, want_spp[n_cards])
        for film, want in ((FULL_WAVE, want_tiles[0]),
                           (SHARD_ODD_FILM, want_odd)):
            r = Renderer(cs, film_size=film, device="cuda", shard="tiles",
                         mesh=pair)
            run(f"tiles cuda:0 x2 {film[0]}x{film[1]} pad "
                f"{(-film[0] * film[1]) % 2}", r, 1, want)
        r = Renderer(cs, film_size=FULL_WAVE, device="cuda", shard="spp",
                     mesh=pair)
        run("spp cuda:0 x2, render_sample(4)", r, 4, want_spp[2])
        torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    overflows = kernels.stack_overflows()
    del r, want_tiles, want_odd, want_spp
    results["runs"] = runs
    print("sharding runs against the unsharded waves:", json.dumps(runs))
    if not all(row["equal"] for row in runs):
        fail(f"sharding: a sharded accumulator differs from the unsharded "
             f"one: {runs}")
    if launches.get("closest", 0) <= 0 or launches.get("anyhit", 0) <= 0:
        fail(f"sharding: launches {launches}")
    t0 = time.perf_counter()
    results["closest"], results["anyhit"] = recorder.check(launches,
                                                           overflows)
    results["check_s"] = time.perf_counter() - t0
    results["launches"] = launches

    # (c) the CLI, --shard spp --devices 1.
    png = os.path.join(os.path.dirname(env_scene), "sharded.png")
    t0 = time.perf_counter()
    stats = {}
    rc = cli.main([env_scene, "--size", "640x360", "--spp", "4", "--shard",
                   "spp", "--devices", "1", "--out", png, "--quiet"],
                  stats=stats)
    w, h, ctype, _ = png_facts(png)
    results["cli"] = dict(rc=rc, png=[w, h], spp=stats.get("spp"),
                          seconds=time.perf_counter() - t0)
    print("sharding CLI env.pbrt 640x360 --shard spp --devices 1:",
          json.dumps(results["cli"]))
    if rc != 0 or (w, h) != (640, 360) or stats.get("spp") != 4:
        fail(f"sharding CLI: {results['cli']}")

    # (d) host time a sample, each after a warm-up call.
    def ms_a_sample(r, n, reps=3):
        r.render_sample(n)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            r.render_sample(n)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / (reps * n)

    timing = dict(card=card_line(), unsharded_ms=ms_a_sample(
        Renderer(cs, film_size=FULL_WAVE, device="cuda"), 1))
    for name, kw, n in (("tiles", {}, 1), ("spp", {}, 2),
                        ("tiles_pair", dict(mesh=pair), 1),
                        ("spp_pair", dict(mesh=pair), 4)):
        shard = name.split("_")[0]
        timing[f"{name}_ms"] = ms_a_sample(
            Renderer(cs, film_size=FULL_WAVE, device="cuda", shard=shard,
                     **kw), n)
    results["ms_a_sample"] = timing
    print("sharding ms a sample at 1280x720:", json.dumps(timing))
    torch.cuda.empty_cache()
    return results, launches


def jpeg_phase(torch):
    """jpeg_runs in a temporary directory that is removed after it."""
    with tempfile.TemporaryDirectory(prefix="tb_jpeg_") as tmp:
        return jpeg_runs(torch, tmp)


def dds_phase(torch):
    """dds_runs in a temporary directory that is removed after it."""
    with tempfile.TemporaryDirectory(prefix="tb_dds_") as tmp:
        return dds_runs(torch, tmp)


def tiff_phase(torch):
    """tiff_runs in a temporary directory that is removed after it."""
    with tempfile.TemporaryDirectory(prefix="tb_tiff_") as tmp:
        return tiff_runs(torch, tmp)


def webp_phase(torch):
    """webp_runs in a temporary directory that is removed after it."""
    with tempfile.TemporaryDirectory(prefix="tb_webp_") as tmp:
        return webp_runs(torch, tmp)


def j2k_phase(torch):
    """j2k_runs in a temporary directory that is removed after it."""
    with tempfile.TemporaryDirectory(prefix="tb_j2k_") as tmp:
        return j2k_runs(torch, tmp)


def avif_phase(torch):
    """avif_runs in a temporary directory that is removed after it."""
    with tempfile.TemporaryDirectory(prefix="tb_avif_") as tmp:
        return avif_runs(torch, tmp)


def small_phase(torch):
    """small_runs in a temporary directory that is removed after it."""
    with tempfile.TemporaryDirectory(prefix="tb_small_") as tmp:
        return small_runs(torch, tmp)


def host_cpu() -> str:
    """The host CPU's model name from /proc/cpuinfo, else its vendor,
    family and model numbers, else the machine type."""
    import platform

    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                fields.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    if fields.get("model name"):
        return fields["model name"]
    if fields.get("vendor_id"):
        return (f"{fields['vendor_id']} family {fields.get('cpu family')} "
                f"model {fields.get('model')}")
    return platform.machine() or "unknown"


def fixture_hashes(label, directory, decode):
    """Every file of directory/manifest.json decoded by decode(path): its
    shape, dtype and sha256 must equal the manifest's (PIL's arrays; the
    card's machine has no PIL). Returns {name: equal}."""
    import hashlib

    with open(directory / "manifest.json") as f:
        manifest = json.load(f)
    rows, bad = {}, []
    for name, entry in sorted(manifest["files"].items()):
        arr = decode(str(directory / name))
        digest = hashlib.sha256(np.ascontiguousarray(arr).tobytes())
        got = dict(shape=list(arr.shape), dtype=str(arr.dtype),
                   sha256=digest.hexdigest())
        rows[name] = got["sha256"] == entry["sha256"]
        if got != entry:
            bad.append((name, got, entry))
    print(f"{label} fixtures against PIL's hashes:", json.dumps(rows))
    if bad or not rows:
        fail(f"{label}: decoded fixtures differ from the manifest: {bad}")
    return rows


def host_decode(decode, path, runs=5) -> dict:
    """Host seconds of decode(path), `runs` times, with the host's CPU."""
    secs = []
    for _ in range(runs):
        t0 = time.perf_counter()
        decode(str(path))
        secs.append(time.perf_counter() - t0)
    return dict(seconds=secs, median_s=float(np.median(secs)),
                bytes=path.stat().st_size, cpu=host_cpu(),
                cpu_count=os.cpu_count())


def textured_swap_cli(torch, tmp, label, swaps):
    """The CLI on utils/demo_scene's textured_lit.pbrt with its image
    textures swapped for other files (demo_scene.retexture), 1280x720,
    2 spp: a finite image; one wave of closest-hit launches and no
    any-hit launch (cutouts make every shadow wave a closest-hit march),
    the wave's launches tagged main / refire_k / shadow_k and held
    against the plain version by kind (textured_launch_check). Returns
    (results, launches)."""
    from tracerboy_tpu_torch.app import cli
    from tracerboy_tpu_torch.core import image_io
    from tracerboy_tpu_torch.trace import kernels, traverse
    from tracerboy_tpu_torch.trace.wavefront import WaveConfig
    from tracerboy_tpu_torch.utils.config import default_output_settings
    from tracerboy_tpu_torch.utils.demo_scene import (
        retexture,
        write_textured_scene,
    )

    tex_scene, lit_scene = write_textured_scene(tmp)
    try:
        retexture(tex_scene, swaps)
    except ValueError as e:
        fail(f"{label}: {e}")
    rounds = WaveConfig(width=1, height=1).alpha_rounds
    per_wave = (default_output_settings().performance_settings.max_bounces
                * (1 + rounds + (rounds + 1)))
    real = traverse.closest_hit
    seq, calls = [], []

    def recording(o, d, t_max, nodes, tris_bw, roots=None):
        if roots is not None:
            fail(f"{label} CLI: a launch with per-ray roots")
        if len(seq) < per_wave:
            seq.append(nodes.data_ptr())
            calls.append((o.clone(), d.clone(), t_max.clone(), nodes,
                          tris_bw))
        return real(o, d, t_max, nodes, tris_bw)

    out = os.path.join(tmp, f"{label}_lit.png")
    exr = os.path.join(tmp, f"{label}_lit.exr")
    stats = {}
    kernels.reset_counters()
    traverse.closest_hit = recording
    try:
        t0 = time.perf_counter()
        rc = cli.main([lit_scene, "--size", "x".join(map(str, FULL_WAVE)),
                       "--spp", "2", "--out", out, "--hdr-out", exr,
                       "--quiet"], stats=stats)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        traverse.closest_hit = real
    launches = dict(kernels.LAUNCHES)
    overflows = kernels.stack_overflows()
    if rc != 0:
        fail(f"{label} CLI: exit {rc}")
    mean = check_cli_outputs(f"{label} textured_lit", out, exr)
    check_image(f"{label} textured_lit", image_io.read_ldr(out))
    if (launches["closest"] != per_wave or launches["anyhit"] or overflows
            or len(calls) != per_wave):
        fail(f"{label} CLI: launches {launches}, {len(calls)} recorded, "
             f"{overflows} overflows; expected one wave of {per_wave}")
    kinds = tag_closest_launches(seq, "shadow")
    by_kind, bad = textured_launch_check(
        calls, kinds, np.random.default_rng(20261022), measure=False)
    del calls
    results = dict(cli=dict(rc=rc, seconds=seconds, spp=stats.get("spp"),
                            s_per_sample=stats["seconds"] / stats["spp"],
                            radiance_mean=mean, launches=launches),
                   kinds=by_kind)
    print(f"{label} CLI textured_lit.pbrt ({', '.join(swaps)} swapped) "
          "1280x720 2 spp:", json.dumps(results["cli"]))
    print(f"{label} CLI closest-hit launches by kind:", json.dumps(by_kind))
    checked = sum(r["checked"] for r in by_kind.values())
    outside = sum(r["id_mismatch_outside_ties"] for r in by_kind.values())
    if bad or outside > TOLERANCE["id_mismatch_frac"] * checked:
        fail(f"{label} launches disagree with the plain version: {bad}, "
             f"{outside} id mismatches outside ties in {checked} lanes")
    if not {"main", "refire_1", "shadow_0"} <= set(by_kind):
        fail(f"{label} CLI: launch kinds {sorted(by_kind)}")
    torch.cuda.empty_cache()
    return results, launches


def jpeg_runs(torch, tmp):
    """The port's JPEG decoder (core/jpeg.py, csrc/jpeg_decode.cpp, g++ at
    first use) on the card's machine, which has no PIL. (a) Every
    committed fixture of tests/data/jpeg decoded, its shape, dtype and
    sha256 equal to manifest.json's (PIL's arrays, written by
    tests/make_jpeg_fixtures.py: PIL's saves, arithmetic-coded and
    lossless files and block-smoothed cut progressive files among them).
    (b) The 1024x1024 albedo's decode as PIL's progressive 4:2:0 file and
    as an arithmetic-coded progressive 4:2:0 one, 5 runs each, host
    seconds, with the host's CPU (and the card line). (c) The CLI on
    utils/demo_scene's textured_lit.pbrt with its albedo pointed at the
    Huffman JPEG (textured_swap_cli); (d) the same with the
    arithmetic-coded albedo. Returns (results, launches of (c) and (d)
    together)."""
    from tracerboy_tpu_torch.core.jpeg import read_jpeg

    set_opt_in()
    results = {"fixtures": fixture_hashes("jpeg", JPEG_DIR, read_jpeg)}
    albedo = JPEG_DIR / "albedo_1024.jpg"
    results["decode_1024"] = host_decode(read_jpeg, albedo)
    print("jpeg decode 1024x1024 progressive 4:2:0 (host):",
          json.dumps(results["decode_1024"]))
    arith = JPEG_DIR / "albedo_1024_arith.jpg"
    results["decode_1024_arith"] = dict(host_decode(read_jpeg, arith),
                                        card=card_line())
    print("jpeg decode 1024x1024 arithmetic progressive 4:2:0 (host):",
          json.dumps(results["decode_1024_arith"]))
    cli_res, launches = textured_swap_cli(torch, tmp, "jpeg",
                                          {"albedo.png": str(albedo)})
    results.update(cli_res)
    t0 = time.perf_counter()
    res2, launches2 = textured_swap_cli(torch, tmp, "jpeg_arith",
                                        {"albedo.png": str(arith)})
    results["arith_cli"] = dict(res2["cli"], run_s=time.perf_counter() - t0)
    results["arith_kinds"] = res2["kinds"]
    return results, {k: launches[k] + launches2[k] for k in launches}


def dds_runs(torch, tmp):
    """The port's DDS reader (core/dds.py, csrc/dds_decode.cpp, g++ at
    first use) and TGA/BMP variant readers on the card's machine, which
    has no PIL. (a) Every committed fixture of tests/data/dds (DDS of
    every format, the TGA and BMP variants) decoded by
    image_io.decode_ldr, its shape, dtype and sha256 equal to
    manifest.json's (written by tests/make_dds_fixtures.py). (b) The
    512x512 BC7 albedo's decode, 5 runs, host seconds, with the host's CPU
    and the card line. (c) The CLI on textured_lit.pbrt with its albedo
    the BC7 DDS and its leaf a DXT1 DDS whose cutouts are BC1's 1-bit
    alpha, so the alpha re-fires of kernel 1 run on the new decoder's
    texels (textured_swap_cli). Returns (results, launches of (c))."""
    from tracerboy_tpu_torch.core.image_io import decode_ldr

    set_opt_in()
    results = {"fixtures": fixture_hashes("dds", DDS_DIR, decode_ldr)}
    albedo = DDS_DIR / "albedo_bc7.dds"
    results["decode_512_bc7"] = dict(host_decode(decode_ldr, albedo),
                                     card=card_line())
    print("dds decode 512x512 BC7 (host):",
          json.dumps(results["decode_512_bc7"]))
    cli_res, launches = textured_swap_cli(
        torch, tmp, "dds", {"albedo.png": str(albedo),
                            "leaf.png": str(DDS_DIR / "leaf_dxt1.dds")})
    results.update(cli_res)
    return results, launches


def tiff_runs(torch, tmp):
    """The port's TIFF, GIF and ICO readers (core/tiff.py, core/gif.py,
    core/ico.py, csrc/lzw_codecs.cpp and csrc/tiff_codecs.cpp, g++ at
    first use; JPEG-in-TIFF through core/jpeg.py, LZMA through the
    standard library) on the card's machine, which has no PIL. (a) Every
    committed fixture of tests/data/tiff decoded by image_io.decode_ldr,
    its shape, dtype and sha256 equal to manifest.json's (written by
    tests/make_tiff_fixtures.py; JPEG, YCbCr, CIELab, CCITT, Zstandard,
    LZMA, ThunderScan and old-style LZW among them). (b)
    utils/demo_scene's 1024x1024 albedo written by core/tiff.write_tiff
    as an RGB TIFF with LZW and Predictor 2, and with Deflate and
    Predictor 2, each read back equal to the pixels written; then the
    committed GDAL-style albedos, JPEG YCbCr 4:2:0 in 256x256 tiles with
    JPEGTables and Zstandard with Predictor 2; each decode 5 runs, host
    seconds, with the host's CPU and the card line. (c) The CLI on
    textured_lit.pbrt with its albedo the JPEG-YCbCr TIFF and its leaf
    the RGBA Zstandard TIFF whose unassociated alpha makes the cutouts,
    so the alpha re-fires of kernel 1 run on the TIFF reader's texels
    (textured_swap_cli). Returns (results, launches of (c))."""
    from tracerboy_tpu_torch.core.image_io import _to_uint8, decode_ldr
    from tracerboy_tpu_torch.core.tiff import write_tiff
    from tracerboy_tpu_torch.utils.demo_scene import albedo_image

    set_opt_in()
    results = {"fixtures": fixture_hashes("tiff", TIFF_DIR, decode_ldr)}
    pixels = _to_uint8(albedo_image(1024))
    for compression in ("lzw", "deflate"):
        path = Path(tmp) / f"albedo_1024_{compression}.tif"
        write_tiff(str(path), pixels, compression)
        if not np.array_equal(decode_ldr(str(path)), pixels):
            fail(f"tiff: the 1024x1024 {compression} TIFF does not read "
                 "back as written")
        key = f"decode_1024_{compression}"
        results[key] = dict(host_decode(decode_ldr, path), card=card_line())
        print(f"tiff decode 1024x1024 RGB {compression} predictor 2 "
              "(host):", json.dumps(results[key]))
    for name, what in (("albedo_jpeg_ycbcr.tif",
                        "JPEG quality 90 YCbCr 4:2:0 256x256 tiles"),
                       ("albedo_zstd.tif", "Zstandard predictor 2")):
        key = f"decode_1024_{name[7:-4]}"
        results[key] = dict(host_decode(decode_ldr, TIFF_DIR / name),
                            card=card_line())
        print(f"tiff decode 1024x1024 {what} (host):",
              json.dumps(results[key]))
    cli_res, launches = textured_swap_cli(
        torch, tmp, "tiff",
        {"albedo.png": str(TIFF_DIR / "albedo_jpeg_ycbcr.tif"),
         "leaf.png": str(TIFF_DIR / "leaf_zstd.tif")})
    results.update(cli_res)
    return results, launches


def webp_runs(torch, tmp):
    """The port's WebP, QOI, PNM and PSD readers (core/webp.py, core/qoi.py,
    core/pnm.py, core/psd.py; csrc/webp_decode.cpp and
    csrc/lzw_codecs.cpp, g++ at first use) on the card's machine, which
    has no PIL. (a) Every committed fixture of tests/data/webp decoded by
    image_io.decode_ldr, its shape, dtype and sha256 equal to
    manifest.json's (written by tests/make_webp_fixtures.py). (b)
    utils/demo_scene's 1024x1024 albedo decoded as the lossy (quality 90)
    and the lossless WebP fixtures, and as a QOI written by
    core/qoi.write_qoi, read back equal to the pixels written; each
    decode 5 runs, host seconds, with the host's CPU and the card line.
    (c) The CLI on textured_lit.pbrt with its albedo the lossy WebP and
    its leaf the VP8X + ALPH WebP whose lossless-coded, gradient-filtered
    alpha makes the cutouts, so the alpha re-fires of kernel 1 run on the
    WebP reader's texels (textured_swap_cli). Returns (results, launches
    of (c))."""
    from tracerboy_tpu_torch.core.image_io import _to_uint8, decode_ldr
    from tracerboy_tpu_torch.core.qoi import write_qoi
    from tracerboy_tpu_torch.utils.demo_scene import albedo_image

    set_opt_in()
    results = {"fixtures": fixture_hashes("webp", WEBP_DIR, decode_ldr)}
    pixels = _to_uint8(albedo_image(1024))
    qoi_path = Path(tmp) / "albedo_1024.qoi"
    write_qoi(str(qoi_path), pixels)
    card = card_line()
    for key, path in (("lossy", WEBP_DIR / "albedo.webp"),
                      ("lossless", WEBP_DIR / "albedo_lossless.webp"),
                      ("qoi", qoi_path)):
        if key != "lossy" and not np.array_equal(decode_ldr(str(path)),
                                                 pixels):
            fail(f"webp: the 1024x1024 {key} albedo does not read back as "
                 "written")
        results[f"decode_1024_{key}"] = dict(host_decode(decode_ldr, path),
                                             card=card)
        print(f"webp decode 1024x1024 {key} (host):",
              json.dumps(results[f"decode_1024_{key}"]))
    cli_res, launches = textured_swap_cli(
        torch, tmp, "webp", {"albedo.png": str(WEBP_DIR / "albedo.webp"),
                             "leaf.png": str(WEBP_DIR / "leaf.webp")})
    results.update(cli_res)
    return results, launches


def j2k_runs(torch, tmp):
    """The port's JPEG 2000 reader (core/jpeg2000.py, csrc/j2k_decode.cpp,
    g++ at first use) on the card's machine, which has no PIL and no
    OpenJPEG. (a) Every committed fixture of tests/data/j2k decoded by
    image_io.decode_ldr, its shape, dtype and sha256 equal to
    manifest.json's (written by tests/make_j2k_fixtures.py). (b)
    utils/demo_scene's 1024x1024 albedo decoded as the lossless 5/3 JP2
    fixture, read back equal to the pixels written, and as the 9/7 JP2
    fixture (38 dB); each decode 5 runs, host seconds, with the host's CPU
    and the card line. (c) The CLI on textured_lit.pbrt with its albedo
    the 9/7 JP2 and its leaf the RGBA raw codestream (.j2k) whose
    losslessly coded alpha makes the cutouts, so the alpha re-fires of
    kernel 1 run on the JPEG 2000 reader's texels (textured_swap_cli).
    Returns (results, launches of (c))."""
    from tracerboy_tpu_torch.core.image_io import _to_uint8, decode_ldr
    from tracerboy_tpu_torch.utils.demo_scene import albedo_image

    set_opt_in()
    results = {"fixtures": fixture_hashes("j2k", J2K_DIR, decode_ldr)}
    pixels = _to_uint8(albedo_image(1024))
    card = card_line()
    for key, path in (("lossless", J2K_DIR / "albedo_lossless.jp2"),
                      ("97", J2K_DIR / "albedo.jp2")):
        if key == "lossless" and not np.array_equal(decode_ldr(str(path)),
                                                    pixels):
            fail("j2k: the 1024x1024 lossless albedo does not read back as "
                 "written")
        results[f"decode_1024_{key}"] = dict(host_decode(decode_ldr, path),
                                             card=card)
        print(f"j2k decode 1024x1024 {key} (host):",
              json.dumps(results[f"decode_1024_{key}"]))
    cli_res, launches = textured_swap_cli(
        torch, tmp, "j2k", {"albedo.png": str(J2K_DIR / "albedo.jp2"),
                            "leaf.png": str(J2K_DIR / "leaf.j2k")})
    results.update(cli_res)
    return results, launches


def avif_rewrites(card) -> dict:
    """Part 1 of the port's AVIF writer (core/avif_save.py, the decision
    record of csrc/av1_decode.cpp and the AV1 writer csrc/av1_encode.cpp,
    g++ at first use) on the card's host, which has no PIL and no libavif:
    every AV1 payload of every committed fixture of tests/data/avif
    (colour and alpha items, grid tiles) decoded to its record and written
    back must equal the fixture's bytes; the 1024x1024 albedo_default.avif
    (Pillow's default save) rewritten 5 times, host ms of the record, the
    write and both, with the card line."""
    from tracerboy_tpu_torch.core import avif, avif_save

    files = sorted(AVIF_DIR.glob("*.avif"))
    equal, total, bad = 0, 0, []
    for path in files:
        specs = avif._parse(path.read_bytes())[:2]
        for spec in specs:
            tiles = spec.tiles if isinstance(spec, avif._Grid) else [spec]
            for payload in tiles if spec is not None else ():
                total += 1
                if avif_save.write(avif_save.record(payload)) == payload:
                    equal += 1
                else:
                    bad.append(path.name)
    payload = avif._parse((AVIF_DIR / "albedo_default.avif").read_bytes())[0]
    rec_ms, write_ms = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        rec = avif_save.record(payload)
        t1 = time.perf_counter()
        out = avif_save.write(rec)
        t2 = time.perf_counter()
        rec_ms.append(1e3 * (t1 - t0))
        write_ms.append(1e3 * (t2 - t1))
    res = dict(files=len(files), payloads=total, equal=equal,
               albedo_default_bytes=len(payload),
               albedo_default_equal=out == payload,
               record_ms=rec_ms, write_ms=write_ms,
               median_record_ms=float(np.median(rec_ms)),
               median_write_ms=float(np.median(write_ms)),
               median_rewrite_ms=float(np.median(np.add(rec_ms, write_ms))),
               cpu=host_cpu(), card=card)
    print("avif rewrite of every fixture payload (host):", json.dumps(res))
    if bad or equal != total or not total or out != payload:
        fail(f"avif: rewritten payloads differ from the fixtures: {bad}")
    return res


def avif_runs(torch, tmp):
    """The port's AVIF reader (core/avif.py, csrc/av1_decode.cpp, g++ at
    first use) on the card's machine, which has no PIL, no libavif and no
    AV1 library. (a) Every committed fixture of tests/data/avif decoded
    by image_io.decode_ldr, its shape, dtype and sha256 equal to
    manifest.json's (written by tests/make_avif_fixtures.py). (b)
    utils/demo_scene's 1024x1024 albedo decoded as the 4:2:0 AVIF fixture,
    as the 4:4:4 one coded lossless (the Walsh-Hadamard path), as
    Pillow's default save (the in-loop filters on: deblocked), as a plain
    Image.save (intra block copy) and as a default save with film grain;
    each decode 5 runs, host seconds, with the host's CPU and the card
    line; before them every fixture's payloads rewritten (avif_rewrites); also as a 3x3 grid of 384x384 tiles through libavif's float
    routines (matrix 12 under primaries 12) and as the default save with
    matrix 4 (FCC, the float routines). (c) The CLI on textured_lit.pbrt
    with its albedo and its RGBA leaf Pillow's default saves, whose
    deblocked alpha item makes the cutouts, so the alpha re-fires of
    kernel 1 run on texels the in-loop filters produced
    (textured_swap_cli); (d) the same with the plain-save albedo and the
    RGBA leaf saved with film grain (its alpha item's grain moves the
    cutouts' edges); (e) the same with the grid albedo and the leaf as a
    2x2 colour grid and a 2x2 alpha grid (YCgCo at full range), whose
    stitched alpha makes the cutouts. Returns (results, launches of (c),
    (d) and (e) together)."""
    from tracerboy_tpu_torch.core.image_io import decode_ldr

    set_opt_in()
    results = {"fixtures": fixture_hashes("avif", AVIF_DIR, decode_ldr)}
    card = card_line()
    results["rewrite"] = avif_rewrites(card)
    for key, path in (("420", AVIF_DIR / "albedo.avif"),
                      ("lossless", AVIF_DIR / "albedo_lossless.avif"),
                      ("default", AVIF_DIR / "albedo_default.avif"),
                      ("plain", AVIF_DIR / "albedo_plain.avif"),
                      ("grain", AVIF_DIR / "albedo_grain.avif"),
                      ("grid", AVIF_DIR / "albedo_grid.avif"),
                      ("fcc", AVIF_DIR / "albedo_fcc.avif")):
        results[f"decode_1024_{key}"] = dict(host_decode(decode_ldr, path),
                                             card=card)
        print(f"avif decode 1024x1024 {key} (host):",
              json.dumps(results[f"decode_1024_{key}"]))
    cli_res, launches = textured_swap_cli(
        torch, tmp, "avif",
        {"albedo.png": str(AVIF_DIR / "albedo_default.avif"),
         "leaf.png": str(AVIF_DIR / "leaf_default.avif")})
    results.update(cli_res)
    t0 = time.perf_counter()
    cg_res, cg_launches = textured_swap_cli(
        torch, tmp, "avif_copy_grain",
        {"albedo.png": str(AVIF_DIR / "albedo_plain.avif"),
         "leaf.png": str(AVIF_DIR / "leaf_grain.avif")})
    results["copy_grain_cli"] = dict(cg_res["cli"],
                                     run_s=time.perf_counter() - t0)
    results["copy_grain_kinds"] = cg_res["kinds"]
    t0 = time.perf_counter()
    grid_res, grid_launches = textured_swap_cli(
        torch, tmp, "avif_grid",
        {"albedo.png": str(AVIF_DIR / "albedo_grid.avif"),
         "leaf.png": str(AVIF_DIR / "leaf_grid.avif")})
    results["grid_cli"] = dict(grid_res["cli"],
                               run_s=time.perf_counter() - t0)
    results["grid_kinds"] = grid_res["kinds"]
    return results, {k: launches[k] + cg_launches[k] + grid_launches[k]
                     for k in launches}


def written_textures(label, paths, generated, card, results):
    """Each written texture's sha256 and decode against the manifest's
    "generated" entry (PIL's digest applies to those bytes), each decode
    timed on the host (5 runs) under results["decode_<name>"]; a PNG
    inside an ICNS and a gzip FITS are compared by their pixels (another
    zlib may write other bytes). Returns the names that differ."""
    import hashlib

    from tracerboy_tpu_torch.core.image_io import decode_ldr

    bad = []
    for name, path in sorted(paths.items()):
        entry = generated[name]
        with open(path, "rb") as f:
            file_sha = hashlib.sha256(f.read()).hexdigest()
        arr = decode_ldr(path)
        got = dict(shape=list(arr.shape), dtype=str(arr.dtype),
                   sha256=hashlib.sha256(
                       np.ascontiguousarray(arr).tobytes()).hexdigest(),
                   file_sha256=file_sha)
        if name.endswith(".icns") or name == "albedo_gzip.fits":
            got["file_sha256"] = entry["file_sha256"]
        if got != entry:
            bad.append((name, got, entry))
        key = name.replace(".", "_")
        results[f"decode_{key}"] = dict(host_decode(decode_ldr, Path(path)),
                                        shape=list(arr.shape), card=card,
                                        pil_equal=got == entry)
        print(f"{label} decode {name} (host):",
              json.dumps(results[f"decode_{key}"]))
    return bad


def small_runs(torch, tmp):
    """The port's readers of PIL's small texture formats (core/sgi.py,
    core/pcx.py, core/ico.py, core/ftex.py, core/blp.py, core/icns.py,
    and part 2's core/im.py, core/sun.py, core/xbm.py, core/xpm.py,
    core/msp.py, core/rawformats.py; csrc/small_decode.cpp, g++ at first
    use) on the card's machine, which has no PIL. (a) Every committed
    fixture of tests/data/small and tests/data/small2 decoded by
    image_io.decode_ldr, its shape, dtype and sha256 equal to its
    manifest.json's (written by tests/make_small_fixtures.py and
    tests/make_small2_fixtures.py). (b) utils/demo_scene's
    write_small_textures' and write_small2_textures' files written here,
    each file's sha256 equal to its manifest's "generated" entry (so
    PIL's digest there applies to it) and its decode equal to that
    digest, each decode 5 runs, host seconds, with the host's CPU and the
    card line: the 1024x1024 albedo as an RLE SGI, a 3-plane PCX, a DXT1
    BLP2, a DXT1 FTEX, an ICNS of one ic10 PNG entry (whose zlib stream
    another zlib may write differently: its pixels are compared, not its
    bytes), a Sun RLE, a raw Sun, a planar IM and a 256-colour XPM; the
    512x512 leaf as a DXT5 BLP2 (alpha encoding 7) and as an RGBA IM;
    part 3's tests/data/small3 (FITS, FLI, IPTC, CMYK and YCCK JPEGs and
    their BLP1s) the same way, write_small3_textures' albedo as an FLC,
    a PhotoCD, raw and gzip FITS (pixels compared) and a raw IPTC image,
    and the committed BLP1 whose JPEG is the albedo as a CMYK JPEG,
    timed the same way. (c) The CLI on textured_lit.pbrt with the RLE
    SGI albedo and the DXT5 BLP2 leaf, whose alpha makes the cutouts
    (textured_swap_cli); (d) the same with the Sun RLE albedo and the
    RGBA IM leaf; (e) the same with the BLP1-CMYK albedo and the PNG
    leaf. Returns (results, launches of (c), (d) and (e) together)."""
    from tracerboy_tpu_torch.core.image_io import decode_ldr
    from tracerboy_tpu_torch.utils.demo_scene import (
        SMALL3_ALBEDO,
        write_small2_textures,
        write_small3_textures,
        write_small_textures,
    )

    set_opt_in()
    results = {"fixtures": fixture_hashes("small", SMALL_DIR, decode_ldr),
               "fixtures2": fixture_hashes("small2", SMALL2_DIR,
                                           decode_ldr),
               "fixtures3": fixture_hashes("small3", SMALL3_DIR,
                                           decode_ldr)}
    card = card_line()
    bad = []
    for label, directory, write in (("small", SMALL_DIR,
                                     write_small_textures),
                                    ("small2", SMALL2_DIR,
                                     write_small2_textures),
                                    ("small3", SMALL3_DIR,
                                     write_small3_textures)):
        with open(directory / "manifest.json") as f:
            generated = json.load(f)["generated"]
        paths = write(os.path.join(tmp, label))
        bad += written_textures(label, paths, generated, card, results)
        if label == "small":
            swaps = {"albedo.png": paths["albedo.sgi"],
                     "leaf.png": paths["leaf.blp"]}
        elif label == "small2":
            swaps2 = {"albedo.png": paths["albedo.ras"],
                      "leaf.png": paths["leaf.im"]}
    if bad:
        fail(f"small: written textures differ from the manifest: {bad}")
    arr = decode_ldr(SMALL3_ALBEDO)
    results["decode_albedo_blp1_cmyk_blp"] = dict(
        host_decode(decode_ldr, Path(SMALL3_ALBEDO)), shape=list(arr.shape),
        card=card)
    print("small3 decode albedo_blp1_cmyk.blp (host):",
          json.dumps(results["decode_albedo_blp1_cmyk_blp"]))
    cli_res, launches = textured_swap_cli(torch, tmp, "small", swaps)
    results.update(cli_res)
    t0 = time.perf_counter()
    res2, launches2 = textured_swap_cli(torch, tmp, "small2", swaps2)
    results["small2_cli"] = dict(res2["cli"],
                                 run_s=time.perf_counter() - t0)
    results["small2_kinds"] = res2["kinds"]
    t0 = time.perf_counter()
    res3, launches3 = textured_swap_cli(torch, tmp, "small3",
                                        {"albedo.png": SMALL3_ALBEDO})
    results["small3_cli"] = dict(res3["cli"],
                                 run_s=time.perf_counter() - t0)
    results["small3_kinds"] = res3["kinds"]
    return results, {k: launches[k] + launches2[k] + launches3[k]
                     for k in launches}


def writers_phase(torch):
    """writers_runs in a temporary directory that is removed after it."""
    with tempfile.TemporaryDirectory(prefix="tb_write_") as tmp:
        return writers_runs(torch, tmp)


def write_fixtures_module():
    """tests/make_write_fixtures.py loaded by path (it imports only numpy
    when loaded): its image_of and png_parts make each mode's image and
    split a PNG as the manifest made and split PIL's."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_write_fixtures", WRITE_DIR.parent.parent
        / "make_write_fixtures.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def written_hashes(tmp) -> dict:
    """Every committed input x mode x extension of tests/data/write
    through core/image_save.save (what write_png writes), held against
    manifest.json (PIL's Image.save, written by
    tests/make_write_fixtures.py; the card's machine has no PIL): the
    file's sha256; for a PNG where this machine's zlib is not the
    manifest's, the inflated stream and the chunks other than IDAT, and
    IDAT chunks of PIL's 65,536-byte buffer but the last; for an ICO or
    ICNS there, the container with its PNGs and their lengths taken out
    and each embedded PNG held as a PNG is (icon_parts); for a PDF, the
    sha256 of its bytes with both dates masked; PIL's error class;
    NotImplementedError naming ROADMAP item 25 for what is not ported
    yet, which make_write_fixtures.ported says (AVIF alone). Returns the
    counts by kind of check (webp: the WebP files held by their bytes,
    every .webp entry of the manifest PIL wrote; later: the item-25
    refusals, all AVIF)."""
    import hashlib
    import zlib

    from tracerboy_tpu_torch.core import image_save

    fixtures = write_fixtures_module()
    with open(WRITE_DIR / "manifest.json") as f:
        manifest = json.load(f)
    with np.load(WRITE_DIR / "inputs.npz") as npz:
        inputs = {k: npz[k] for k in npz.files}
    same_zlib = zlib.ZLIB_RUNTIME_VERSION == manifest["zlib"]
    counts = dict(bytes=0, png_stream=0, icon_parts=0, pdf_masked=0,
                  error=0, later=0, webp=0)
    bad = []

    def png_held(got, want):
        return (got["stream_sha256"] == want["stream_sha256"]
                and got["frame_sha256"] == want["frame_sha256"]
                and all(n == manifest["bufsize"] for n in got["idat"][:-1]))

    for key, entry in sorted(manifest["entries"].items()):
        name, mode, ext = key.split("/")
        img = fixtures.image_of(inputs[name], mode)
        path = os.path.join(tmp, "img" + ext)
        data, err = None, None
        try:
            image_save.save(path, img)
            data = Path(path).read_bytes()
        except Exception as e:
            err = e
        if "later" in entry:
            kind = "later"
            ok = (isinstance(err, NotImplementedError)
                  and image_save.ITEM in str(err)
                  and image_save.EXTENSION[ext] == "AVIF"
                  and not fixtures.ported(image_save.EXTENSION[ext], img))
        elif "error" in entry:
            kind = "error"
            ok = type(err).__name__ == entry["error"]
        elif data is None:
            kind, ok = "bytes", False
        elif "stream_sha256" in entry and not same_zlib:
            kind = "png_stream"
            ok = png_held(fixtures.png_parts(data), entry)
        elif "pngs" in entry and not same_zlib:
            kind = "icon_parts"
            got = fixtures.icon_parts(data)
            ok = (got["container_sha256"] == entry["container_sha256"]
                  and len(got["pngs"]) == len(entry["pngs"])
                  and all(png_held(g, w)
                          for g, w in zip(got["pngs"], entry["pngs"])))
        elif entry.get("dates") == "masked":
            kind = "pdf_masked"
            ok = hashlib.sha256(fixtures.mask_pdf_dates(data)).hexdigest() \
                == entry["sha256"]
        else:
            kind = "bytes"
            ok = hashlib.sha256(data).hexdigest() == entry["sha256"]
            counts["webp"] += ext == ".webp"
        counts[kind] += 1
        if not ok:
            bad.append((key, entry, repr(err)))
    counts["zlib"] = zlib.ZLIB_RUNTIME_VERSION
    counts["manifest_zlib"] = manifest["zlib"]
    webp_written = sum(k.endswith("/.webp") and "sha256" in e
                       for k, e in manifest["entries"].items())
    print("writers files against PIL's hashes:", json.dumps(counts))
    if bad or not counts["bytes"] or counts["webp"] != webp_written:
        fail(f"writers: {len(bad)} files differ from PIL's ("
             f"{counts['webp']} of {webp_written} WebP): {bad[:10]}")
    return counts


def written_webp_extra() -> dict:
    """Each image of tests/data/write/webp_extra.json made from its seed
    (make_write_fixtures.webp_extra_image: integer arithmetic alone) and
    written by core/image_save.py's WebP writer, held against the sha256
    of PIL's file. Returns the count, the largest image and the host
    seconds."""
    import hashlib

    from tracerboy_tpu_torch.core import image_save

    fixtures = write_fixtures_module()
    with open(WRITE_DIR / "webp_extra.json") as f:
        extra = json.load(f)
    bad, t0 = [], time.perf_counter()
    for e in extra["entries"]:
        img = fixtures.webp_extra_image(e["kind"], e["width"], e["height"],
                                        e["seed"])
        data = image_save.webp_encode(img)
        if hashlib.sha256(data).hexdigest() != e["sha256"]:
            bad.append((e["kind"], e["width"], e["height"], len(data),
                        e["size"]))
    res = dict(held=len(extra["entries"]) - len(bad),
               images=len(extra["entries"]),
               largest=max((e["width"] * e["height"], f"{e['width']}x"
                            f"{e['height']}") for e in extra["entries"])[1],
               seconds=time.perf_counter() - t0)
    print("writers webp_extra.json against PIL's hashes:", json.dumps(res))
    if bad or not extra["entries"]:
        fail(f"writers: {len(bad)} WebP files of webp_extra.json differ "
             f"from PIL's: {bad[:10]}")
    return res


def written_webp_alpha() -> dict:
    """Each image of tests/data/write/webp_alpha.json (RGBA, alpha below
    255 somewhere) made from its seed (make_write_fixtures.
    webp_alpha_image: integer arithmetic alone) and written by
    core/image_save.py's WebP writer, held against the sha256 of PIL's
    file. Returns the count, the ALPH header bytes of the files (method |
    filter << 2) and the host seconds."""
    import hashlib

    from tracerboy_tpu_torch.core import image_save

    fixtures = write_fixtures_module()
    with open(WRITE_DIR / "webp_alpha.json") as f:
        alpha = json.load(f)
    bad, headers, t0 = [], set(), time.perf_counter()
    for e in alpha["entries"]:
        img = fixtures.webp_alpha_image(e["kind"], e["alpha"], e["width"],
                                        e["height"], e["seed"])
        data = image_save.webp_encode(img)
        if data[12:16] == b"VP8X" and data[30:34] == b"ALPH":
            headers.add(data[38])
        if hashlib.sha256(data).hexdigest() != e["sha256"]:
            bad.append((e["kind"], e["alpha"], e["width"], e["height"],
                        len(data), e["size"]))
    res = dict(held=len(alpha["entries"]) - len(bad),
               images=len(alpha["entries"]), alph_headers=sorted(headers),
               seconds=time.perf_counter() - t0)
    print("writers webp_alpha.json against PIL's hashes:", json.dumps(res))
    if bad or not alpha["entries"]:
        fail(f"writers: {len(bad)} WebP files of webp_alpha.json differ "
             f"from PIL's: {bad[:10]}")
    return res


def with_alpha(img: np.ndarray) -> np.ndarray:
    """An (H, W, 3) float image with a fourth channel: a soft ellipse
    (1 inside, falling to 0 over a tenth of the radius, 0 outside)."""
    h, w = img.shape[:2]
    y, x = np.mgrid[:h, :w]
    r = np.hypot((x + 0.5) / w - 0.5, (y + 0.5) / h - 0.5) / 0.45
    alpha = np.clip((1.0 - r) * 10.0, 0.0, 1.0).astype(img.dtype)
    return np.concatenate([img[..., :3], alpha[..., None]], axis=-1)


def writers_cli_run(torch, args):
    """The port's CLI on "shadertoy" at 1280x720 with `args`, its closest- and any-hit launches recorded and held
    against the plain version on at most CHECK_LANES live lanes each
    (textured_launch_check, anyhit_launch_check: 0 mismatches outside
    ties, 0 occlusion mismatches, no overflow). Returns (exit code,
    seconds, launches, the last image write_png was given, closest-hit
    and any-hit check rows)."""
    from tracerboy_tpu_torch.app import cli
    from tracerboy_tpu_torch.core import image_io
    from tracerboy_tpu_torch.trace import kernels, traverse

    recorded = {"any_hit": [], "closest_hit": []}
    real = {key: getattr(traverse, key) for key in recorded}
    real_write = image_io.write_png
    images = []

    def recorder(key):
        def recording(o, d, t_max, nodes, tris_bw, roots=None):
            if roots is not None:
                fail(f"writers CLI: a {key} launch with per-ray roots")
            recorded[key].append((o.clone(), d.clone(), t_max.clone(),
                                  nodes, tris_bw))
            return real[key](o, d, t_max, nodes, tris_bw)
        return recording

    def keep_image(path, img):
        images.append(np.array(img))
        real_write(path, img)

    kernels.reset_counters()
    for key in recorded:
        setattr(traverse, key, recorder(key))
    image_io.write_png = keep_image
    try:
        t0 = time.perf_counter()
        rc = cli.main(["shadertoy", "--size", "x".join(map(str, FULL_WAVE)),
                       *args, "--quiet"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        for key, fn in real.items():
            setattr(traverse, key, fn)
        image_io.write_png = real_write
    launches = dict(kernels.LAUNCHES)
    overflows = kernels.stack_overflows()
    if rc != 0:
        fail(f"writers CLI {args}: exit {rc}")
    if launches["closest"] <= 0 or launches["anyhit"] <= 0 or overflows:
        fail(f"writers CLI {args}: launches {launches}, {overflows} "
             "overflows")
    check_image(f"writers CLI {args}", images[-1])
    rng = np.random.default_rng(20261018)
    calls = recorded["closest_hit"]
    by_kind, bad = textured_launch_check(calls, ["writers"] * len(calls),
                                         rng, measure=False)
    closest = by_kind.get("writers")
    anyhit = anyhit_launch_check(recorded["any_hit"], rng, measure=False)
    del calls, recorded
    if (bad or closest is None or closest["id_mismatch_outside_ties"]
            or closest["overflows"] or closest["dead_lane_hits"]
            or anyhit["occ_mismatch"] or anyhit["overflows"]
            or anyhit["dead_lane_hits"]):
        fail(f"writers CLI {args}: launches disagree with the plain "
             f"version: {closest}, {anyhit}, {bad}")
    return rc, seconds, launches, images[-1], closest, anyhit


def writers_runs(torch, tmp):
    """The port's image writer (core/image_save.py behind
    image_io.write_png; JPEG's pixel stages and entropy coder in
    csrc/jpeg_encode.cpp, ICO's and ICNS's resampler in
    csrc/resample.cpp, g++ at first use), on the card's machine, which
    has no PIL. (a) written_hashes. (b) The CLI on "shadertoy" at
    1280x720, 2 spp, --out w.jpg --capture-every 2: w.jpg and
    w_00002.jpg JPEG files, byte for byte the same, read back by the
    port's JPEG decoder at 1280x720. (b2) The CLI at 1280x720, 1 spp,
    --out w.icns: read back through core/icns.py at 1024x1024, its
    1024x1024 entry the BICUBIC resize (core/resample.py) of the image.
    (b3) The CLI at 1280x720, 1 spp, --out w.webp: read back through
    core/webp.py at 1280x720, its PSNR against the image written printed
    (not gated). Each run's launches held by writers_cli_run. (a2)
    written_webp_extra. (c) write_png of (b)'s image as .jpg, .png,
    .bmp, .tif, .jp2, .gif, .pdf, .eps, .ico, .icns and .webp: host ms,
    medians of 5, with the host's CPU and the card line; the .jp2
    decoded by core/jpeg2000.py equal to the image, the .ico's 256x144
    entry (core/ico.py) its LANCZOS thumbnail, the .icns's entry as
    (b2)'s, the .webp read back at 1280x720. Returns (results, launches
    of (b), (b2) and (b3))."""
    from tracerboy_tpu_torch.core import image_io
    from tracerboy_tpu_torch.core.icns import icns_entries, read_icns
    from tracerboy_tpu_torch.core.ico import read_ico
    from tracerboy_tpu_torch.core.image_io import _to_uint8
    from tracerboy_tpu_torch.core.resample import BICUBIC, LANCZOS, resize
    from tracerboy_tpu_torch.core.webp import read_webp

    set_opt_in()
    os.makedirs(os.path.join(tmp, "hashes"))
    results = {"files": written_hashes(os.path.join(tmp, "hashes")),
               "webp_extra": written_webp_extra(),
               "webp_alpha": written_webp_alpha()}
    webp_dir = os.path.join(tmp, "webp")
    os.makedirs(webp_dir)
    icns_dir = os.path.join(tmp, "icns")
    tmp = os.path.join(tmp, "cli")
    os.makedirs(tmp)
    os.makedirs(icns_dir)
    out = os.path.join(tmp, "w.jpg")
    rc, seconds, launches, img, closest, anyhit = writers_cli_run(
        torch, ["--spp", "2", "--out", out, "--capture-every", "2"])
    final, capture = Path(out), Path(tmp) / "w_00002.jpg"
    files = sorted(os.listdir(tmp))
    if not (capture.exists() and final.read_bytes() == capture.read_bytes()
            and final.read_bytes()[:4] == b"\xff\xd8\xff\xe0"):
        fail(f"writers CLI: w.jpg and w_00002.jpg are not one JPEG "
             f"({files})")
    back = image_io.decode_ldr(out)
    if back.shape != (FULL_WAVE[1], FULL_WAVE[0], 3):
        fail(f"writers CLI: w.jpg reads back as {back.shape}")
    results["cli"] = dict(rc=rc, seconds=seconds, launches=launches,
                          files=files, jpeg_bytes=final.stat().st_size,
                          read_back=list(back.shape))
    results["closest"], results["anyhit"] = closest, anyhit
    print("writers CLI shadertoy 1280x720 2 spp --out w.jpg "
          "--capture-every 2:", json.dumps(results["cli"]))
    print("writers closest-hit launches vs plain:", json.dumps(closest))
    print("writers any-hit launches vs plain:", json.dumps(anyhit))

    def icns_check(label, path, u8):
        """The icns file's read-back shape and its ic10 entry against the
        image's BICUBIC resize."""
        from tracerboy_tpu_torch.core.image_io import decode_png, png_to_8bit

        data = Path(path).read_bytes()
        shape = read_icns(data, path).shape
        start, _ = icns_entries(data, path)[b"ic10"]
        entry = png_to_8bit(*decode_png(data[start:], path))
        want = resize(u8, "RGB", (1024, 1024), BICUBIC)
        if shape[:2] != (1024, 1024) or not np.array_equal(entry, want):
            fail(f"writers: {label} reads back as {shape}, its 1024x1024 "
                 f"entry {'equal' if np.array_equal(entry, want) else 'not'}"
                 " to the resize")
        return list(shape)

    icns_out = os.path.join(icns_dir, "w.icns")
    rc2, seconds2, launches2, img2, closest2, anyhit2 = writers_cli_run(
        torch, ["--spp", "1", "--out", icns_out])
    results["icns_cli"] = dict(
        rc=rc2, seconds=seconds2, launches=launches2,
        files=sorted(os.listdir(icns_dir)),
        icns_bytes=os.path.getsize(icns_out),
        read_back=icns_check("w.icns", icns_out, _to_uint8(img2)))
    results["icns_closest"], results["icns_anyhit"] = closest2, anyhit2
    print("writers CLI shadertoy 1280x720 1 spp --out w.icns:",
          json.dumps(results["icns_cli"]))
    print("writers icns closest-hit launches vs plain:",
          json.dumps(closest2))
    print("writers icns any-hit launches vs plain:", json.dumps(anyhit2))

    def webp_check(label, path, u8):
        """The WebP file read back through core/webp.py at 1280x720, and
        its PSNR (dB) against the image written."""
        back = read_webp(Path(path).read_bytes(), path)
        if back.shape != (FULL_WAVE[1], FULL_WAVE[0], 3):
            fail(f"writers: {label} reads back as {back.shape}")
        mse = float(np.mean((back.astype(np.float64) - u8) ** 2))
        return list(back.shape), (10 * np.log10(255.0 ** 2 / mse)
                                  if mse else float("inf"))

    webp_out = os.path.join(webp_dir, "w.webp")
    rc3, seconds3, launches3, img3, closest3, anyhit3 = writers_cli_run(
        torch, ["--spp", "1", "--out", webp_out])
    shape3, psnr3 = webp_check("w.webp", webp_out, _to_uint8(img3))
    results["webp_cli"] = dict(
        rc=rc3, seconds=seconds3, launches=launches3,
        files=sorted(os.listdir(webp_dir)),
        webp_bytes=os.path.getsize(webp_out), read_back=shape3,
        psnr_db=psnr3)
    results["webp_closest"], results["webp_anyhit"] = closest3, anyhit3
    print("writers CLI shadertoy 1280x720 1 spp --out w.webp:",
          json.dumps(results["webp_cli"]))
    print("writers webp closest-hit launches vs plain:",
          json.dumps(closest3))
    print("writers webp any-hit launches vs plain:", json.dumps(anyhit3))

    # The same render with an alpha plane: VP8X, ALPH and VP8 chunks; the
    # alpha is coded losslessly, the colours where it is 255 at about the
    # opaque file's PSNR.
    rgba_img = with_alpha(img3)
    rgba_u8 = _to_uint8(rgba_img)
    rgba_out = os.path.join(webp_dir, "w_rgba.webp")
    image_io.write_png(rgba_out, rgba_img)
    rgba_data = Path(rgba_out).read_bytes()
    rgba_back = read_webp(rgba_data, rgba_out)
    opaque = rgba_u8[..., 3] == 255
    mse = float(np.mean((rgba_back[..., :3][opaque].astype(np.float64)
                         - rgba_u8[..., :3][opaque]) ** 2))
    results["webp_rgba"] = dict(
        chunks=[rgba_data[12:16].decode(), rgba_data[30:34].decode()],
        webp_bytes=len(rgba_data), read_back=list(rgba_back.shape),
        alpha_exact=bool(rgba_back.shape == rgba_u8.shape and np.array_equal(
            rgba_back[..., 3], rgba_u8[..., 3])),
        alph_header=rgba_data[38], opaque_pixels=int(opaque.sum()),
        transparent_pixels=int((rgba_u8[..., 3] == 0).sum()),
        psnr_db_opaque=(10 * np.log10(255.0 ** 2 / mse) if mse
                        else float("inf")),
        psnr_db_floor=RGBA_WEBP_PSNR_DB)
    print("writers 1280x720 RGBA .webp of the w.webp render:",
          json.dumps(results["webp_rgba"]))
    if not (results["webp_rgba"]["alpha_exact"]
            and results["webp_rgba"]["chunks"] == ["VP8X", "ALPH"]
            and results["webp_rgba"]["psnr_db_opaque"] >= RGBA_WEBP_PSNR_DB):
        fail(f"writers: the RGBA .webp does not read back: "
             f"{results['webp_rgba']}")
    times = {}
    for ext in ("jpg", "png", "bmp", "tif", "jp2", "gif", "pdf", "eps",
                "ico", "icns", "webp"):
        path = os.path.join(tmp, f"t.{ext}")
        secs = []
        for _ in range(5):
            t = time.perf_counter()
            image_io.write_png(path, img)
            secs.append(time.perf_counter() - t)
        times[ext] = dict(ms=[1e3 * x for x in secs],
                          median_ms=float(np.median(secs)) * 1e3,
                          bytes=os.path.getsize(path))
    rgba_path = os.path.join(tmp, "t_rgba.webp")
    secs = []
    for _ in range(5):
        t = time.perf_counter()
        image_io.write_png(rgba_path, rgba_img)
        secs.append(time.perf_counter() - t)
    if Path(rgba_path).read_bytes() != rgba_data:
        fail("writers: the RGBA .webp is not the same file twice")
    times["webp_rgba"] = dict(ms=[1e3 * x for x in secs],
                              median_ms=float(np.median(secs)) * 1e3,
                              bytes=os.path.getsize(rgba_path))
    from tracerboy_tpu_torch.core.jpeg2000 import decode_jpeg2000

    u8 = _to_uint8(img)
    back, _, _ = decode_jpeg2000(Path(tmp, "t.jp2").read_bytes())
    if not np.array_equal(back[..., :img.shape[-1]], u8):
        fail("writers: the 1280x720 .jp2 does not decode to its image")
    ico = read_ico(Path(tmp, "t.ico").read_bytes())
    if not np.array_equal(ico, resize(u8, "RGB", (256, 144), LANCZOS)):
        fail(f"writers: the 1280x720 .ico reads back as {ico.shape}, not "
             "its 256x144 LANCZOS thumbnail")
    times["ico"]["read_back"] = list(ico.shape)
    times["icns"]["read_back"] = icns_check("t.icns",
                                            os.path.join(tmp, "t.icns"), u8)
    times["webp"]["read_back"], times["webp"]["psnr_db"] = webp_check(
        "t.webp", os.path.join(tmp, "t.webp"), u8)
    results["write_1280x720"] = dict(times, cpu=host_cpu(),
                                     cpu_count=os.cpu_count(),
                                     card=card_line())
    print("writers write_png 1280x720 (host ms, medians of 5):",
          json.dumps(results["write_1280x720"]))
    torch.cuda.empty_cache()
    return results, {k: launches[k] + launches2[k] + launches3[k]
                     for k in launches}


def main() -> int:
    print(card_line())
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the port has no CPU path here",
              file=sys.stderr)
        return 1
    from tracerboy_tpu_torch import Renderer
    from tracerboy_tpu_torch.scene.compile import load_scene
    from tracerboy_tpu_torch.trace import traverse
    from tracerboy_tpu_torch.utils.bench_traverse import walk_ops

    set_opt_in()
    laps, last_lap = {}, [time.perf_counter()]

    def lap(name):
        """Seconds since the previous lap, kept under name."""
        now = time.perf_counter()
        laps[name] = now - last_lap[0]
        last_lap[0] = now

    t0 = time.perf_counter()
    build_kernels()
    print(f"build: kernels ready in {time.perf_counter() - t0:.1f} s")
    lap("build")

    # --- kernel vs twin -------------------------------------------------
    rng = np.random.default_rng(20261016)
    # Compiled with the opt-in tables too; the default tables are the same.
    set_opt_in(TB_CUT="1", TB_BINNED="1")
    cs = load_scene("shadertoy", film_size=FULL_WAVE)
    scene = cs.as_tensors("cuda")
    set_opt_in()
    main_t = (scene["pk_nodes"], scene["pk_tris_bw"])
    shadow_t = (scene["pk_sh_nodes"], scene["pk_sh_tris_bw"])
    o, d, tm = compare_rays(scene, rng)
    ck = traverse.closest_hit(o, d, tm, *main_t)
    cp = traverse.closest_hit_plain(o, d, tm, *main_t)
    ak = traverse.any_hit(o, d, tm, *shadow_t)
    ap = traverse.anyhit_plain(o, d, tm, *shadow_t)
    torch.cuda.synchronize()
    ok_c, st_c = check_closest(o, d, main_t, ck, cp)
    ok_a, st_a = check_anyhit(ak, ap)
    print("closest kernel vs twin:", json.dumps(st_c))
    print("anyhit kernel vs twin:", json.dumps(st_a))
    if not (ok_c and ok_a):
        fail(f"kernel disagrees with its twin beyond {TOLERANCE}")

    # Timing at the main path's shapes: a full 921,600-ray primary wave
    # and its shadow wave toward the lights.
    w, h = FULL_WAVE
    pix = torch.arange(w * h, device="cuda")
    po, pd = primary_rays(scene, w, h, pix, rng)
    ptm = torch.full((w * h,), 1e30, device="cuda")
    hits = traverse.closest_hit(po, pd, ptm, *main_t)
    so, sd, stm = shadow_rays(scene, po, pd, hits[0], hits[1], rng)
    full_k = traverse.closest_hit(po, pd, ptm, *main_t)
    full_p = traverse.closest_hit_plain(po, pd, ptm, *main_t)
    sh_k = traverse.any_hit(so, sd, stm, *shadow_t)
    sh_p = traverse.anyhit_plain(so, sd, stm, *shadow_t)
    ok_c2, st_c2 = check_closest(po, pd, main_t, full_k, full_p)
    ok_a2, st_a2 = check_anyhit(sh_k, sh_p)
    print("full wave closest kernel vs twin:", json.dumps(st_c2))
    print("full wave anyhit kernel vs twin:", json.dumps(st_a2))
    if not (ok_c2 and ok_a2):
        fail(f"kernel disagrees with its twin beyond {TOLERANCE}")
    times = dict(
        closest_ms=cuda_ms(lambda: traverse.closest_hit(po, pd, ptm,
                                                        *main_t), 20),
        closest_plain_ms=cuda_ms(lambda: traverse.closest_hit_plain(
            po, pd, ptm, *main_t), 2),
        anyhit_ms=cuda_ms(lambda: traverse.any_hit(so, sd, stm,
                                                   *shadow_t), 20),
        anyhit_plain_ms=cuda_ms(lambda: traverse.anyhit_plain(
            so, sd, stm, *shadow_t), 2),
        compare_closest_ms=cuda_ms(lambda: traverse.closest_hit(
            o, d, tm, *main_t), 20),
        compare_closest_plain_ms=cuda_ms(lambda: traverse.closest_hit_plain(
            o, d, tm, *main_t), 2),
    )
    print("timing 921,600-ray waves and 65,536 rays:", json.dumps(times))
    lap("kernel_vs_plain")

    # --- rays in no order, and the kernels' walk beside the serial walk ----
    unordered = study_rays(cs, "cuda")
    un_c, un_a, un_times = unordered_phase(main_t, shadow_t, unordered)
    walks_phase((("primary", (po, pd, ptm), main_t, False),
                 ("primary shadow", (so, sd, stm), shadow_t, True),
                 ("unordered bounce", unordered["bounce"], main_t, False),
                 ("unordered shadow", unordered["shadow"], shadow_t, True)))
    un_bounce = unordered["bounce"]
    del unordered
    lap("unordered_and_walks")

    # --- the stats kernel vs the stats-free kernel and its twin -----------
    st_stats, st_times = stats_phase(
        main_t, (("compare", (o, d, tm)), ("primary", (po, pd, ptm)),
                 ("unordered bounce", un_bounce)),
        dict(primary="stats", **{"unordered bounce": "unordered"}))
    # The rows each walk reads, and the any-hit walk's pops and clusters
    # (the stats twin's walk, in the any-hit kernel's mode).
    pri_rows = traverse.walk_footprint(po, pd, ptm, *main_t)[:2]
    sh_walk = traverse.walk_footprint(so, sd, stm, *shadow_t, any_hit=True)
    n_pri = po.shape[0]
    pri_tables = (row_bytes(main_t[0], pri_rows[0])
                  + row_bytes(main_t[1], pri_rows[1]))
    walk_rows = dict(
        primary_node_rows=int(pri_rows[0].sum()),
        primary_cluster_rows=int(pri_rows[1].sum()),
        shadow_node_rows=int(sh_walk[0].sum()),
        shadow_cluster_rows=int(sh_walk[1].sum()),
        shadow_pops=int(sh_walk[2].sum()),
        shadow_clusters=int(sh_walk[3].sum()))
    print("rows read by the walks:", json.dumps(walk_rows))
    walk_bytes = dict(
        closest=nbytes(po, pd, ptm) + pri_tables + 16 * n_pri,
        stats=nbytes(po, pd, ptm) + pri_tables + 24 * n_pri,
        anyhit=nbytes(so, sd, stm) + row_bytes(shadow_t[0], sh_walk[0])
        + row_bytes(shadow_t[1], sh_walk[1]) + so.shape[0])
    pri = st_stats["primary"]
    closest_ops = walk_ops(pri["live"], pri["pops"], pri["clusters"],
                           main_t[0])
    anyhit_ops = walk_ops(int((stm > 0).sum()), walk_rows["shadow_pops"],
                          walk_rows["shadow_clusters"], shadow_t[0])
    del full_k, full_p, sh_k, sh_p, sh_walk, pri_rows, ck, cp, ak, ap, hits
    lap("stats")

    # --- the v1 kernel vs its plain version ---------------------------------
    v1_stats, v1_times, v1_bound = v1_phase(cs, scene, (o, d, tm),
                                            (po, pd, ptm), un_bounce)
    del un_bounce
    lap("v1")

    # --- the opt-in paths' kernels vs their twins ---------------------------
    opt_stats, opt_times = opt_in_kernel_phase(
        scene, (o, d, tm), (po, pd, ptm), (so, sd, stm))
    bounce_stats, bounce_sums = binned_bounce_phase()
    cut_stats, cut_sums = cut_bounce_phase()
    bn_select = [opt_stats["select_compare"], opt_stats["select_primary"],
                 *(v for k, v in bounce_stats.items()
                   if k.startswith("select"))]
    bn_dense = [opt_stats["dense_compare"], opt_stats["dense_primary"],
                *(v for k, v in bounce_stats.items()
                  if k.startswith("dense"))]
    del scene, cs, o, d, tm, po, pd, ptm, so, sd, stm
    lap("opt_in_kernels")

    # --- the slice: default, cut and binned paths ---------------------------
    _, launches = render_slice(torch, Renderer, "default", {},
                               ("closest", "anyhit"))
    cornell_phase(torch, Renderer)
    cut_res, cut_launches = render_slice(torch, Renderer, "TB_CUT=1",
                                         {"TB_CUT": "1"},
                                         ("emit", "closest", "anyhit"),
                                         heatmap=True)
    _, bn_launches = render_slice(torch, Renderer, "TB_BINNED=1",
                                  {"TB_BINNED": "1"},
                                  ("select", "dense", "closest", "anyhit"))

    wave_bounce_phase()
    lap("slice")

    # --- the first-hit AOV slice and the denoiser ---------------------------
    r, _, heat_launches = aov_slice_phase(torch, Renderer)
    denoise_phase(torch, r.resolve_radiance())
    del r
    lap("aov_and_denoiser")

    # --- path parity ------------------------------------------------------
    parity_phase(torch, Renderer)
    lap("parity")

    # --- the traversal study and RealTime mode ------------------------------
    _, study_launches = study_phase()
    lap("study")
    _, rt_launches = realtime_phase(torch, Renderer)
    lap("realtime")

    # --- the command-line renderer on a PBRT scene ----------------------------
    # Scenes the CLI and instanced phases write, which the animation phase
    # reuses; removed before the result line.
    work = tempfile.TemporaryDirectory(prefix="tb_smoke_")
    cli_res, cli_launches = cli_phase(torch, work.name)
    env_nee, env_closest = cli_res["env_nee"], cli_res["env_closest"]
    lap("cli")

    # --- textured PBRT scenes: cutouts, normal maps, transparent shadows ---
    tex_res, tex_launches = textured_phase(torch, Renderer)
    tex_kinds = tex_res["kinds"]
    tex_par = tex_res["parity_launches"]
    lap("textured")

    # --- instanced PBRT scenes (TLAS/BLAS), .pbf, OBJ/glTF, TGA/BMP --------
    inst_res, inst_launches = instanced_phase(torch, work.name)
    inst_blas = inst_res["blas"]
    lap("instanced")

    # --- a heterogeneous volume (.vdb) through the CLI; the estimators ----
    vol_res, vol_launches = volume_phase(torch)
    vol_c, vol_a = vol_res["closest"], vol_res["anyhit"]
    lap("volume")
    est_res, est_launches = estimators_phase(torch, Renderer)
    adap_c = est_res["adaptive_burst"]["closest"]
    lap("estimators")

    # --- animated geometry: the on-device rebuild; the viewer -------------
    anim_res, anim_launches = animation_phase(
        torch, Renderer, cli_res["env_scene"], inst_res.pop("forest"))
    anim_c, anim_a = anim_res["closest"], anim_res["anyhit"]
    anim_blas = anim_res["forest"]["blas"]
    lap("animation")

    # --- the ML extras: the fine-tune's dataset and training, upscalers ---
    ml_res, ml_launches = ml_phase(torch)
    ml_c, ml_a = ml_res["closest"], ml_res["anyhit"]
    lap("ml")

    # --- tile and sample sharding; the port's JPEG decoder ----------------
    shard_res, shard_launches = sharding_phase(torch, Renderer,
                                               cli_res["env_scene"])
    shard_c, shard_a = shard_res["closest"], shard_res["anyhit"]
    work.cleanup()
    lap("sharding")
    jpeg_res, jpeg_launches = jpeg_phase(torch)
    jpeg_kinds = {**jpeg_res["kinds"],
                  **{f"arith_{k}": v
                     for k, v in jpeg_res["arith_kinds"].items()}}
    lap("jpeg")
    dds_res, dds_launches = dds_phase(torch)
    dds_kinds = dds_res["kinds"]
    lap("dds")
    tiff_res, tiff_launches = tiff_phase(torch)
    tiff_kinds = tiff_res["kinds"]
    lap("tiff")
    webp_res, webp_launches = webp_phase(torch)
    webp_kinds = webp_res["kinds"]
    lap("webp")
    j2k_res, j2k_launches = j2k_phase(torch)
    j2k_kinds = j2k_res["kinds"]
    lap("j2k")
    avif_res, avif_launches = avif_phase(torch)
    avif_kinds = {**avif_res["kinds"],
                  **{f"{pre}_{k}": v for pre in ("copy_grain", "grid")
                     for k, v in avif_res[f"{pre}_kinds"].items()}}
    lap("avif")
    small_res, small_launches = small_phase(torch)
    small_kinds = {**small_res["kinds"],
                   **{f"{pre}_{k}": v for pre in ("small2", "small3")
                      for k, v in small_res[f"{pre}_kinds"].items()}}
    lap("small")
    writers_res, writers_launches = writers_phase(torch)
    writers_c, writers_a = writers_res["closest"], writers_res["anyhit"]
    icns_c, icns_a = writers_res["icns_closest"], writers_res["icns_anyhit"]
    wwebp_c, wwebp_a = (writers_res["webp_closest"],
                        writers_res["webp_anyhit"])
    lap("writers")
    print("phase seconds:", json.dumps(laps))

    def by_path(key):
        return {"default": launches[key], "cut": cut_launches[key],
                "binned": bn_launches[key], "study": study_launches[key],
                "realtime": rt_launches[key], "cli": cli_launches[key],
                "textured": tex_launches[key],
                "instanced": inst_launches[key],
                "volume": vol_launches[key],
                "estimators": est_launches[key],
                "animation": anim_launches[key], "ml": ml_launches[key],
                "sharding": shard_launches[key],
                "jpeg": jpeg_launches[key], "dds": dds_launches[key],
                "tiff": tiff_launches[key], "webp": webp_launches[key],
                "j2k": j2k_launches[key], "avif": avif_launches[key],
                "small": small_launches[key],
                "writers": writers_launches[key]}

    trav = "tracerboy_tpu_torch/csrc/bvh_traverse.cu"
    bsrc = "tracerboy_tpu_torch/csrc/binned.cu"
    roots_c = [v for k, v in opt_stats.items()
               if k.startswith("closest_roots")]
    roots_a = [v for k, v in opt_stats.items()
               if k.startswith("anyhit_roots")]
    emits = [*(v for k, v in opt_stats.items() if k.startswith("emit")),
             *cut_stats.values()]
    print(json.dumps({"kernels": [
        dict(name="closest_hit", route="cuda", source=trav,
             replaces="tracerboy_tpu/trace/pallas_traverse2.py:754",
             launches=launches["closest"],
             launches_by_path=by_path("closest"),
             max_abs_err=max(s["max_abs_err"] for s in
                             [st_c, st_c2, un_c, *roots_c, env_closest,
                              *tex_kinds.values(),
                              *inst_res["kinds"].values(), vol_c, adap_c,
                              anim_c, anim_blas, ml_c, shard_c,
                              *jpeg_kinds.values(), *dds_kinds.values(),
                              *tiff_kinds.values(),
                              *webp_kinds.values(), *j2k_kinds.values(),
                              *avif_kinds.values(), *small_kinds.values(),
                              writers_c, icns_c, wwebp_c]),
             id_mismatch_outside_ties=sum(
                 s["id_mismatch_outside_ties"]
                 for s in [st_c, st_c2, un_c, *roots_c, env_closest,
                           *tex_kinds.values(),
                           *inst_res["kinds"].values(), vol_c, adap_c,
                           anim_c, anim_blas, ml_c, shard_c,
                           *jpeg_kinds.values(), *dds_kinds.values(),
                           *tiff_kinds.values(),
                           *webp_kinds.values(), *j2k_kinds.values(),
                           *avif_kinds.values(), *small_kinds.values(),
                           writers_c, icns_c, wwebp_c]),
             ms=times["closest_ms"], plain_ms=times["closest_plain_ms"],
             unordered_ms=un_times["closest_ms"],
             unordered_plain_ms=un_times["closest_plain_ms"],
             **bound_keys(walk_bytes["closest"], closest_ops),
             roots_ms=opt_times["closest_roots_ms"],
             roots_plain_ms=opt_times["closest_roots_plain_ms"],
             cli_env_ms=env_closest["ms"],
             cli_env_plain_ms=env_closest["plain_ms"],
             cli_env_bound_ms=env_closest["bound_ms"],
             cli_env_launches=env_closest["launches"],
             cli_env_max_abs_err=env_closest["max_abs_err"],
             cli_env_id_mismatch_outside_ties=env_closest[
                 "id_mismatch_outside_ties"],
             textured_kinds={
                 kind: {key: row[key] for key in (
                     "launches", "lanes", "live", "live_share", "checked",
                     "ms", "bound_ms", "bound_by",
                     "hit_mismatch", "id_mismatch_outside_ties", "ties",
                     "max_rel_t_err", "overflows")}
                 for kind, row in tex_kinds.items()},
             textured_load=tex_res["load"],
             textured_render_sample8=tex_res["render_sample8"],
             blas_launches=inst_blas["launches"], blas_ms=inst_blas["ms"],
             blas_bound_ms=inst_blas["bound_ms"],
             blas_live_share=inst_blas["live_share"],
             blas_checked=inst_blas["checked"],
             blas_id_mismatch_outside_ties=inst_blas[
                 "id_mismatch_outside_ties"],
             blas_ties=inst_blas["ties"],
             blas_overflows=inst_blas["overflows"],
             instanced_kinds={
                 kind: {key: row[key] for key in (
                     "launches", "lanes", "live", "live_share", "checked",
                     "ms", "bound_ms", "hit_mismatch",
                     "id_mismatch_outside_ties", "ties", "overflows")}
                 for kind, row in inst_res["kinds"].items()},
             forest=inst_res["tlas_vs_pbf"],
             **{f"{pre}_{key}": row[key]
                for pre, row in (("volume", vol_c), ("adaptive", adap_c),
                                 ("animation", anim_c))
                for key in ("launches", "lanes", "live", "live_share",
                            "checked", "ms", "bound_ms", "bound_by",
                            "hit_mismatch", "id_mismatch_outside_ties",
                            "ties", "max_abs_err", "overflows")},
             **{f"animation_blas_{key}": anim_blas[key] for key in (
                 "launches", "lanes", "live", "live_share", "checked",
                 "hit_mismatch", "id_mismatch_outside_ties", "ties",
                 "max_abs_err", "overflows")},
             **{f"{pre}_{key}": row[key]
                for pre, row in (("ml", ml_c), ("sharding", shard_c),
                                 ("writers", writers_c),
                                 ("writers_icns", icns_c),
                                 ("writers_webp", wwebp_c))
                for key in (
                 "launches", "lanes", "live", "live_share", "checked",
                 "hit_mismatch", "id_mismatch_outside_ties", "ties",
                 "max_rel_t_err", "max_abs_err", "overflows")},
             **{f"{pre}_kinds": {
                 kind: {key: row[key] for key in (
                     "launches", "lanes", "live", "live_share", "checked",
                     "hit_mismatch", "id_mismatch_outside_ties", "ties",
                     "max_rel_t_err", "overflows")}
                 for kind, row in kinds.items()}
                for pre, kinds in (("jpeg", jpeg_kinds), ("dds", dds_kinds),
                                   ("tiff", tiff_kinds),
                                   ("webp", webp_kinds),
                                   ("j2k", j2k_kinds),
                                   ("avif", avif_kinds),
                                   ("small", small_kinds))},
             sharding_runs=shard_res["runs"],
             sharding_ms_a_sample=shard_res["ms_a_sample"],
             jpeg_decode_1024=jpeg_res["decode_1024"],
             jpeg_decode_1024_arith=jpeg_res["decode_1024_arith"],
             jpeg_arith_cli=jpeg_res["arith_cli"],
             dds_decode_512_bc7=dds_res["decode_512_bc7"],
             tiff_decode_1024_lzw=tiff_res["decode_1024_lzw"],
             tiff_decode_1024_deflate=tiff_res["decode_1024_deflate"],
             tiff_decode_1024_jpeg_ycbcr=tiff_res["decode_1024_jpeg_ycbcr"],
             tiff_decode_1024_zstd=tiff_res["decode_1024_zstd"],
             **{f"webp_decode_1024_{key}": webp_res[f"decode_1024_{key}"]
                for key in ("lossy", "lossless", "qoi")},
             **{f"j2k_decode_1024_{key}": j2k_res[f"decode_1024_{key}"]
                for key in ("lossless", "97")},
             **{f"avif_decode_1024_{key}": avif_res[f"decode_1024_{key}"]
                for key in ("420", "lossless", "default", "plain", "grain",
                            "grid", "fcc")},
             avif_copy_grain_cli=avif_res["copy_grain_cli"],
             avif_grid_cli=avif_res["grid_cli"],
             **{key.replace("decode_", "small_decode_"): row
                for key, row in small_res.items()
                if key.startswith("decode_")},
             small_cli=small_res["cli"],
             small2_cli=small_res["small2_cli"],
             small3_cli=small_res["small3_cli"],
             writers_cli=writers_res["cli"],
             writers_icns_cli=writers_res["icns_cli"],
             writers_webp_cli=writers_res["webp_cli"],
             writers_files=writers_res["files"],
             writers_webp_extra=writers_res["webp_extra"],
             writers_webp_alpha=writers_res["webp_alpha"],
             writers_webp_rgba=writers_res["webp_rgba"],
             writers_write_1280x720=writers_res["write_1280x720"],
             volume_run=vol_res["run"],
             volume_control=vol_res["control"],
             estimators={k: {kk: vv for kk, vv in v.items()
                             if kk != "closest"}
                         for k, v in est_res.items()}),
        dict(name="closest_hit_stats", route="cuda", source=trav,
             replaces="tracerboy_tpu/trace/pallas_traverse2.py:754 "
                      "(stats=True)",
             launches=heat_launches + cut_res["heatmap_launches"][
                 "closest_stats"] + anim_launches["closest_stats"],
             launches_by_path={"default": heat_launches,
                               "cut": cut_res["heatmap_launches"][
                                   "closest_stats"],
                               "animation": anim_launches["closest_stats"]},
             max_abs_err=max(s["max_abs_err"] for s in st_stats.values()),
             count_mismatch=sum(s["count_mismatch"]
                                for s in st_stats.values()),
             ms=st_times["stats_ms"], plain_ms=st_times["primary_plain_ms"],
             stats_free_ms=st_times["stats_free_ms"],
             unordered_ms=st_times["unordered_ms"],
             unordered_plain_ms=st_times["unordered bounce_plain_ms"],
             unordered_free_ms=st_times["unordered_free_ms"],
             **bound_keys(walk_bytes["stats"], closest_ops)),
        dict(name="any_hit", route="cuda", source=trav,
             replaces="tracerboy_tpu/trace/pallas_traverse2.py:869",
             launches=launches["anyhit"],
             launches_by_path=by_path("anyhit"),
             occ_mismatch=sum(s["occ_mismatch"]
                              for s in [st_a, st_a2, un_a, *roots_a,
                                        anim_a, ml_a, shard_a, writers_a,
                                        icns_a, wwebp_a]),
             max_abs_err=max(s["max_abs_err"]
                             for s in [st_a, st_a2, un_a, *roots_a,
                                       anim_a, ml_a, shard_a, writers_a,
                                       icns_a, wwebp_a]),
             ms=times["anyhit_ms"], plain_ms=times["anyhit_plain_ms"],
             unordered_ms=un_times["anyhit_ms"],
             unordered_plain_ms=un_times["anyhit_plain_ms"],
             **bound_keys(walk_bytes["anyhit"], anyhit_ops),
             roots_ms=opt_times["anyhit_roots_ms"],
             roots_plain_ms=opt_times["anyhit_roots_plain_ms"],
             env_nee_ms=env_nee["ms"], env_nee_plain_ms=env_nee["plain_ms"],
             env_nee_bound_ms=env_nee["bound_ms"],
             env_nee_launches=env_nee["launches"],
             env_nee_occ_mismatch=env_nee["occ_mismatch"],
             **{f"{pre}_{key}": row[key]
                for pre, row in (("volume", vol_a), ("animation", anim_a))
                for key in (
                 "launches", "lanes", "live", "live_share", "checked",
                 "ms", "plain_ms", "bound_ms", "bound_by", "occ_mismatch",
                 "occluded", "max_abs_err", "overflows")},
             **{f"{pre}_{key}": row[key]
                for pre, row in (("ml", ml_a), ("sharding", shard_a),
                                 ("writers", writers_a),
                                 ("writers_icns", icns_a),
                                 ("writers_webp", wwebp_a))
                for key in (
                 "launches", "lanes", "live", "live_share", "checked",
                 "occ_mismatch", "occluded", "max_abs_err", "overflows")}),
        dict(name="emit_cuts", route="cuda",
             source="tracerboy_tpu_torch/csrc/cut_emit.cu",
             replaces="tracerboy_tpu/trace/pallas_traverse2.py:657",
             launches=cut_launches["emit"],
             set_mismatch=sum(s["set_mismatch"] for s in emits),
             order_mismatch=sum(s["order_mismatch"] for s in emits),
             max_abs_err=max(s["max_abs_err"] for s in emits),
             ms=opt_times["emit_ms"], plain_ms=opt_times["emit_plain_ms"],
             **bound_keys(opt_times["emit_bytes"], opt_times["emit_ops"]),
             bounce_ms=cut_sums["ms"], bounce_plain_ms=cut_sums["plain_ms"],
             bounce_bound_ms=cut_sums["bound_ms"],
             bounce_launches=cut_sums["launches"],
             over_budget_rows=cut_sums["over_budget_rows"],
             over_budget_ms=cut_sums["over_budget_ms"],
             textured_parity_launches=tex_par["cut"]["emit"]),
        dict(name="select_clusters", route="cuda", source=bsrc,
             replaces="tracerboy_tpu/trace/binned.py:363",
             launches=bn_launches["select"],
             max_abs_err=max(s["max_abs_err"] for s in bn_select),
             set_mismatch=sum(s["set_mismatch"] for s in bn_select),
             ties=sum(s["ties"] for s in bn_select),
             dropped_violations=sum(s["dropped_violations"]
                                    for s in bn_select),
             ms=opt_times["select_ms"], plain_ms=opt_times["select_plain_ms"],
             **bound_keys(opt_times["select_bytes"], opt_times["select_ops"]),
             bounce_ms=bounce_sums["select"]["ms"],
             bounce_plain_ms=bounce_sums["select"]["plain_ms"],
             bounce_bound_ms=bounce_sums["select"]["bound_ms"],
             bounce_launches=bounce_sums["select"]["launches"],
             textured_parity_launches=tex_par["binned"]["select"]),
        dict(name="dense_pairs", route="cuda", source=bsrc,
             replaces="tracerboy_tpu/trace/binned.py:554",
             launches=bn_launches["dense"],
             max_abs_err=max(s["max_abs_err"] for s in bn_dense),
             max_rel_t_err=max(s["max_rel_t_err"] for s in bn_dense),
             hit_mismatch=sum(s["hit_mismatch"] for s in bn_dense),
             id_mismatch_outside_ties=sum(s["id_mismatch_outside_ties"]
                                          for s in bn_dense),
             ms=opt_times["dense_ms"], plain_ms=opt_times["dense_plain_ms"],
             **bound_keys(opt_times["dense_bytes"], opt_times["dense_ops"]),
             bounce_ms=bounce_sums["dense"]["ms"],
             bounce_plain_ms=bounce_sums["dense"]["plain_ms"],
             bounce_bound_ms=bounce_sums["dense"]["bound_ms"],
             bounce_launches=bounce_sums["dense"]["launches"],
             textured_parity_launches=tex_par["binned"]["dense"]),
        dict(name="closest_hit_v1", route="cuda",
             source="tracerboy_tpu_torch/csrc/bvh_traverse_v1.cu",
             replaces="tracerboy_tpu/trace/pallas_traverse.py:299",
             launches=study_launches["closest_v1"],
             max_abs_err=max(s["max_abs_err"] for s in v1_stats.values()),
             id_mismatch_outside_ties=sum(
                 s["id_mismatch_outside_ties"] for s in v1_stats.values()),
             stack_overflows=sum(s["stack_overflows"]
                                 for s in v1_stats.values()),
             differs_from_closest_hit=v1_stats["primary"][
                 "differs_from_closest_hit"],
             ms=v1_times["v1_ms"], plain_ms=v1_times["primary_plain_ms"],
             closest_hit_ms=v1_times["closest_ms"],
             unordered_ms=v1_times["unordered_ms"],
             unordered_plain_ms=v1_times["unordered_plain_ms"],
             unordered_closest_hit_ms=v1_times["unordered_closest_ms"],
             **v1_bound),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
