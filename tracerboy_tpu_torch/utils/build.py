"""Build native sources of the port into shared libraries, at first use.

Both the CUDA kernels (csrc/*.cu, nvcc) and the host BVH builder
(native/bvh_builder.cpp, g++) are compiled into BUILD_DIR, a directory
that .gitignore lists, and loaded with ctypes. The library name carries a
hash of the command line and of every source's and header's bytes, so an
edited source rebuilds and an unchanged one is reused. A failed build
raises with the compiler's output; nothing falls back.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]
BUILD_DIR = REPO_ROOT / "build" / "tracerboy_tpu_torch"


def build_shared_library(name: str, sources, command, headers=()) -> Path:
    """Compile `sources` with `command` (compiler and flags, without -o)
    into BUILD_DIR/lib<name>-<hash>.so and return its path. `headers` are
    the files the sources include: they enter the hash, not the command."""
    sources = [Path(s) for s in sources]
    digest = hashlib.sha256()
    for part in command:
        digest.update(part.encode() + b"\0")
    for src in [*sources, *map(Path, headers)]:
        digest.update(src.read_bytes())
    out = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Per-process temporary name + atomic rename: concurrent test workers
    # may build the same library at once.
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [*command, "-o", str(tmp), *map(str, sources)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"building {name} failed ({res.returncode}):\n"
            f"{' '.join(cmd)}\n{res.stdout}{res.stderr}"
        )
    os.replace(tmp, out)
    return out


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    default = os.path.join(home, "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or under $CUDA_HOME/bin)")
