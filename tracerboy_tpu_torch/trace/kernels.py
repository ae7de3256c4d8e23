"""What the port's CUDA kernel wrappers share.

- load_library builds one kernel source (csrc/*.cu) with nvcc for
  sm_90a at first use (utils/build.py) and loads it with ctypes;
- check_inputs and ray_specs validate a wrapper's tensors;
- launch calls a kernel's C entry on the device's current stream, with
  the device's stack-overflow counter appended where the kernel keeps a
  stack;
- LAUNCHES counts kernel launches and TWIN_CALLS calls that went to the
  plain twins (CPU tensors), under the keys each kernel module
  registers; reset_counters() zeroes them and the overflow counters;
- bin_pairs and nearest_of are the pair glue of the cut (trace/cut.py)
  and binned (trace/binned.py) backends: expand a per-ray id table into
  (ray, id) pairs sorted by id, and take each ray's nearest pair hit;
- ptxas_usage compiles every kernel source with the same flags plus
  -Xptxas -v and returns ptxas's registers, stack and spills per kernel:

      python -m tracerboy_tpu_torch.trace.kernels
"""

from __future__ import annotations

import ctypes

import torch

from tracerboy_tpu_torch.utils.build import (
    BUILD_DIR,
    REPO_ROOT,
    build_shared_library,
    nvcc_path,
)

BIG = 1e30
CSRC = REPO_ROOT / "tracerboy_tpu_torch" / "csrc"
HEADERS = [CSRC / "bvh_common.cuh"]
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", f"-I{CSRC}",
]

LAUNCHES: dict = {}
TWIN_CALLS: dict = {}
_overflow: dict = {}


def register(*names):
    """Add counter keys for a module's kernels."""
    for name in names:
        LAUNCHES.setdefault(name, 0)
        TWIN_CALLS.setdefault(name, 0)


def reset_counters():
    """Zero the launch and twin-call counts and every overflow counter."""
    for d in (LAUNCHES, TWIN_CALLS):
        for k in d:
            d[k] = 0
    for buf in _overflow.values():
        buf.zero_()


def stack_overflows() -> int:
    """Pushes dropped because a ray's stack was full, summed over the
    devices that ran a kernel since the last reset (should be 0)."""
    return sum(int(buf.item()) for buf in _overflow.values())


def add_overflows(device, count: int):
    """Count pushes a plain twin dropped, as a kernel counts its own."""
    _overflow_buffer(device).add_(count)


def load_library(name, source, signatures):
    """Build (or reuse) the library of one kernel source with nvcc and
    load it; signatures: {function: argument types}, every function
    returning its launch's CUDA error code."""
    path = build_shared_library(name, [source], [nvcc_path(), *NVCC_FLAGS],
                                headers=HEADERS)
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in signatures.items():
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = argtypes
    return lib


def check_inputs(ref, *specs):
    """Raise ValueError unless every (name, tensor, shape, dtype) matches,
    is contiguous and lies on ref's device, a CPU or CUDA device."""
    for name, x, shape, dtype in specs:
        if tuple(x.shape) != tuple(shape) or x.dtype != dtype:
            raise ValueError(f"{name}: expected {tuple(shape)} {dtype}, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != ref.device:
            raise ValueError(f"{name} is on {x.device}, not {ref.device}")
    if ref.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {ref.device}")
    if ref.shape[0] >= 2**31:
        raise ValueError("too many rays for one launch")


def ray_specs(o, d, t_max):
    n = o.shape[0]
    return (("o", o, (n, 3), torch.float32), ("d", d, (n, 3), torch.float32),
            ("t_max", t_max, (n,), torch.float32))


def _overflow_buffer(device):
    buf = _overflow.get(device)
    if buf is None:
        buf = torch.zeros((), dtype=torch.int32, device=device)
        _overflow[device] = buf
    return buf


def launch(lib, fn_name, device, *args, overflow=True):
    """Call fn_name(*args[, overflow counter], stream) of lib on device's
    current stream (tensors pass as pointers, None as a null pointer);
    raise if the launch failed."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                for a in args]
        if overflow:
            ptrs.append(_overflow_buffer(device).data_ptr())
        rc = getattr(lib, fn_name)(*ptrs, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA launch failed with error {rc}")


def bin_pairs(ids):
    """The (ray, id) pairs of a per-ray id table (N, K), -1 = empty
    (emit's subtrees, the selection's clusters), sorted by id (stable):
    (pair index ray*K + slot, id), both (P,)."""
    flat = ids.reshape(-1)
    pos = (flat >= 0).nonzero(as_tuple=True)[0]
    key, order = torch.sort(flat[pos], stable=True)
    return pos[order], key


def nearest_of(pos, n, k, hits):
    """Per ray, the nearest of its pairs' hits: pair pos (ray*k + slot)
    holds hits = (t, tri, u, v), t = 1e30 on a miss; empty slots miss.
    The lowest slot wins a tie (the JAX package's argmin). Returns
    (t, tri, u, v), each (n,)."""
    t, tri, u, v = hits
    bufs = (torch.full((n * k,), BIG, dtype=torch.float32, device=t.device),
            torch.full((n * k,), -1, dtype=torch.int32, device=t.device),
            torch.zeros(n * k, dtype=torch.float32, device=t.device),
            torch.zeros(n * k, dtype=torch.float32, device=t.device))
    for buf, val in zip(bufs, (t, tri, u, v)):
        buf[pos] = val
    slot = torch.argmin(bufs[0].reshape(n, k), dim=1, keepdim=True)
    return tuple(x.reshape(n, k).gather(1, slot)[:, 0] for x in bufs)


def ptxas_usage() -> dict:
    """{source name: ptxas's resource lines} of every csrc/*.cu, built
    with NVCC_FLAGS and -Xptxas -v into BUILD_DIR/ptxas."""
    import subprocess

    out_dir = BUILD_DIR / "ptxas"
    out_dir.mkdir(parents=True, exist_ok=True)
    report = {}
    for src in sorted(CSRC.glob("*.cu")):
        res = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(out_dir / f"{src.stem}.so"), str(src)],
            capture_output=True, text=True, check=True)
        report[src.name] = [
            line.strip() for line in (res.stdout + res.stderr).splitlines()
            if "ptxas info" in line or "stack frame" in line]
    return report


if __name__ == "__main__":
    for name, lines in ptxas_usage().items():
        print(name)
        print("\n".join(lines))
