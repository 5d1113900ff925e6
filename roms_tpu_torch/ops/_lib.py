"""Build, load and count the hand-written CUDA kernels.

All sources under `roms_tpu_torch/csrc/` compile with nvcc for Hopper
(`-gencode arch=compute_90a,code=sm_90a`) into ONE shared library with
a plain C interface, loaded with ctypes.  Each `.cu` compiles in its
own nvcc process, all started together, then one link step.  The build
happens on the first CUDA launch (or an explicit `build()`), never at
import, so the package imports without a compiler.  Builds are cached
under `roms_tpu_torch/_build/<source hash>/`, which .gitignore lists.

Each wrapper counts its launches in `launches[name]`: one per kernel
launch, nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# launch counts of the eighteen kernel entry points (one per wrapper
# call; fast_loop_res launches ops/step2d.HALF_STEPS CUDA kernels a
# substep; fast_loop_blocked counts each of its launches, one per chunk of
# ops/step2d.chunk_schedule; tridiag is csrc/tridiag.cu's
# roms_tridiag_f32/_f64)
launches = {name: 0 for name in (
    "rho_eos", "tadv_predictor", "tadv_corrector", "rhs3d_momentum",
    "uv_solve", "uv_finish", "spline_vdiff", "flux_omega", "omega",
    "prsgrd32", "uv3dmix2_s", "fast_loop_res", "fast_loop_blocked",
    "bulk_flux", "kpp", "prep", "rot_div_geo", "tridiag")}

_lib = None
build_seconds = None
build_dir = None

P = ctypes.c_void_p
I = ctypes.c_int
D = ctypes.c_double


def reset_launches():
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "on a machine with the CUDA toolkit")
    return found


def _sources():
    return sorted(SRC_DIR.glob("*.cu")), sorted(SRC_DIR.glob("*.cuh"))


def build() -> Path:
    """Compile csrc/*.cu into the shared library (cached by content)."""
    global build_seconds, build_dir
    cus, hdrs = _sources()
    h = hashlib.sha256(repr(NVCC_FLAGS).encode())
    for f in cus + hdrs:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / "libroms_tpu_kernels.so"
    build_dir = out_dir
    if lib.exists():
        build_seconds = 0.0
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in cus:
        obj = out_dir / (src.stem + ".o")
        log = open(out_dir / (src.stem + ".log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(SRC_DIR), "-c", str(src),
               "-o", str(obj)]
        procs.append((src, obj, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for src, _, log, proc in procs:
        proc.wait()
        log.close()
        if proc.returncode != 0:
            failed.append(src.name + ":\n" + (out_dir / (
                src.stem + ".log")).read_text())
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = out_dir / (lib.name + ".tmp")
    res = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                          *[str(o) for _, o, _, _ in procs]],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + res.stdout + res.stderr)
    tmp.replace(lib)
    build_seconds = time.perf_counter() - t0
    return lib


def ptxas_report() -> str:
    """The per-kernel register, spill and static shared memory lines of
    the last build, each under the kernel's (demangled) name."""
    if build_dir is None:
        return ""
    lines = []
    for log in sorted(build_dir.glob("*.log")):
        for line in log.read_text().splitlines():
            if "Compiling entry function" in line:
                name = _demangle(line.split("'")[1])
                lines.append(f"{log.stem}: {name}")
            elif "registers" in line or "spill" in line:
                lines.append(f"{log.stem}:   {line.strip()}")
    return "\n".join(lines)


def _demangle(name: str) -> str:
    filt = shutil.which("c++filt")
    if filt is None:
        return name
    return subprocess.run([filt, name], capture_output=True,
                          text=True).stdout.strip() or name


def lib():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
        _lib.roms_cuda_error_string.argtypes = [I]
        _lib.roms_cuda_error_string.restype = ctypes.c_char_p
    return _lib


def func(name: str, argtypes):
    f = getattr(lib(), name)
    if f.argtypes is None:
        f.argtypes = argtypes
        f.restype = I
    return f


def suffix(dtype: torch.dtype) -> str:
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.float64:
        return "f64"
    raise TypeError(f"kernels take float32 or float64, not {dtype}")


def check(rc: int, name: str):
    if rc != 0:
        msg = lib().roms_cuda_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: {msg} ({rc})")


# shared memory one block may use on the H100 (227 KB)
SMEM_PER_BLOCK = 232448


def even_tiles(Mj: int, Li: int, tile):
    """(TJ, TI): tiles of at most `tile` (rows, lanes), as few as will
    do, evened out over an (Mj, Li) grid."""
    nj, ni = -(-Mj // tile[0]), -(-Li // tile[1])
    return -(-Mj // nj), -(-Li // ni)


def seam_tiles(Mj: int, Li: int, tile):
    """(TJ, TI, blocks) of a k-marching tiled kernel (csrc/common.cuh
    Tile): `even_tiles`, with a tile of fewer than five lanes widened (up
    to the grid's width).  The kernel shifts its lane tiling by TI // 2,
    and the periodic seam's ring lanes Li-2 .. 1 lie in one tile only if
    it is that wide."""
    TJ, TI = even_tiles(Mj, Li, tile)
    TI = max(TI, min(Li, 5))
    return TJ, TI, -(-Mj // TJ) * -(-Li // TI)


def prepare(name: str, tensors):
    """Check that every tensor lies on one CUDA device in one float
    dtype; return contiguous copies (views when already contiguous),
    the dtype suffix and the current stream handle.

    The kernel runs later on that stream; temporaries the wrapper frees
    after the launch are safe, because PyTorch's caching allocator only
    hands their memory to work queued after it on the same stream."""
    dev = tensors[0].device
    dtype = tensors[0].dtype
    if dev.type != "cuda":
        raise ValueError(f"{name}: kernel launch needs CUDA tensors")
    if dev.index is not None and dev.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensors on {dev}, but the current "
                         f"device is cuda:{torch.cuda.current_device()}")
    out = []
    for t in tensors:
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name}: mixed devices or dtypes "
                             f"({t.device}, {t.dtype} vs {dev}, {dtype})")
        if t.numel() >= 2 ** 31:
            raise ValueError(f"{name}: tensor too large for int32 indexing")
        out.append(t.contiguous())
    stream = torch.cuda.current_stream(dev).cuda_stream
    return out, suffix(dtype), stream


def ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())
