"""Shared kernel helpers: device resolution and the CUDA build-and-load.

Every kernel source lives beside its Python wrapper as
`kernels/<name>/csrc/*.cu` with a plain C interface, and any header it
includes as `csrc/*.cuh`. At first use, `load_kernels()` compiles the
`.cu` files with `nvcc` for `sm_90a` (one `nvcc -c` per source, all
started together, then one link) into `build/repro_torch/libkernels.so`
at the repository root, and loads the library with ctypes. The library
is rebuilt when the content hash of the sources, headers or flags
changes. Nothing is downloaded and nothing outside the
repository's sources is compiled.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
REPO_ROOT = PACKAGE_DIR.parents[1]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; raises RuntimeError when CUDA is asked
    for and this process has no card, instead of running on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch sees no CUDA "
            f"device; pass device='cpu' to run on the CPU")
    return device


def launch_stream(device) -> int:
    """The raw handle of `device`'s current CUDA stream, for a launch
    (torch.cuda.current_stream(device).cuda_stream builds a Stream object
    first: ~5 us more of host time per launch)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


_CURRENT = contextlib.nullcontext()  # reusable: no object a call


def on_device(device):
    """Make `device` current around a launch: a no-op context where it
    already is (entering torch.cuda.device costs ~5 us of host time)."""
    if device.index == torch.cuda.current_device():
        return _CURRENT
    return torch.cuda.device(device)


def kernel_sources():
    """Every kernel source and header (`csrc/*.cu`, `csrc/*.cuh`): the
    build compiles the sources, and the digest covers both."""
    return sorted([*PACKAGE_DIR.glob("kernels/*/csrc/*.cu"),
                   *PACKAGE_DIR.glob("kernels/*/csrc/*.cuh")])


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built at "
                           "first use on a machine with the CUDA toolkit")
    return found


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.relative_to(PACKAGE_DIR).as_posix().encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def build_kernels() -> tuple:
    """Compile the kernel sources unless an up-to-date library exists.
    Returns (library path, compiler log); the log holds ptxas's
    register and shared-memory report of a fresh build, else is empty."""
    files = kernel_sources()
    sources = [src for src in files if src.suffix == ".cu"]
    lib = BUILD_DIR / "libkernels.so"
    stamp = BUILD_DIR / "libkernels.sha256"
    digest = _digest(files)
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    pid = os.getpid()  # concurrent builds write their own objects
    objs = [BUILD_DIR / f"{src.parent.parent.name}_{src.stem}.{pid}.o"
            for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o",
                               str(obj)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    log = [proc.communicate()[0] for proc in procs]  # wait for every one
    for src, proc, out in zip(sources, procs, log):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{out}")
    tmp = lib.with_suffix(f".so.{pid}")
    link = subprocess.run([nvcc, "-shared", *map(str, objs), "-o", str(tmp)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib)
    stamp.write_text(digest)
    for obj in objs:
        obj.unlink()
    return lib, "".join(log)


@functools.cache
def load_kernels() -> ctypes.CDLL:
    """The built kernel library, loaded once per process."""
    lib, _ = build_kernels()
    dll = ctypes.CDLL(str(lib))
    dll.repro_cuda_error_string.argtypes = [ctypes.c_int]
    dll.repro_cuda_error_string.restype = ctypes.c_char_p
    return dll


NULL_KERNEL = "repro_null_kernel"  # the profiler's name for it, in part


def launch_null(device) -> None:
    """Launch the library's empty kernel (shared/csrc/null.cu) on
    `device`'s current stream: its device time is the launch floor."""
    dll = load_kernels()
    with on_device(device):
        code = dll.repro_null_launch(ctypes.c_void_p(launch_stream(device)))
    check_launch(dll, code, "repro_null_launch")


def check_launch(dll, code: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        msg = dll.repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {code} ({msg})")


def check_tb(name, T, B, mats, vecs):
    """Raise unless every (T, B) matrix in `mats` and (B,) vector in
    `vecs` is float32 on one device, with 1 <= T, B < 2^31."""
    dev = mats[0].get_device()  # an int: cheaper than comparing devices
    f32 = torch.float32
    for t in mats:
        if t.dtype != f32 or t.get_device() != dev or t.shape != (T, B):
            _tb_error(name, T, B, mats, vecs)
    for t in vecs:
        if t.dtype != f32 or t.get_device() != dev or t.shape != (B,):
            _tb_error(name, T, B, mats, vecs)
    if not (1 <= T < 2 ** 31 and 1 <= B < 2 ** 31):
        raise ValueError(f"{name}: T={T}, B={B} outside [1, 2^31)")


def _tb_error(name, T, B, mats, vecs):
    """check_tb's message for what it found wrong."""
    dev = mats[0].device
    for t in (*mats, *vecs):
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: inputs on different devices")
    raise ValueError(f"{name}: expected (T, B) = {(T, B)} matrices and "
                     f"({B},) vectors, got "
                     f"{[tuple(t.shape) for t in (*mats, *vecs)]}")
