"""Build the port's CUDA kernels with ``nvcc``, and its host libraries with the C++
compiler, at first use; both are loaded with ctypes.

Each ``csrc/*.cu`` file has a plain C entry point and is compiled on its own into a
shared library under ``build/torch_kernels/`` at the root of the checkout (listed in
``.gitignore``); the ``csrc/*.cuh`` headers they include are found beside them. The
host libraries (the wav gather and the P.862 scorer) are built from the repo's
``native/*.cpp`` with ``native/Makefile``'s flags into ``build/torch_native/``, never
into ``native/``. A library's name carries a hash of its sources and flags, so an
edited source or header builds anew and an unchanged one is reused within a checkout.
Nothing is built or loaded when a module is imported: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional, Tuple

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NATIVE_DIR = Path(__file__).resolve().parents[3] / "native"
HOST_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_native"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-shared", "-lpthread"]  # native/Makefile
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def find_nvcc() -> str:
    """nvcc from PATH, else from $CUDA_HOME or /usr/local/cuda; raises if absent."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels of segan_pytorch_tpu_torch need the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where csrc/<name>.cu builds to: the name carries a hash of source, headers and
    flags."""
    src = b"".join(p.read_bytes() for p in
                   [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def nvcc_command(nvcc: str, name: str, out: Path) -> List[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(CSRC_DIR / f"{name}.cu")]


def _compile(out: Path, command, what: str) -> str:
    """Run command(tmp) to build `out` beside it, then rename: a concurrent reader (or
    another process building the same library) never sees half a file. Returns the
    compiler output."""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        proc = subprocess.run(command(Path(tmp)), capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building {what} failed:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return proc.stdout + proc.stderr


def build_library(name: str) -> Tuple[Path, Optional[str]]:
    """Compile csrc/<name>.cu unless its library exists. Returns (library path,
    compiler output, or None when the library was already built)."""
    out = library_path(name)
    if out.exists():
        return out, None
    log = _compile(out, lambda tmp: nvcc_command(find_nvcc(), name, tmp), f"csrc/{name}.cu")
    return out, log


def host_library_path(name: str) -> Path:
    """Where native/<name>.cpp builds to: the name carries a hash of source and flags."""
    digest = hashlib.sha256((NATIVE_DIR / f"{name}.cpp").read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return HOST_BUILD_DIR / f"lib{name}-{digest}.so"


def build_host_library(name: str) -> Path:
    """Compile native/<name>.cpp with $CXX (g++ by default) unless built; raises when
    the compiler fails."""
    out = host_library_path(name)
    if not out.exists():
        cxx = os.environ.get("CXX", "g++")
        _compile(out, lambda tmp: [cxx, *CXX_FLAGS, "-o", str(tmp),
                                   str(NATIVE_DIR / f"{name}.cpp")], f"native/{name}.cpp")
    return out


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Build csrc/<name>.cu if needed, then load it (once per process)."""
    return ctypes.CDLL(str(build_library(name)[0]))
