"""Build the port's CUDA kernels with ``nvcc`` at first use and load them with ctypes.

Each ``csrc/*.cu`` file has a plain C entry point and is compiled on its own into a
shared library under ``build/torch_kernels/`` at the root of the checkout (listed in
``.gitignore``); the ``csrc/*.cuh`` headers they include are found beside them. The
library's name carries a hash of the source, the headers and the flags, so an edited
source or header builds anew and an unchanged one is reused within a checkout. Nothing
is built or loaded when a module is imported: the CPU tests import every module.
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


def build_library(name: str) -> Tuple[Path, Optional[str]]:
    """Compile csrc/<name>.cu unless its library exists. Returns (library path,
    compiler output, or None when the library was already built)."""
    out = library_path(name)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build beside the target and rename: a concurrent reader never sees half a file
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(nvcc_command(find_nvcc(), name, Path(tmp)),
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, proc.stdout + proc.stderr


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Build csrc/<name>.cu if needed, then load it (once per process)."""
    return ctypes.CDLL(str(build_library(name)[0]))
