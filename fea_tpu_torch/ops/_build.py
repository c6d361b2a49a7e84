"""Build the port's native libraries at first use: the CUDA kernels with
nvcc, the host C++ (the CDT mesher) with g++.

Each CUDA library is compiled from the sources under `fea_tpu_torch/csrc/` into
`fea_tpu_torch/_build/` as a shared library with a plain C interface for
Hopper (`sm_90a`), for ctypes to load. The file name carries a hash of
the sources and flags, so an edited source is rebuilt and a stale library is
never loaded. nvcc's report (registers, shared memory, spills per kernel)
is kept beside the library as `<name>.log`. Host libraries are built the
same way with g++ (`build_host_library`). A build that fails raises: no
caller carries on without its library.
"""

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, PATH or /usr/local/cuda, in that order."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    if shutil.which("nvcc"):
        candidates.append(Path(shutil.which("nvcc")))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for path in candidates:
        if path.is_file():
            return str(path)
    raise RuntimeError(
        "nvcc not found (CUDA_HOME, PATH, /usr/local/cuda): the port's CUDA "
        "kernels are built from source at first use"
    )


# the flags fea_tpu builds its copy of the mesher with: same code, same
# flags, same meshes
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")


def find_gxx() -> str:
    path = shutil.which(os.environ.get("CXX", "g++"))
    if path is None:
        raise RuntimeError(
            "g++ not found (CXX, PATH): the port's host libraries are built "
            "from source at first use"
        )
    return path


def _build(name: str, sources: list, compiler, flags) -> Path:
    """Compile csrc/<sources> into _build/lib<name>-<hash>.so unless a
    library of the same sources and flags is already there."""
    paths = [CSRC_DIR / s for s in sources]
    digest = hashlib.sha256()
    for path in paths:
        digest.update(path.read_bytes())
    digest.update(" ".join(flags).encode())
    stem = f"lib{name}-{digest.hexdigest()[:16]}"
    lib = BUILD_DIR / f"{stem}.so"
    if lib.exists():
        return lib

    BUILD_DIR.mkdir(exist_ok=True)
    tmp = BUILD_DIR / f"{stem}.{os.getpid()}.tmp"
    cmd = [compiler(), *flags, "-o", str(tmp), *map(str, paths)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (BUILD_DIR / f"{stem}.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{Path(cmd[0]).name} failed ({proc.returncode}) building {name}:\n{proc.stderr}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent build never loads a half-written file
    return lib


def build_library(name: str, sources: list) -> Path:
    """A CUDA library for sm_90a, built with nvcc."""
    return _build(name, sources, find_nvcc, NVCC_FLAGS)


def build_host_library(name: str, sources: list) -> Path:
    """A host C++ library, built with g++."""
    return _build(name, sources, find_gxx, GXX_FLAGS)
