"""Build and bind the port's native libraries at first use: the CUDA
kernels with nvcc, the host C++ (the CDT mesher) with g++; and the checks
every CUDA launch makes of its tensors.

Each CUDA library is compiled from the sources under `fea_tpu_torch/csrc/` into
`fea_tpu_torch/_build/` as a shared library with a plain C interface for
Hopper (`sm_90a`), for ctypes to load. The file name carries a hash of
the sources and flags, so an edited source is rebuilt and a stale library is
never loaded. nvcc's report (registers, shared memory, spills per kernel)
is kept beside the library as `<name>.log`. Host libraries are built the
same way with g++ (`build_host_library`). A build that fails raises: no
caller carries on without its library.

`bind` is the one way the port reaches a library: a module declares its
library with its table of signatures, and the first symbol it reads builds
and opens it. `check_tensors`, `check_device`, `check_contiguous` and
`check_aligned` are the launch checks the kernel wrappers share; each names
the kernel that refuses.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

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


class Library:
    """A native library as `bind` hands it back: `lib`, the library opened
    once with every symbol of its table bound; `check` of a CUDA call's
    error code; and, where it has a load symbol, `loaded`."""

    def __init__(self, name, sources, signatures, host, load_symbol):
        self.name, self.sources, self.host = name, list(sources), host
        self.signatures, self.load_symbol = dict(signatures), load_symbol
        if load_symbol is not None:
            self.signatures[load_symbol] = ([], ctypes.c_int)
        if not host:
            self.signatures["fea_cuda_error_string"] = ([ctypes.c_int], ctypes.c_char_p)

    def build(self) -> Path:
        """Compile the library (at first use); its path."""
        return (build_host_library if self.host else build_library)(self.name, self.sources)

    @functools.cached_property
    def lib(self):
        """The library, built and opened at the first read, once."""
        lib = ctypes.CDLL(str(self.build()))
        for symbol, (argtypes, restype) in self.signatures.items():
            getattr(lib, symbol).argtypes = argtypes
            getattr(lib, symbol).restype = restype
        return lib

    def check(self, err: int, what: str):
        """Raises RuntimeError with the CUDA runtime's text for a non-zero
        `err` of `what` (the kernel, and the call that failed)."""
        if err != 0:
            raise RuntimeError(
                f"{self.name}: {what} failed: " + self.lib.fea_cuda_error_string(err).decode())

    @functools.cache  # once a device; a library lives as long as the process
    def loaded(self, index: int):
        """`lib`, with its kernels loaded into device `index`'s context by
        the load symbol (before a capture: a kernel that loaded lazily at
        its first launch would load while the graph is recorded)."""
        with torch.cuda.device(index):
            self.check(getattr(self.lib, self.load_symbol)(), "loading the kernels")
        return self.lib


_BOUND = {}  # name: Library, one a process


def bind(name: str, sources: list, signatures: dict, *, host: bool = False,
         load_symbol: str = None) -> Library:
    """The library `name` built from csrc/<sources> (with g++ where `host`,
    else nvcc), its symbols bound by `signatures` ({symbol: (argtypes,
    restype)}); a CUDA library's `fea_cuda_error_string` and its load
    symbol (no arguments, an error code) are bound too. Nothing is built
    until `lib` is first read. A name is bound once a process: binding it
    again gives the same object."""
    if name not in _BOUND:
        _BOUND[name] = Library(name, sources, signatures, host, load_symbol)
    return _BOUND[name]


# ---- the launch checks ----------------------------------------------------

ALIGN = 16  # bytes: the alignment of every vector the kernels load 16 bytes at a time


def check_tensors(kernel: str, device, dtype, dtypes, named):
    """Raises unless `device` is a CUDA device, `dtype` one of `dtypes`, and
    every tensor of `named` ({name: (tensor, dtype or None for `dtype`,
    shape)}; a None tensor is skipped) lies on `device`, contiguous, of its
    dtype and shape."""
    if device.type != "cuda":
        raise ValueError(f"{kernel} takes CUDA tensors; got {device}")
    if dtype not in dtypes:
        names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
        raise TypeError(f"{kernel} takes {names}; got {dtype}")
    for name, (t, dt, shape) in named.items():
        if t is None:
            continue
        want = dtype if dt is None else dt
        if t.device != device or t.dtype != want or tuple(t.shape) != tuple(shape) \
                or not t.is_contiguous():
            raise ValueError(
                f"{name}: {kernel} takes a contiguous {want} {tuple(shape)} on {device}; got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
                + ("" if t.is_contiguous() else " (not contiguous)"))


def check_device(kernel: str, named):
    """Raises ValueError unless every tensor of `named` ({name: tensor})
    lies on one CUDA device."""
    devices = [t.device for t in named.values()]
    if len(set(devices)) != 1 or devices[0].type != "cuda":
        raise ValueError(f"{kernel} takes {', '.join(named)} on one CUDA device or all on the "
                         f"CPU; got {', '.join(map(str, devices))}")


def check_contiguous(kernel: str, named):
    """Raises ValueError unless every tensor of `named` ({name: tensor}) is
    contiguous (the kernels copy nothing)."""
    for name, t in named.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {kernel} takes a contiguous tensor; got strides "
                             f"{t.stride()} for shape {tuple(t.shape)}")


def check_aligned(kernel: str, named):
    """Raises ValueError unless every tensor of `named` ({name: tensor or
    None}) starts on an ALIGN-byte boundary (the kernel's vector loads)."""
    for name, t in named.items():
        if t is not None and t.data_ptr() % ALIGN:
            raise ValueError(f"{name}: {kernel} takes tensors that start on a {ALIGN}-byte "
                             f"boundary; got an offset of {t.data_ptr() % ALIGN} bytes")
