"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, compiled for ``sm_90a`` (Hopper):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

It is built at first use into ``sgl_tpu_torch/_build/``, from the package's
own sources only, under a name that carries a hash of the source and the
flags, so an edited source is rebuilt and a stale library is never loaded.
Nothing here runs at import: the CPU tests import every module on a machine
with no ``nvcc``.  A failed build raises; there is no fallback.

Every entry point returns ``cudaGetLastError()`` as an ``int`` and takes
the CUDA stream last; each library also exports ``sgl_cuda_error_string``.
:func:`load_entries` sets the ``ctypes`` signatures and :func:`call`
launches on PyTorch's current stream and raises on a refused launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Iterable, List, Mapping, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]
# every kernel source of the package; chip_smoke.py builds them all at once
SOURCES = ("spmm_csr", "segment_reduce", "gather_sum")


def nvcc_path() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME, /usr/local/cuda and $PATH); "
            "the port's CUDA kernels are built from source at first use"
        )
    return found


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` for one source; returns ``(process, tmp, out)`` or
    None when the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a private name and rename: concurrent builders never load
    # a half-written library
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build(names: Iterable[str] = SOURCES) -> List[Path]:
    """Build the named kernel libraries, one ``nvcc`` per source, all
    started together; returns their paths."""
    names = list(names)
    started = [(n, _start(n)) for n in names]
    try:
        for n, s in started:
            _finish(n, s)
    finally:
        for _, s in started:  # leave no compiler running behind a failure
            if s is not None and s[0].poll() is None:
                s[0].kill()
                s[0].wait()
    return [library_path(n) for n in names]


def load(name: str) -> ctypes.CDLL:
    """Load the library for ``csrc/<name>.cu``, building it first if needed."""
    (path,) = build([name])
    return ctypes.CDLL(str(path))


def load_entries(name: str, entries: Mapping[str, Sequence]) -> ctypes.CDLL:
    """:func:`load` with the argument types of each named entry point set
    (the stream, last, included) and every entry returning an ``int``."""
    lib = load(name)
    for fn, argtypes in entries.items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    lib.sgl_cuda_error_string.argtypes = [ctypes.c_int]
    lib.sgl_cuda_error_string.restype = ctypes.c_char_p
    return lib


def call(lib: ctypes.CDLL, fn: str, device, *args) -> None:
    """Call entry point ``fn`` of ``lib`` with ``args`` and ``device``'s
    current stream; raise if the launch was refused."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn)(*args, stream)
    if err != 0:
        msg = lib.sgl_cuda_error_string(err).decode()
        raise RuntimeError(f"{fn} kernel launch failed: {msg} (cudaError {err})")
