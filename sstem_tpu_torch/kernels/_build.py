"""Build and load the port's CUDA kernels.

``csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, ``build/sstem_tpu_torch/libsstem_kernels.so``
at the root of the checkout, and loaded with ctypes. The build happens at the
first call that needs a kernel and is cached by a hash of the sources and the
flags; importing this module needs neither ``nvcc`` nor a GPU.

Every C entry point returns ``cudaGetLastError()`` after its launch, as an
int; the wrappers raise when it is not 0.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCES = sorted((_PKG / "csrc").glob("*.cu"))
BUILD_DIR = _PKG.parent / "build" / "sstem_tpu_torch"
LIBRARY = BUILD_DIR / "libsstem_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argtypes (pointers and the stream as void*)
_ENTRY_POINTS = {
    # image, vertical, horizontal, out, n, c, h, w, k,
    # image_bf16, maps_bf16, stream
    "sstem_sepconv_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # im, flow, out, n, h, w, stream
    "sstem_warp_bilinear": [_P, _P, _P, _I, _I, _I, _P],
}

_lib = None


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    return default if os.path.exists(default) else None


def _digest():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def build():
    """Compile ``csrc/*.cu`` unless the cached library matches the sources.

    Returns (path of the library, compiler output or '' when cached).
    """
    stamp = BUILD_DIR / "libsstem_kernels.sha256"
    digest = _digest()
    if LIBRARY.exists() and stamp.exists() and stamp.read_text() == digest:
        return LIBRARY, ""
    nvcc = _nvcc()
    if nvcc is None:
        raise RuntimeError(
            "the sstem_tpu_torch CUDA kernels are built with nvcc, and no "
            "nvcc was found on PATH or at /usr/local/cuda/bin/nvcc; CUDA "
            "tensors cannot be processed on this host")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, LIBRARY)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    stamp.write_text(digest)
    return LIBRARY, proc.stdout + proc.stderr


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _ENTRY_POINTS.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.sstem_error_string.argtypes = [ctypes.c_int]
        lib.sstem_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(rc: int, name: str):
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = library().sstem_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg}) at launch")
