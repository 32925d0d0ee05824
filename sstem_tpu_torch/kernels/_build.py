"""Build and load the port's CUDA kernels.

``csrc/*.cu`` (with the shared header ``csrc/conv_tile.cuh``) is compiled
with ``nvcc`` for ``sm_90a``, one ``nvcc`` per source, all started together
(the build takes the slowest source's time, not the sum; the log gives each
source's seconds), and linked into one shared library with a plain C
interface,
``build/sstem_tpu_torch/libsstem_kernels.so`` at the root of the checkout,
which is loaded with ctypes. The build happens at the first call that needs
a kernel and is cached by a hash of the sources and the flags; importing
this module needs neither ``nvcc`` nor a GPU.

Every C entry point returns ``cudaGetLastError()`` after its launch, as an
int; the wrappers raise when it is not 0.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCES = sorted((_PKG / "csrc").glob("*.cu"))
HEADERS = sorted((_PKG / "csrc").glob("*.cuh"))
BUILD_DIR = _PKG.parent / "build" / "sstem_tpu_torch"
LIBRARY = BUILD_DIR / "libsstem_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argtypes (pointers and the stream as void*)
_ENTRY_POINTS = {
    # image, vertical, horizontal, out, n, c, h, w, k,
    # image_bf16, maps_bf16, stream
    "sstem_sepconv_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # image, vertical, horizontal, grad, dvertical, dhorizontal, n, c, h, w,
    # k, image_bf16, maps_bf16, stream
    "sstem_sepconv_bwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                          _P],
    # im, flow, out, n, h, w, stream
    "sstem_warp_bilinear": [_P, _P, _P, _I, _I, _I, _P],
    # x, w, scale, shift, res, out, n, h, w, cin, cout, act, res_mode, stream
    "sstem_conv3x3_fused": [_P] * 6 + [_I] * 7 + [_P],
    "sstem_deconv2x_fused": [_P] * 6 + [_I] * 7 + [_P],
    # x, out, n, h, w, c, is_max, stream
    "sstem_pool2x": [_P, _P, _I, _I, _I, _I, _I, _P],
    # x, w, bias, out, n, hi, wi, cx, cin, k, stream
    "sstem_head_tail": [_P] * 4 + [_I] * 6 + [_P],
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
    for src in SOURCES + HEADERS:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def _compile(nvcc, src, obj):
    """(nvcc's exit code, its output, seconds) for one source."""
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                          capture_output=True, text=True)
    return proc.returncode, proc.stdout + proc.stderr, time.perf_counter() - t0


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
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects = [os.path.join(tmp, src.stem + ".o") for src in SOURCES]
        with ThreadPoolExecutor(len(SOURCES)) as pool:
            results = list(pool.map(_compile, [nvcc] * len(SOURCES), SOURCES,
                                    objects))
        logs = [f"{src.name} ({secs:.3f} s):\n{out}"
                for src, (_, out, secs) in zip(SOURCES, results)]
        failed = [src.name for src, (rc, _, _) in zip(SOURCES, results) if rc]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        lib = os.path.join(tmp, LIBRARY.name)
        link = subprocess.run([nvcc, "-shared", "-o", lib, *objects],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed (exit {link.returncode}):\n{link.stderr}")
        os.replace(lib, LIBRARY)
    stamp.write_text(digest)
    return LIBRARY, "\n".join(logs)


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


def require_cuda(name, *tensors):
    """Raise unless every tensor is a contiguous CUDA tensor on one device
    whose data is 16-byte aligned (the kernels load 16 bytes at a time)."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs on different devices {devices}")
    device = next(iter(devices))
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned")


def stream():
    """The current CUDA stream, as the int the C entry points take."""
    import torch

    return torch.cuda.current_stream().cuda_stream
