"""Build and load the port's CUDA kernels.

``csrc/*.cu`` (with the shared headers ``csrc/conv_tile.cuh``,
``csrc/hopper.cuh`` and ``csrc/sepconv_tile.cuh``) is compiled
with ``nvcc`` for ``sm_90a``, one ``nvcc`` per source, all started together
(the build takes the slowest source's time, not the sum; the log gives each
source's seconds), and linked into one shared library with a plain C
interface,
``build/sstem_tpu_torch/libsstem_kernels.so`` at the root of the checkout,
which is loaded with ctypes. The build happens at the first call that needs
a kernel and is cached by a hash of the sources and the flags; importing
this module needs neither ``nvcc`` nor a GPU.

Every C entry point takes the CUDA stream as its last argument and returns
``cudaGetLastError()`` after its launch, as an int. The wrappers launch
through ``launch``, which resolves each entry point once, passes the
current stream's raw handle, switches the device only when the tensors'
device is not the current one, and raises when the int is not 0.
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

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCES = sorted((_PKG / "csrc").glob("*.cu"))
HEADERS = sorted((_PKG / "csrc").glob("*.cuh"))
BUILD_DIR = _PKG.parent / "build" / "sstem_tpu_torch"
LIBRARY = BUILD_DIR / "libsstem_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry points: name -> argtypes (pointers and the stream as void*)
_ENTRY_POINTS = {
    # image, vertical, horizontal, out, n, c, h, w, k,
    # image_bf16, maps_bf16, stream (_simple: the first design at any shape)
    "sstem_sepconv_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "sstem_sepconv_fwd_simple": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                 _P],
    # image, vertical, horizontal, grad, dvertical, dhorizontal, n, c, h, w,
    # k, image_bf16, maps_bf16, stream (_simple: the first design at any
    # shape)
    "sstem_sepconv_bwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                          _P],
    "sstem_sepconv_bwd_simple": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _I, _I, _P],
    # im, flow, out, n, h, w, stream
    "sstem_warp_bilinear": [_P, _P, _P, _I, _I, _I, _P],
    # x, w, scale, shift, res, out, n, h, w, cin, cout, act, res_mode, stream
    # (the _mma entry points: the mma.sync design at any shape)
    "sstem_conv3x3_fused": [_P] * 6 + [_I] * 7 + [_P],
    "sstem_conv3x3_fused_mma": [_P] * 6 + [_I] * 7 + [_P],
    "sstem_deconv2x_fused": [_P] * 6 + [_I] * 7 + [_P],
    "sstem_deconv2x_fused_mma": [_P] * 6 + [_I] * 7 + [_P],
    # x, out, n, h, w, c, is_max, stream
    "sstem_pool2x": [_P, _P, _I, _I, _I, _I, _I, _P],
    # x, w, bias, out, n, hi, wi, cx, cin, k, stream (_mma: the mma.sync
    # design at any shape)
    "sstem_head_tail": [_P] * 4 + [_I] * 6 + [_P],
    "sstem_head_tail_mma": [_P] * 4 + [_I] * 6 + [_P],
    # x, out, total bytes, slab bytes, stream
    "sstem_probe_copy": [_P, _P, _L, _L, _P],
    # src, idx, out, rows, cols, axis, stream
    "sstem_probe_gather": [_P, _P, _P, _I, _I, _I, _P],
    # src, shift, out, rows, cols, stream
    "sstem_probe_roll": [_P, _P, _P, _I, _I, _P],
}

_lib = None
_entries = {}  # name -> the library's ctypes function, resolved once
# The launch path reads torch's current device and the current stream's raw
# handle through two private calls of torch._C that build no Python object
# (torch._C._cuda_getCurrentRawStream is the one Triton's launcher takes;
# torch.cuda.current_stream() builds a torch.cuda.Stream, which enters a
# device context of its own, on every call). They are bound at the first
# launch; tests/test_torch_launch.py fails if torch stops declaring them.
PRIVATE_CALLS = ("_cuda_getDevice", "_cuda_getCurrentRawStream")
_current_device = _current_stream = None


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


def _resolve(name):
    """The C entry point ``name``, resolved once (the first resolution
    builds and loads the library, and binds ``PRIVATE_CALLS``)."""
    global _current_device, _current_stream
    _current_device, _current_stream = (getattr(torch._C, call)
                                        for call in PRIVATE_CALLS)
    fn = _entries[name] = getattr(library(), name)
    return fn


def launch(name, device, *args):
    """Launch the C entry point ``name`` with ``args`` and the current
    stream of the CUDA device with index ``device``, switching to that
    device only when it is not the current one; raise as ``check`` does
    when the entry point reports a CUDA error."""
    fn = _entries.get(name) or _resolve(name)
    if device == _current_device():
        rc = fn(*args, _current_stream(device))
    else:
        with torch.cuda.device(device):
            rc = fn(*args, _current_stream(device))
    if rc:
        check(rc, name)


def check(rc: int, name: str):
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = library().sstem_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg}) at launch")


def require_cuda(name, *tensors):
    """Raise unless every tensor is a contiguous CUDA tensor on one device
    whose data is 16-byte aligned (the kernels load 16 bytes at a time);
    return that device's index."""
    index = tensors[0].get_device()
    for t in tensors:
        if not t.is_cuda or t.get_device() != index:
            devices = {t.device for t in tensors}
            if len(devices) != 1:
                raise ValueError(f"{name}: inputs on different devices "
                                 f"{devices}")
            raise ValueError(f"{name}: unsupported device {tensors[0].device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned")
    return index
