"""Build the CUDA kernels of ``csrc/`` with ``nvcc`` and bind them with
ctypes.

Every ``csrc/*.cu`` file compiles to an object, all ``nvcc`` processes
started together, and the objects link into one shared library with a
plain C interface.  The library lands in ``_build/`` next to the package
(ignored by git), named by a hash of the sources, the flags and the
compiler, so a changed source never loads a stale build.  The build runs
at the first kernel launch of a process, never at import.

Each C entry point takes raw pointers (``ctypes.c_void_p``), the device
index and PyTorch's current stream, launches asynchronously and returns
the ``cudaError_t`` of the launch; ``check`` raises on anything but 0.
The library is loaded and its functions bound once; after that a launch
takes no lock but the counter's.

The launch counters live here too: a wrapper adds one to its kernel's
count where it launches the kernel, and nowhere else.  The counts are of
kernels launched on the device, in a CUDA graph or not: a capture
launches nothing, so the launches a thread makes while capturing are
recorded apart (``recording``), and each replay of the graph adds them
(``add_launches``).
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v"]
KERNELS = ("zeta_cluster", "zeta_high", "ranked_conv", "minplus_layer",
           "connmask")

_LOCK = threading.Lock()
_LIB = None
_BUILD_LOG = ""
_LAUNCHES = dict.fromkeys(KERNELS, 0)

_VP, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    # in, out, total, bits, sign, dtype, device, stream
    "repro_zeta_cluster": [_VP, _VP, _LL, _I, _I, _I, _I, _VP],
    # in, out, total, lo, hi, sign, dtype, device, stream
    "repro_zeta_high": [_VP, _VP, _LL, _I, _I, _I, _I, _I, _VP],
    # Z, out, rest, nranks, k, dtype, device, stream
    "repro_ranked_conv": [_VP, _VP, _LL, _I, _I, _I, _I, _VP],
    # dp, card, ok, conn, seed_vals, seed_ok, sets, pairs, rows, m, n, k,
    # device, stream
    "repro_minplus_layer": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _LL,
                            _LL, _I, _I, _I, _VP],
    # conn, adj, rows, n, device, stream
    "repro_connmask": [_VP, _VP, _LL, _I, _I, _VP],
}


# csrc/common.cuh
_DTYPE_CODES = {torch.int32: 0, torch.float32: 1, torch.float64: 2}


def dtype_code(t) -> int:
    """The kernels' dtype code of a tensor: int32, float32 or float64
    (float64 the zeta kernels only; the others refuse its code)."""
    code = _DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"the kernels take int32, float32 or float64, not "
                        f"{t.dtype}")
    return code


# ------------------------------------------------------------ counters
_RECORDING = threading.local()


def count_launch(name: str) -> None:
    rec = getattr(_RECORDING, "counts", None)
    if rec is not None:                 # captured into a graph, not run
        rec[name] += 1
        return
    with _LOCK:
        _LAUNCHES[name] += 1


@contextlib.contextmanager
def recording():
    """Collect this thread's launches in the yielded dict instead of
    counting them: a CUDA graph being captured runs none of them, and
    each replay counts them with ``add_launches``."""
    counts = dict.fromkeys(KERNELS, 0)
    prev = getattr(_RECORDING, "counts", None)
    _RECORDING.counts = counts
    try:
        yield counts
    finally:
        _RECORDING.counts = prev


def add_launches(counts: dict) -> None:
    """Count launches made by a replay of a captured graph."""
    with _LOCK:
        for name, k in counts.items():
            _LAUNCHES[name] += k


def launch_counts() -> dict:
    with _LOCK:
        return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    with _LOCK:
        for k in _LAUNCHES:
            _LAUNCHES[k] = 0


# --------------------------------------------------------------- build
def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the
    PATH, else the toolkit's default location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                       "build only where the CUDA toolkit is installed")


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def library_path(compiler: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(CFLAGS + [compiler]).encode())
    return BUILD_DIR / f"librepro_torch_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile and link the kernels unless this exact build exists.
    Returns the library's path; the compiler's output (``-Xptxas -v``:
    registers, shared memory, spills per kernel) is kept in
    ``build_log()``."""
    global _BUILD_LOG
    compiler = nvcc()
    out = library_path(compiler)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [compiler, *CFLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _, p in procs:
            text = p.communicate()[0]
            logs.append(f"== {src.name}\n{text}")
            if p.returncode != 0:
                failed.append(src.name)
        _BUILD_LOG = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{_BUILD_LOG}")
        lib = Path(tmp) / out.name
        link = subprocess.run(
            [compiler, *ARCH, "-shared", "-o", str(lib),
             *[str(o) for _, o, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(lib, out)          # atomic: concurrent builds agree
    return out


def build_log() -> str:
    return _BUILD_LOG


def library() -> ctypes.CDLL:
    """The loaded kernel library (built and bound on first use; later
    calls take no lock)."""
    global _LIB
    lib = _LIB
    if lib is not None:
        return lib
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def current_stream(t) -> int:
    """PyTorch's current stream on ``t``'s card, as a raw pointer (the
    stream-object route costs microseconds per launch)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")
