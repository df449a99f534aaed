"""Build and ctypes binding of the port's hand-written CUDA kernels.

The sources in ``csrc/`` have a plain C interface (no PyTorch headers):
one ``nvcc`` per source, all started together, compiles them in seconds,
and one more links the objects into a shared library.  The build runs at
first use, into ``reseek_tpu_torch/_build/`` (git-ignored), and is reused
while it is newer than every source.  Nothing here runs at import time:
this module imports on machines without ``nvcc``.

Every C entry launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` turns a non-zero code into an error.
The wrappers call them through ``launch``, which makes the tensors'
device current and counts the launch.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import os
import shutil
import subprocess
import threading
import time
import types
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "_build"
SOURCES = ("mu_wavefront.cu", "sw_sweep.cu", "sw_align.cu", "postalign.cu")
LIB_NAME = "libreseek_kernels.so"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)     # host int array
# argument types of each C entry (pointers and the stream as void*)
_SIGNATURES = {
    "mu_wavefront": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "sw_score_sweep": [_P, _P, _P, _P, _P, _I, _IP, _I, _I, _I, _I, _I, _I,
                       _I, _F, _F, _P, _P],
    "sw_align": [_P, _P, _P, _P, _I, _IP, _I, _I, _I, _I, _I, _I, _F, _F, _P,
                 _P, _P, _P, _P, _P],
    "sw_score_profiles": [_P, _P, _P, _P, _P, _I, _IP, _I, _I, _I, _I, _I,
                          _I, _F, _F, _P, _P, _P],
    "walk_traceback": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                       _P],
    "lddt": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
}
# the long-column variants: their short twin's arguments and scratch
# pointers more, before the stream (mu_wavefront_long, the Mu band kernel:
# the boundaries in place of the pass scratch, then the ticket and the
# stats buffer or null, and no lane-bits argument, int32 only; the band
# entries of sw_align.cu: the boundaries in place of the pass scratch, then
# the column words, the work buffer and the stats buffer or null;
# lddt_long: the counts and the work buffer, and blocks in place of the
# cluster size)
_SIGNATURES.update({
    "mu_wavefront_long": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                          _P],
    "sw_align_long": _SIGNATURES["sw_align"][:-1] + [_P, _P, _P, _P],
    "sw_score_profiles_long": _SIGNATURES["sw_score_profiles"][:-1]
    + [_P, _P, _P, _P],
    "lddt_long": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
})

_lock = threading.Lock()


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float   # nvcc wall time; 0.0 when an up-to-date build was reused
    log: str         # nvcc output (-Xptxas -v: registers, smem, spills)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _run(cmds):
    """Run the commands concurrently; (seconds, joined output).  Raises
    with the output of the first that failed."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(c)}\n{out}")
    return time.perf_counter() - t0, "".join(outs)


@functools.lru_cache(maxsize=1)
def build() -> BuildInfo:
    """Compile csrc/*.cu (one nvcc per source, in parallel) and link them
    into one shared library (once per process)."""
    so = BUILD / LIB_NAME
    log_path = BUILD / (LIB_NAME + ".log")
    srcs = [CSRC / s for s in SOURCES]
    with _lock:
        if so.exists() and log_path.exists() and all(
                so.stat().st_mtime >= s.stat().st_mtime for s in srcs):
            return BuildInfo(so, 0.0, log_path.read_text())
        BUILD.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        tag = f"{os.getpid()}.tmp"
        objs = [BUILD / f"{s.stem}.{tag}.o" for s in srcs]
        tmp = BUILD / f"{LIB_NAME}.{tag}"
        try:
            secs, log = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                              for s, o in zip(srcs, objs)])
            link_s, link_log = _run([[nvcc, *ARCH, "-shared", "-o", str(tmp),
                                      *map(str, objs)]])
        finally:
            for o in objs:
                o.unlink(missing_ok=True)
        os.replace(tmp, so)
        log += link_log
        log_path.write_text(log)
    return BuildInfo(so, secs + link_s, log)


@functools.lru_cache(maxsize=1)
def lib() -> ctypes.CDLL:
    """The loaded kernel library with argtypes/restype declared."""
    handle = ctypes.CDLL(str(build().path))
    for name, args in _SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    handle.reseek_error_string.argtypes = [ctypes.c_int]
    handle.reseek_error_string.restype = ctypes.c_char_p
    return handle


def check(err: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if err != 0:
        msg = lib().reseek_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def counted(wrapper):
    """Decorator: give a kernel wrapper its launch counts, ``launches``
    and ``by_device`` ({device: launches}), which ``launch`` raises."""
    wrapper.launches = 0
    wrapper.by_device = collections.Counter()
    return wrapper


def variant(name: str):
    """The launch counts of a kernel variant that a wrapper picks by a
    plain shape test (e.g. sw_align's columns read from device memory past
    its shared-memory limit): the wrapper hands it to ``launch`` in place
    of itself, so the variant's launches are counted apart."""
    return counted(types.SimpleNamespace(__name__=name))


def launch(wrapper, name: str, t: torch.Tensor, *args) -> None:
    """Call C entry ``name`` with ``args`` and the current stream of
    ``t``'s device, with that device made current: an entry launches on,
    and raises its kernel's shared-memory limit for, the current device,
    so a tensor on ``cuda:1`` must not run against ``cuda:0``.  Counts the
    launch on ``wrapper`` (``launches``, and ``by_device`` per device)."""
    with torch.cuda.device(t.device):
        wrapper.launches += 1
        wrapper.by_device[str(t.device)] += 1
        check(getattr(lib(), name)(*args, stream_of(t)), name)
