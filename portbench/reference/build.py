"""Builds and loads the reference's native code: native/<name>.cpp, built
with g++ into ``_build/lib<name>.so`` beside it when the library is missing
or older than its source.  A build or load that fails raises: the
reference has one implementation of each stage and no fallback."""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_lock = threading.Lock()


@functools.lru_cache(maxsize=None)
def load(name: str, *flags: str) -> ctypes.CDLL:
    src = os.path.join(_HERE, "native", f"{name}.cpp")
    so_path = os.path.join(_HERE, "_build", f"lib{name}.so")
    # the lock guards compile-and-load: two threads racing a first call
    # must not both run g++ against the same path
    with _lock:
        if (not os.path.exists(so_path)
                or os.path.getmtime(so_path) < os.path.getmtime(src)):
            os.makedirs(os.path.dirname(so_path), exist_ok=True)
            # per process: test workers build at once
            tmp = f"{so_path}.{os.getpid()}.tmp"
            subprocess.run(["g++", "-O2", "-march=native", *flags, "-shared",
                            "-fPIC", src, "-o", tmp],
                           check=True, capture_output=True)
            os.replace(tmp, so_path)
        return ctypes.CDLL(so_path)
