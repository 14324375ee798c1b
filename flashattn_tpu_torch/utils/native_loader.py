"""ctypes bridge to the native C++ prompt-lookup proposer (native/ngram.cc)
(counterpart of the n-gram part of flashattn_tpu/utils/native_loader.py).

The prebuilt ``native/libngram.so`` is loaded read-only; nothing here
writes under ``native/``.  Where that library does not load (another
host's toolchain or C library), ``native/ngram.cc`` is compiled with the
host's C++ compiler into the git-ignored ``flashattn_tpu_torch/_build/``
at first use.  Failure to load or build raises :class:`OSError`, and the
engine then falls back to the Python proposer, whose answers are the same.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_PREBUILT = _NATIVE_DIR / "libngram.so"
_SOURCE = _NATIVE_DIR / "ngram.cc"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"


def _build_from_source() -> Path:
    """Compile ``native/ngram.cc`` into ``_build/``, keyed by the source's
    hash, and return the library's path."""
    try:
        digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:16]
    except OSError as e:
        raise OSError(f"cannot read {_SOURCE}: {e}") from e
    out = _BUILD_DIR / f"libngram-{digest}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), "-O2", "-std=c++17", "-shared",
           "-fPIC", str(_SOURCE), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        raise OSError(f"cannot build {_SOURCE}: {e}") from e
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def _ngram_lib() -> ctypes.CDLL:
    try:
        lib = ctypes.CDLL(str(_PREBUILT))
    except OSError:
        lib = ctypes.CDLL(str(_build_from_source()))
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.ngram_propose.restype = ctypes.c_int32
    lib.ngram_propose.argtypes = [i32p, ctypes.c_int64, ctypes.c_int32,
                                  ctypes.c_int32, i32p]
    return lib


def ngram_propose_native(ctx, k: int, max_ngram: int = 3):
    """C++ rightmost trailing-n-gram proposal, the same answers as
    :func:`flashattn_tpu_torch.serving.engine._ngram_propose`.  ``ctx`` is
    a list or int32 array of token ids."""
    lib = _ngram_lib()
    arr = np.ascontiguousarray(ctx, np.int32)
    out = np.empty((max(k, 1),), np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    n = lib.ngram_propose(arr.ctypes.data_as(i32p), len(arr), k, max_ngram,
                          out.ctypes.data_as(i32p))
    return out[:n].tolist()
