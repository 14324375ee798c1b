"""Build and load the package's CUDA kernels (``csrc/*.cu``).

Every ``.cu`` file is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a``; the objects are linked into one shared library
with a plain C interface and loaded with :mod:`ctypes`.  The library lands
in ``flashattn_tpu_torch/_build/<hash>/`` (git-ignored), keyed by a hash of
the sources and flags, so an unchanged tree builds once.  Nothing here runs
at import: the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
LIB_NAME = "libflashattn_tpu_torch.so"

# ctypes argument types: every pointer (and the stream) is a void pointer
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
I64, U64, U32 = ctypes.c_longlong, ctypes.c_ulonglong, ctypes.c_uint


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def _run_all(cmds: Sequence[Sequence[str]]) -> None:
    """Run the commands in parallel; raise with nvcc's stderr on failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    errors = []
    for cmd, proc in zip(cmds, procs):
        out, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"$ {' '.join(cmd)}\n{out}{err}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))


def build() -> Path:
    """Compile ``csrc/*.cu`` into the shared library (if not built yet) and
    return its path."""
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in _sources()]
        _run_all([[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(obj)] for src, obj in zip(_sources(), objs)])
        staged = Path(tmp) / LIB_NAME
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(staged),
                   *map(str, objs)]])
        os.replace(staged, lib_path)   # atomic: concurrent builds agree
    return lib_path


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.fa_error_string.argtypes = [I]
    lib.fa_error_string.restype = ctypes.c_char_p
    return lib


class Kernel:
    """One C entry point of the kernel library, with its launch count.

    ``launches`` is a plain integer incremented once per successful launch
    (and nowhere else), so a run can show which kernels its path used."""

    def __init__(self, symbol: str, argtypes: Sequence):
        self.symbol = symbol
        self.argtypes = [*argtypes, P]   # the stream comes last
        self.launches = 0

    def __call__(self, *args) -> None:
        fn = getattr(library(), self.symbol)
        if fn.argtypes is None:
            fn.argtypes = self.argtypes
            fn.restype = I
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, stream)
        if err != 0:
            msg = library().fa_error_string(err).decode()
            raise RuntimeError(f"{self.symbol} failed: CUDA error {err} ({msg})")
        self.launches += 1


def query(symbol: str, argtypes: Sequence, *args) -> int:
    """Call a host function of the library that launches nothing (a launch
    plan) and return its int result; a negative result is minus a CUDA
    error code, and raises."""
    fn = getattr(library(), symbol)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = I
    res = fn(*args)
    if res < 0:
        msg = library().fa_error_string(-res).decode()
        raise RuntimeError(f"{symbol} failed: CUDA error {-res} ({msg})")
    return res


def dtype_code(t: torch.Tensor) -> int:
    """The C interface's dtype code of an activation: 0 float32, 1 bfloat16."""
    if t.dtype == torch.float32:
        return 0
    if t.dtype == torch.bfloat16:
        return 1
    raise TypeError(f"CUDA kernels take float32 or bfloat16, got {t.dtype}")


PAYLOAD_DTYPES = (torch.int8, torch.float8_e4m3fn)


def payload_code(t: torch.Tensor) -> int:
    """The C interface's code of a quantized payload: 2 int8, 3 float8
    e4m3."""
    if t.dtype == torch.int8:
        return 2
    if t.dtype == torch.float8_e4m3fn:
        return 3
    raise TypeError(f"quantized payloads are int8 or float8_e4m3fn, got "
                    f"{t.dtype}")


def aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous with a 16-byte aligned base, as the kernels' vector loads
    need.  A tensor off the card raises: its pointer would be a host one."""
    if not t.is_cuda:
        raise ValueError(f"kernel arguments must lie on a CUDA device, got "
                         f"one on {t.device}")
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()

