"""ctypes bridges to the native C++ host code under ``native/``
(counterpart of flashattn_tpu/utils/native_loader.py): the data loader
(``native/dataloader.cc``: one-time corpus registration, C++ collate, a
background prefetch thread) and the prompt-lookup proposer
(``native/ngram.cc``).

A prebuilt library under ``native/`` is loaded read-only; nothing here
writes under ``native/``.  Where it is missing or does not load (another
host's toolchain or C library), its source is compiled with the host's C++
compiler into the git-ignored ``flashattn_tpu_torch/_build/`` at first use,
keyed by the source's hash.  Failure to load or build raises
:class:`OSError`; the engine then falls back to the Python proposer, whose
answers are the same, and the MT app to its Python collate.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_I32P = ctypes.POINTER(ctypes.c_int32)


def _build_from_source(name: str) -> Path:
    """Compile ``native/<name>.cc`` into ``_build/``, keyed by the source's
    hash, and return the library's path."""
    source = _NATIVE_DIR / f"{name}.cc"
    try:
        digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    except OSError as e:
        raise OSError(f"cannot read {source}: {e}") from e
    out = _BUILD_DIR / f"lib{name}-{digest}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), "-O3", "-std=c++17", "-shared",
           "-fPIC", "-pthread", str(source), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        raise OSError(f"cannot build {source}: {e}") from e
    os.replace(tmp, out)
    return out


def _open(name: str, force: bool = False) -> Tuple[ctypes.CDLL, Path]:
    """(library, its path): the prebuilt ``native/lib<name>.so`` unless it
    is missing, does not load or ``force`` asks for a build from source."""
    prebuilt = _NATIVE_DIR / f"lib{name}.so"
    if not force:
        try:
            return ctypes.CDLL(str(prebuilt)), prebuilt
        except OSError:
            pass
    path = _build_from_source(name)
    return ctypes.CDLL(str(path)), path


@functools.lru_cache(maxsize=None)
def _ngram_lib() -> ctypes.CDLL:
    lib, _ = _open("ngram")
    lib.ngram_propose.restype = ctypes.c_int32
    lib.ngram_propose.argtypes = [_I32P, ctypes.c_int64, ctypes.c_int32,
                                  ctypes.c_int32, _I32P]
    return lib


def build_native(force: bool = False) -> str:
    """The path of the data loader's library: the prebuilt
    ``native/libdataloader.so`` where it loads, else (or with ``force``)
    ``native/dataloader.cc`` built into ``_build/``."""
    return str(_open("dataloader", force)[1])


@functools.lru_cache(maxsize=None)
def _loader_lib() -> ctypes.CDLL:
    lib, _ = _open("dataloader")
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.loader_create.restype = ctypes.c_void_p
    lib.loader_create.argtypes = [_I32P, _I32P, _I32P, ctypes.c_int64,
                                  ctypes.c_int32, ctypes.c_int32,
                                  ctypes.c_int32, ctypes.c_uint64]
    lib.loader_next.restype = None
    lib.loader_next.argtypes = [ctypes.c_void_p, _I32P, _I32P, f32p]
    lib.loader_corpus_size.restype = ctypes.c_int64
    lib.loader_corpus_size.argtypes = [ctypes.c_void_p]
    lib.loader_destroy.restype = None
    lib.loader_destroy.argtypes = [ctypes.c_void_p]
    return lib


class NativeDataLoader:
    """Background-prefetching batch loader over a pre-tokenized corpus of
    (src ids, tgt ids) pairs, reshuffled every epoch from ``seed``.

    ``next_batch()`` gives the batch format of
    ``training.translation.collate_batch`` as numpy arrays: input_ids and
    labels (batch, max_len - 1) int32, label_token_weights (batch,
    max_len - 1) float32 (1 on target tokens)."""

    def __init__(self, examples: Sequence[Tuple[List[int], List[int]]],
                 pad_id: int, max_len: int, batch_size: int, seed: int = 0):
        self._lib = _loader_lib()
        flat, src_lens, tgt_lens = [], [], []
        for src, tgt in examples:
            flat.extend(src)
            flat.extend(tgt)
            src_lens.append(len(src))
            tgt_lens.append(len(tgt))
        flat = np.asarray(flat, np.int32)
        src_lens = np.asarray(src_lens, np.int32)
        tgt_lens = np.asarray(tgt_lens, np.int32)
        self._handle = self._lib.loader_create(
            flat.ctypes.data_as(_I32P), src_lens.ctypes.data_as(_I32P),
            tgt_lens.ctypes.data_as(_I32P), len(examples), pad_id, max_len,
            batch_size, seed)
        self.batch_size = batch_size
        self.width = max_len - 1
        self.n_examples = len(examples)

    def next_batch(self):
        ids = np.empty((self.batch_size, self.width), np.int32)
        labels = np.empty((self.batch_size, self.width), np.int32)
        weights = np.empty((self.batch_size, self.width), np.float32)
        self._lib.loader_next(self._handle, ids.ctypes.data_as(_I32P),
                              labels.ctypes.data_as(_I32P),
                              weights.ctypes.data_as(
                                  ctypes.POINTER(ctypes.c_float)))
        return {"input_ids": ids, "labels": labels,
                "label_token_weights": weights}

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def ngram_propose_native(ctx, k: int, max_ngram: int = 3):
    """C++ rightmost trailing-n-gram proposal, the same answers as
    :func:`flashattn_tpu_torch.serving.engine._ngram_propose`.  ``ctx`` is
    a list or int32 array of token ids."""
    lib = _ngram_lib()
    arr = np.ascontiguousarray(ctx, np.int32)
    out = np.empty((max(k, 1),), np.int32)
    n = lib.ngram_propose(arr.ctypes.data_as(_I32P), len(arr), k, max_ngram,
                          out.ctypes.data_as(_I32P))
    return out[:n].tolist()
