"""ctypes bindings for the native host runtime, ``csrc/sbl_native.cc``
(counterpart of the JAX package's ``utils/native.py``, with its API).

The library builds at first use: ``g++`` compiles the port's own copy of
the source into ``_build/`` beside the package, named by a hash of the
source and the flags, in a temporary directory from which it is renamed
into place, so that processes building at once never load a half-written
file and an edited source is rebuilt.  The flags leave out
``-march=native``, so the library runs on any x86-64 host that shares the
build directory.

``available()`` says whether the library built and loaded;
``levenshtein_native`` returns None when it did not.  ``load_clip_batch``
packs .npy clips into a (N, frames, h, w) uint8 batch with ``nthreads``
threads: slots the library could not fill (or every slot, without the
library) are retried in numpy; a path that cannot be read stays zeros, and
float clips in [0, 1] are scaled by 255.  The port's ``utils/metrics.py``
``levenshtein`` stays Python, as JAX's does.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "sbl_native.cc"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")

_lib = None
_error: Optional[str] = None


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libsbl_native_{h.hexdigest()[:16]}.so"


def _compile(target: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the native runtime builds "
                           "only where a C++ compiler is installed")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = Path(tmp) / target.name
        res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(out), str(SOURCE),
                              "-lpthread"], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE.name}:\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(out, target)


def _bind(path: Path):
    lib = ctypes.CDLL(str(path))
    lib.sbl_levenshtein.restype = ctypes.c_int32
    lib.sbl_levenshtein.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
    lib.sbl_load_clip_batch.restype = ctypes.c_int32
    lib.sbl_load_clip_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
    return lib


def _try_load():
    """The library, built first where it is missing; None where it cannot
    be built or loaded (the reason kept in ``_error``, tried once)."""
    global _lib, _error
    if _lib is None and _error is None:
        try:
            target = library_path()
            if not target.exists():
                _compile(target)
            _lib = _bind(target)
        except (RuntimeError, OSError) as e:
            _error = str(e)
    return _lib


def build(verbose: bool = False) -> bool:
    """Build (where needed) and load the library; True when it loaded."""
    global _lib, _error
    _lib, _error = None, None
    ok = _try_load() is not None
    if verbose and not ok:
        print(_error)
    return ok


def available() -> bool:
    return _try_load() is not None


def levenshtein_native(a: Sequence[int], b: Sequence[int]) -> Optional[int]:
    lib = _try_load()
    if lib is None:
        return None
    aa = np.asarray(a, dtype=np.int32)
    bb = np.asarray(b, dtype=np.int32)
    return int(lib.sbl_levenshtein(
        aa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(aa),
        bb.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(bb)))


def load_clip_batch(paths: List[str], frames: int, h: int, w: int,
                    nthreads: int = 4) -> np.ndarray:
    """Load .npy clips into a packed (N, frames, h, w) uint8 batch."""
    lib = _try_load()
    out = np.zeros((len(paths), frames, h, w), dtype=np.uint8)
    if lib is not None:
        arr = (ctypes.c_char_p * len(paths))(
            *[p.encode("utf-8") for p in paths])
        failures = lib.sbl_load_clip_batch(
            arr, len(paths),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            frames, h, w, nthreads)
        if failures == 0:
            return out
        # fall through and retry the failed slots in numpy
    for i, p in enumerate(paths):
        try:
            a = np.load(p)
        except Exception:
            continue
        if a.dtype != np.uint8:
            a = ((a * 255.0) if a.max() <= 1.0 else a)
            a = np.clip(a, 0, 255).astype(np.uint8)
        t = min(len(a), frames)
        if a.shape[1:] == (h, w):
            out[i, :t] = a[:t]
    return out
