"""Build the port's hand-written CUDA kernels and load them with ctypes.

Each ``csrc/*.cu`` file compiles in its own ``nvcc`` process, all started
together, and one more call links the objects into one shared library with
a plain C interface (no PyTorch headers, so the build takes seconds).  The
library is built at first use into ``_build/`` beside the package, named by
a hash of the sources and flags, so an edited kernel is rebuilt and an
unchanged one is loaded as it is.  The build works in a temporary directory
and renames the library into place, so a build that is cut off never leaves
a library that looks finished.  nvcc's output (``-Xptxas -v``: registers,
shared memory and spills per kernel) is kept beside the library as
``<name>.log``.

Each C entry point returns ``cudaGetLastError()`` of its launch; the
wrappers in ``ops/`` raise when it is not 0.
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
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_U = ctypes.c_uint
_SIGNATURES = {
    # q, k, v, bias, out, B, Tq, Tk, H, D, bias_per_batch, scale, dtype,
    # device, stream
    "sbl_small_mha_flat": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _F, _I, _I, _P],
    # q, k, v, bias, out, B, H, Tq, Tk, D, bias_batch, bias_head, scale,
    # dtype, device, stream
    "sbl_fused_mha": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _LL, _LL, _F, _I,
                      _I, _P],
    # in, out, B, T, plane_bytes, kt, device, stream
    "sbl_stack_frames": [_P, _P, _LL, _I, _LL, _I, _I, _P],
    # q, k, v, bias, out, B, Tq, Tk, H, D, bias_per_batch, scale, seed (the
    # address of the launch's int64 seed on the card),
    # thresh, inv_keep, dropout_on, row0, rows, row_stride, h0, dtype,
    # device, stream
    "sbl_small_mha_dropout_fwd_flat": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                       _I, _F, _P, _U, _F, _I, _I, _I, _I,
                                       _I, _I, _I, _P],
    # q, k, v, bias, dout, dq, dk, dv, B, Tq, Tk, H, D, bias_per_batch,
    # scale, seed, thresh, inv_keep, dropout_on, row0, rows, row_stride,
    # h0, dtype, device, stream
    "sbl_small_mha_dropout_bwd_flat": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                       _I, _I, _I, _I, _F, _P, _U, _F, _I,
                                       _I, _I, _I, _I, _I, _I, _P],
    # out, B, H, Tq, Tk, seed, thresh, row0, rows, row_stride, h0, device,
    # stream
    "sbl_dropout_keep_mask_flat": [_P, _I, _I, _I, _I, _P, _U, _I, _I, _I,
                                   _I, _I, _P],
    # clips, offsets, flip, frame_map, n_frames, out, B, T, H, W, crop,
    # inv_std, shift, dtype, device, stream
    "sbl_ingest_train": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F,
                         _I, _I, _P],
    # x, part, arrivals, out, N, C, HW, cg, chunks, vec, dtype, device,
    # stream
    "sbl_channel_sums": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # dy, x, mean, inv, part, arrivals, out, N, C, HW, cg, chunks, vec,
    # dtype, device, stream
    "sbl_channel_sums_pair": [_P] * 7 + [_I] * 8 + [_P],
    # clips, out, B, T, H, W, crop, c0, kt, inv_std, shift, dtype, device,
    # stream
    "sbl_stack_frames_u8": [_P, _P, _LL, _I, _I, _I, _I, _I, _I, _F, _F, _I, _I,
                            _P],
    # q, k_new, v_new, k_cache, v_cache, out, N, L, H, D, step, scale, dtype,
    # device, stream
    "sbl_cached_attention_step": [_P] * 6 + [_I] * 5 + [_F, _I, _I, _P],
    # x, w1, w2, aff, out, N, C, S, Bt, BH, dtype, device, stream
    "sbl_fused_resblock": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, wq, wk, wv, fc, wq2, fc2, w1, w2, vecs, b1, ck, cv, bias, out, dirs,
    # B, L, D, H, dk, DI, Tk, Bt, cs, scale, dtype, device, stream
    "sbl_fused_decoder_layer": [_P] * 15 + [_I] * 10 + [_F, _I, _I, _P],
}
# sizing helpers: plain ints in, bytes (or blocks) out
_SIZERS = {
    # C, S, Bt, BH, elem
    "sbl_resblock_smem_bytes": [_I] * 5,
    # C, S, Bt, BH
    "sbl_resblock_mma_smem_bytes": [_I] * 4,
    # Bt, L, D, dk, Tk, elem
    "sbl_decoder_layer_smem_bytes": [_I] * 6,
    # Bt, L, D, H, dk, Tk, cs
    "sbl_decoder_layer_mma_smem_bytes": [_I] * 7,
    # pair, vec, dtype, device: K7/K8 blocks one SM holds
    "sbl_channel_sums_blocks_per_sm": [_I] * 4,
}
# dynamic shared memory a block may ask for on sm_90 (227 KB)
MAX_SMEM_BYTES = 232448


def find_nvcc() -> Optional[str]:
    """nvcc on PATH, else the CUDA toolkit's default location, else None."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    return str(default) if default.exists() else None


def sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsbl_kernels_{h.hexdigest()[:16]}.so"


def _compile(target: Path) -> None:
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "build only on a machine with the CUDA toolkit")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        cus = [src for src in sources() if src.suffix == ".cu"]
        objs = [str(Path(tmp) / (src.stem + ".o")) for src in cus]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
                 for src, obj in zip(cus, objs)]
        logs, failed = [], []
        for src, proc in zip(cus, procs):
            out = proc.communicate()[0]
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}) on {src.name}:\n{out}")
        if failed:
            raise RuntimeError("\n".join(failed))
        lib = str(Path(tmp) / target.name)
        res = subprocess.run([nvcc, "-shared", "-o", lib, *objs],
                             capture_output=True, text=True, check=False)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")
        target.with_suffix(".log").write_text("".join(logs))
        os.replace(lib, target)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    target = library_path()
    if not target.exists():
        _compile(target)
    lib = ctypes.CDLL(str(target))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    for name, argtypes in _SIZERS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_longlong
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
