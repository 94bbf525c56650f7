"""Build and load the hand-written CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``. The
build happens at first use (never at import), one ``nvcc`` per source,
all started together, into ``build/repro_torch_kernels/`` at the root of
the checkout (``REPRO_TORCH_BUILD_DIR`` overrides). A library is named by
the hash of its source and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. A failed build raises.

``LAUNCHES`` counts kernel launches per op. Each wrapper adds one where it
launches its kernel, and nowhere else.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["LAUNCHES", "build_all", "library", "check", "build_dir",
           "sm_count"]

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I = ctypes.c_void_p, ctypes.c_int
#: library -> {C function: (argtypes, restype)}
_SIGNATURES = {
    "spx_matmul": {
        "spx_matmul_splits": ([_I] * 4, _I),
        "spx_matmul_f32": ([_P] * 5 + [_I] * 6 + [_P], _I),
    },
    "paged_decode": {
        "paged_decode_ragged_f32":
            ([_P] * 8 + [_I] * 9 + [ctypes.c_float, _P], _I),
        "paged_decode_ragged_bf16":
            ([_P] * 8 + [_I] * 9 + [ctypes.c_float, _P], _I),
        "paged_decode_ragged_quant_f32":
            ([_P] * 6 + [_I] + [_P] * 5 + [_I] * 9 + [ctypes.c_float, _P],
             _I),
    },
    "flash_attention": {
        "flash_attention_f32":
            ([_P] * 4 + [_I] * 7 + [ctypes.c_float, _P], _I),
    },
}

LAUNCHES: collections.Counter = collections.Counter()

_LIBS: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or under /usr/local/cuda)")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"lib{name}-{digest[:12]}.so"


def build_all() -> float:
    """Build every kernel library that is not built yet, in parallel.
    Returns the seconds spent (0.0 when all were built)."""
    todo = {n: _lib_path(n) for n in _SIGNATURES if not _lib_path(n).exists()}
    if not todo:
        return 0.0
    t0 = time.perf_counter()
    nvcc = _nvcc()
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    errors = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed), with every C
    function's argtypes and restype declared."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, (argtypes, restype) in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        lib.repro_cuda_error_string.argtypes = [_I]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error."""
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of CUDA device ``device_index``."""
    import torch
    return torch.cuda.get_device_properties(device_index).multi_processor_count
