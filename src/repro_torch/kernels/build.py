"""Build and load the CUDA kernels of ``csrc/`` at first use.

``nvcc`` compiles each source into a shared library with a plain C
interface (``-arch sm_90a``), which ``ctypes`` loads; no PyTorch headers are
involved, so a build takes seconds. Libraries go to ``build/repro_torch/``
at the root of the checkout (listed in ``.gitignore``), keyed by a hash of
the source, so an edited kernel is rebuilt and an unchanged one is reused.
A failed build or a missing ``nvcc`` raises: nothing falls back to the
plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC")

_P, _LL, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
# C signature of every launcher in centered_clip.cu (all return an int status)
SIGNATURES = {
    "cc_sq_pass": (_P, _LL, _LL, _LL, _I, _I, _P, _LL, _I, _P, _P),
    "cc_update": (_P, _LL, _LL, _LL, _I, _I, _P, _P, _P, _LL, _I, _P, _P, _P,
                  _F, _P),
    "cc_dot_pass": (_P, _LL, _LL, _LL, _I, _I, _P, _P, _LL, _I, _P, _P, _P),
    "cc_finish_weights": (_P, _I, _I, _I, _P, _F, _P, _P, _P, _P, _P, _P, _F,
                          _P),
    "cc_finish_tables": (_P, _P, _P, _I, _I, _I, _F, _P, _P, _P),
}

_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str = "centered_clip") -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{tag}.so"


def compile_library(name: str = "centered_clip", verbose: bool = False) -> Path:
    """Compile ``csrc/<name>.cu`` unless the hashed library exists."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr, flush=True)
    os.replace(tmp, out)
    return out


def load(name: str = "centered_clip") -> ctypes.CDLL:
    """The loaded library, built first if needed, with argtypes declared."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(compile_library(name)))
        for fn, args in SIGNATURES.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib
