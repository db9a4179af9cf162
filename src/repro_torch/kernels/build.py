"""Build and load the CUDA kernels of ``csrc/`` at first use.

``nvcc`` compiles each source (``centered_clip.cu``: the float32 kernels;
``wire.cu``: their int8/bf16 wire-payload twins; both include
``centered_clip.cuh``) into a shared library with a plain C interface
(``-arch sm_90a``), which ``ctypes`` loads; no PyTorch headers are
involved, so a build takes seconds, and ``compile_all`` runs one ``nvcc``
per source, all at once. Libraries go to ``build/repro_torch/`` at the
root of the checkout (listed in ``.gitignore``), keyed by a hash of the
sources, so an edited kernel is rebuilt and an unchanged one is reused.
A failed build or a missing ``nvcc`` raises: nothing falls back to the
plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC")
HEADERS = ("centered_clip.cuh",)

_P, _LL, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
# the stack arguments of a pass: x, row stride, part, d, n, P; then its
# chunk grid and load width: cs, C, vec
_STACK = (_P, _LL, _LL, _LL, _I, _I)
_GRID = (_LL, _I, _I)
# C signature of every launcher, per library (all return an int status)
SIGNATURES = {
    "centered_clip": {
        "cc_sq_pass": _STACK + _GRID + (_P, _P, _P),
        "cc_update": _STACK + _GRID + (_P,) * 7 + (_F, _P, _P),
        "cc_clip_pass": _STACK + _GRID + (_P,) * 6,
        "cc_dot_pass": _STACK + _GRID + (_P,) * 5,
        "cc_rows_dot_pass": _STACK + _GRID + (_P, _I) + (_P,) * 5,
        "cc_mean_dot_pass": _STACK + _GRID + (_P,) * 6,
        "cc_finish_weights": (_P, _I, _I, _I, _P, _F, _P, _P, _P, _P, _P, _P,
                              _F, _P, _P),
        "cc_finish_tables": (_P, _P, _P, _I, _I, _I, _F, _P, _P, _P),
        "cc_finish_digests": (_P, _P, _I, _I, _I, _P, _P, _P),
        "cc_pass_info": (_I, _I, _I, _P),
    },
    # the same passes with the element type and the (P, n) scales in front
    # of the stack: (dtype, x, scales, row stride, part, d, n, P, ...)
    "wire": {
        "wire_sq_pass": (_I, _P, _P) + _STACK[1:] + _GRID + (_P, _P, _P),
        "wire_update": (_I, _P, _P) + _STACK[1:] + _GRID + (_P,) * 7
        + (_F, _P, _P),
        "wire_clip_pass": (_I, _P, _P) + _STACK[1:] + _GRID + (_P,) * 6,
        "wire_dot_pass": (_I, _P, _P) + _STACK[1:] + _GRID + (_P,) * 5,
        "wire_mean_dot_pass": (_I, _P, _P) + _STACK[1:] + _GRID + (_P,) * 6,
        "wire_pass_info": (_I, _I, _I, _I, _P),
    },
}

_loaded: dict[str, ctypes.CDLL] = {}
# the launch path's peer ranks are threads of one process: the first
# launches of several ranks must not build (into the same temporary file)
# or load a library twice
_LOAD_LOCK = threading.Lock()


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    src = b"".join((CSRC / f).read_bytes()
                   for f in (f"{name}.cu", *HEADERS))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{tag}.so"


def compile_all(names=tuple(SIGNATURES), verbose: bool = False) -> dict:
    """Compile ``csrc/<name>.cu`` for every name whose hashed library does
    not exist yet, one ``nvcc`` per source, all started together. Returns
    {name: library path}; raises if any build fails."""
    outs = {name: library_path(name) for name in names}
    todo = {name: out for name, out in outs.items() if not out.exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = find_nvcc()
        procs = {}
        for name, out in todo.items():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
                   "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc {name}.cu failed ({proc.returncode}):\n"
                              f"{log}")
                continue
            if verbose:
                print(log, flush=True)
            os.replace(tmp, todo[name])
        if failed:
            raise RuntimeError("\n".join(failed))
    return outs


def load(name: str = "centered_clip") -> ctypes.CDLL:
    """The loaded library, built first if needed, with argtypes declared.
    Safe to call from several threads at once: one builds, the others
    wait for it."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _LOAD_LOCK:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(compile_all((name,))[name]))
            for fn, args in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = ctypes.c_int
            _loaded[name] = lib
    return lib
