"""Build the CUDA kernels of ``csrc/`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with one
``nvcc`` call into ``build/repro_torch/<name>-<hash>.so`` under the
repository root (the hash covers the source, the shared headers
``csrc/*.cuh`` and the flags, so an edited source is rebuilt).  Nothing
is built or loaded at import: a wrapper calls :func:`load` at its first
CUDA launch, and :func:`build` compiles several sources at once, one
``nvcc`` process each, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_U64, _LL = ctypes.c_ulonglong, ctypes.c_longlong
# source name -> (C entry point, its argument types); every entry point
# returns the cudaError_t of its launch as an int
SIGNATURES = {
    "quant_matmul": ("qmm_launch",
                     [_P] * 5 + [_I] * 5 + [_P, _LL, _P, _LL, _P]),
    "paged_attention": ("paged_decode_launch",
                        [_P] * 7 + [_LL] + [_I] * 9 + [_F, _F, _I, _P]),
    "paged_prefill": ("paged_prefill_launch",
                      [_P] * 5 + [_I] * 11 + [_F, _F, _I, _P]),
    "mps_combine": ("mps_combine_launch", [_P] * 4 + [_I] * 3 + [_U64, _P]),
    "ssd_scan": ("ssd_scan_launch", [_P] * 5 + [_I] * 3 + [_P]),
}

# the sources' other C functions -- further entry points (returning a
# cudaError_t as above) and queries that launch nothing:
# source name -> {symbol: (argument types, return type)}
SYMBOLS = {
    "quant_matmul": {"qmm_scratch_ints": ([_I], _LL)},
    "paged_attention": {"paged_decode_dims": ([_P], _I),
                        "paged_decode_split_tokens": ([_I, _I], _I)},
    "paged_prefill": {"paged_prefill_bf16_dims": ([_P], _I)},
    "mps_combine": {
        "mps_combine_bwd_launch": ([_P] * 6 + [_I] * 3 + [_U64, _P], _I),
        "mps_combine_given_launch": ([_P] * 4 + [_I] * 3 + [_U64, _P], _I),
        "mps_combine_probe": ([_P] * 4 + [_I] * 3 + [_U64, _P, _P], _I)},
    "ssd_scan": {"ssd_scan_bwd_launch": ([_P] * 8 + [_I] * 3 + [_P], _I),
                 "ssd_scan_bwd_scratch": ([_I] * 3, _LL)},
}

_LOADED: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           "/usr/local/cuda/bin); the CUDA kernels cannot "
                           "be built")
    return path


def library_path(name: str) -> pathlib.Path:
    parts = [(CSRC / f"{name}.cu").read_bytes()]
    parts += [h.read_bytes() for h in sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(
        b"".join(parts) + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names=tuple(SIGNATURES)) -> dict:
    """Compile every named source that has no library yet, all nvcc
    processes at once.  Returns ``{name: nvcc output}`` for the sources
    compiled by this call; raises if any compile failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so)
    failed, reports = [], {}
    for name, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            failed.append(f"--- nvcc failed for {name}.cu ---\n{out}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def _library(name: str) -> ctypes.CDLL:
    lib = _LOADED.get(name)
    if lib is None:
        build((name,))
        lib = _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def _bind(name: str, symbol: str, argtypes, restype):
    key = (name, symbol)
    fn = _LOADED.get(key)
    if fn is None:
        fn = getattr(_library(name), symbol)
        fn.argtypes = argtypes
        fn.restype = restype
        _LOADED[key] = fn
    return fn


def load(name: str):
    """The C entry point of ``csrc/<name>.cu``, built on first use."""
    symbol, argtypes = SIGNATURES[name]
    return _bind(name, symbol, argtypes, ctypes.c_int)


def symbol(name: str, sym: str):
    """Another C function of ``csrc/<name>.cu`` (see :data:`SYMBOLS`),
    built on first use."""
    argtypes, restype = SYMBOLS[name][sym]
    return _bind(name, sym, argtypes, restype)


def check(rc: int, what: str):
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
