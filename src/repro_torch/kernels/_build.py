"""Build and load the CUDA kernels of ``kernels/csrc`` at first use.

Each ``.cu`` source becomes its own shared library with a plain C entry
point, compiled by ``nvcc`` for ``sm_90a`` and loaded with ``ctypes``. The
libraries go to ``build/repro_torch/<hash>/`` at the root of the checkout,
keyed by a hash of every source and the flags, so an edit rebuilds and an
unchanged tree reuses its build. All sources compile at once, one ``nvcc``
process each.

Flags: ``-fmad=false`` and no ``--use_fast_math``. The kernels reproduce
the reference's rounding operation by operation, and both a contracted
multiply-add and a fast division or square root would change bits.

Nothing here runs at import: the CPU tests import every module of the port,
and a build only starts when a CUDA tensor first reaches a wrapper.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_U32 = ctypes.c_uint32
_F = ctypes.c_float
SEEDS_BY_VALUE = 64  # messages whose seed words ride in the launch's params


class SeedWords(ctypes.Structure):
    """The batched kernel's by-value seed parameter: words 2b and 2b+1 are
    message b's (csrc/quantize_pack_batch.cu, ``SeedWords``)."""
    _fields_ = [("w", _U32 * (2 * SEEDS_BY_VALUE))]


# C signature of each library's one entry point (the name is the library's)
SIGNATURES = {
    "quantize_pack": ("qsgd_quantize_pack", (_P, _P, _P, _P, _LL, _I, _P)),
    "quantize_pack_threefry": ("qsgd_quantize_pack_threefry",
                               (_P, _LL, _P, _P, _I, _U32, _U32, _LL, _P)),
    "quantize_pack_batch": ("qsgd_quantize_pack_batch",
                            (_P, _LL, _LL, _LL, _LL, _I, SeedWords, _P, _P,
                             _P, _P)),
    "unpack_dequantize": ("qsgd_unpack_dequantize",
                          (_P, _P, _P, _LL, _I, _I, _LL, _P, _I, _P, _P, _LL,
                           _LL, _P)),
    "buffer_aggregate": ("buffer_aggregate", (_P, _P, _P, _P, _I, _LL, _I, _P)),
    "flush_taps": ("flush_taps", (_P, _P, _P, _P, _P, _P, _I, _LL, _P, _P, _P,
                                  _P)),
    "upload_taps": ("upload_taps", (_P, _P, _P, _LL, _LL, _I, _P, _P, _P,
                                    _P)),
    "server_update": ("server_update", (_P, _P, _P, _P, _LL, _I, _F, _F, _I,
                                        _F, _I, _P, _LL, _LL, _P)),
    "round_taps": ("round_taps", (_P, _LL, _P, _I, _P, _P, _P, _P)),
    "silu": ("silu", (_P, _P, _P, _LL, _I, _P)),
    "logsumexp": ("logsumexp", (_I, _P, _P, _LL, _P, _P, _P, _P, _LL, _LL,
                                _P, _P, _P)),
}

_loaded: Dict[str, object] = {}  # library name -> loaded entry point
# loads of each library in this process: the port's only compile events
# (``obs.events.CompileWatch`` reads them)
LOADS: Dict[str, int] = {name: 0 for name in SIGNATURES}


def find_nvcc() -> str:
    """The toolkit's ``nvcc``: on PATH, else under ``CUDA_HOME`` or
    ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all(verbose: bool = False) -> Path:
    """Compile every kernel library that is missing, all in parallel, and
    return the build directory. Raises with nvcc's output on failure."""
    out = _build_dir()
    out.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    jobs = {}
    for name in SIGNATURES:
        lib = out / f"lib{name}.so"
        if lib.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-I", str(CSRC), "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, lib)
    errors = []
    for name, (proc, tmp, lib) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"{name}.cu:\n{log}")
            continue
        if verbose and log:
            print(f"[nvcc {name}.cu]\n{log}", flush=True)
        os.replace(tmp, lib)
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return out


def entry(name: str):
    """The C entry point of kernel library ``name``, built on first use,
    with its argument types set (every pointer and the stream as
    ``c_void_p``, key words as ``c_uint32``, batched seed words as the
    ``SeedWords`` structure, the server update's scalars as ``c_float``)
    and an ``int``
    (``cudaError_t``) result."""
    fn = _loaded.get(name)
    if fn is None:
        out = build_all()
        symbol, argtypes = SIGNATURES[name]
        fn = getattr(ctypes.CDLL(str(out / f"lib{name}.so")), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _loaded[name] = fn
        LOADS[name] += 1
    return fn


def check(name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {err}")
