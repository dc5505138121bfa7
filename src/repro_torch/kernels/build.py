"""Build the hand-written CUDA kernels and bind them with ``ctypes``.

Every ``csrc/*.cu`` file has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library under ``build/kernels``
at the repository root, at first use. Each library is keyed by a hash of
its source and the compiler flags, so an edited source rebuilds and an
unchanged one is reused. Builds of several sources run in parallel, one
``nvcc`` each. ``nvcc -Xptxas -v`` output (registers, shared memory,
spills per kernel) is kept beside each library as ``<name>-<hash>.log``.

Nothing here runs at import: the CPU tests import every module of the
port on a host with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("flash_attention", "decode_attention")

_P = ctypes.c_void_p
_I = ctypes.c_int
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
# entry symbol and argument types of each library; the extern "C" entry at
# the end of each source documents every argument
ARGTYPES = {
    "flash_attention": ("flash_attention_fwd",
                        [_P, _P, _P, _P, _P, _P, _STRIDES,
                         _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    "decode_attention": ("decode_attention_fwd",
                         [_P, _P, _P, _P, _P, _P, _STRIDES,
                          _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda); "
                       "the CUDA kernels are built on a host with the CUDA "
                       "toolkit")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, Path]:
    """Compile every source in ``names`` whose library is missing, all
    ``nvcc`` processes started together; raise with the compiler's output
    if one fails. Returns name -> library path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    procs = {}
    for n, out in targets.items():
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        out = targets[n]
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {n}.cu (nvcc exit {proc.returncode})\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)       # atomic: a concurrent loader never sees
    if failed:                     # a half-written library
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return targets


def ptxas_log(name: str) -> str:
    """The ``-Xptxas -v`` report of the built library ``name``."""
    return _target(name).with_suffix(".log").read_text()


@functools.lru_cache(maxsize=None)
def library(name: str):
    """The entry point of ``csrc/<name>.cu``, built if needed, with every
    ``argtypes`` set (pointers and the stream as ``c_void_p``)."""
    path = build([name])[name]
    lib = ctypes.CDLL(str(path))
    sym, argtypes = ARGTYPES[name]
    fn = getattr(lib, sym)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by an entry."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
