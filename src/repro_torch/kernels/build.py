"""Build the hand-written CUDA kernels and bind them with ``ctypes``.

Every ``csrc/*.cu`` file has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library under ``build/kernels``
at the repository root, at first use. Each library is keyed by a hash of
its source, the shared ``csrc/*.cuh`` headers and the compiler flags, so
an edited source or header rebuilds and an unchanged one is reused.
Builds of several sources run in parallel, one ``nvcc`` each. ``nvcc
-Xptxas -v`` output (registers, shared memory, spills per kernel) is kept
beside each library as ``<name>-<hash>.log``.

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
import threading
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("flash_attention", "decode_attention", "paged_decode_attention",
           "chunked_prefill_attention", "ssd_chunk", "wkv6", "rmsnorm")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
# entry symbol and argument types of each library; the extern "C" entry at
# the end of each source documents every argument
ARGTYPES = {
    "flash_attention": ("flash_attention_fwd",
                        [_P, _P, _P, _P, _P, _P, _STRIDES,
                         _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    # the same library's entry that also writes each row's logsumexp
    "flash_attention_lse": ("flash_attention_fwd_lse",
                            [_P, _P, _P, _P, _P, _P, _P, _STRIDES,
                             _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    "decode_attention": ("decode_attention_fwd",
                         [_P, _P, _P, _P, _P, _P, _STRIDES,
                          _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    "paged_decode_attention": ("paged_decode_attention_fwd",
                               [_P, _P, _P, _P, _P, _P, _P, _STRIDES]
                               + [_I] * 12 + [_P]),
    "chunked_prefill_attention": ("chunked_prefill_attention_fwd",
                                  [_P, _P, _P, _P, _P, _P, _P, _STRIDES]
                                  + [_I] * 13 + [_P]),
    "ssd_chunk": ("ssd_chunk_fwd", [_P] * 8 + [_STRIDES] + [_I] * 8 + [_P]),
    "wkv6": ("wkv6_fwd", [_P] * 8 + [_STRIDES] + [_I] * 8 + [_P]),
    "rmsnorm": ("rmsnorm_fwd",
                [_I] + [_P] * 6 + [_L] * 4 + [_I, _I, _F] + [_I] * 3 + [_P]),
}


# an entry whose library is another name's source
SOURCE_OF = {"flash_attention_lse": "flash_attention"}


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


def _target(name: str, csrc: Path | None = None) -> Path:
    """The library of ``<csrc>/<name>.cu`` (``csrc`` defaults to this
    package's ``CSRC``), keyed by the source, every ``*.cuh`` header
    beside it (a source may include any of them) and the flags, so
    sources of another tree get libraries of their own in ``BUILD_DIR``."""
    csrc = csrc or CSRC
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str] = SOURCES,
          csrc: Path | None = None) -> Dict[str, Path]:
    """Compile every source in ``names`` (from ``csrc``, by default this
    package's) whose library is missing, all ``nvcc`` processes started
    together; raise with the compiler's output if one fails. Returns
    name -> library path."""
    csrc = csrc or CSRC
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n, csrc) for n in names}
    procs = {}
    for n, out in targets.items():
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(csrc / f"{n}.cu")]
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


def ptxas_log(name: str, csrc: Path | None = None) -> str:
    """The ``-Xptxas -v`` report of the built library ``name``."""
    return _target(name, csrc).with_suffix(".log").read_text()


_LOCK = threading.Lock()


def library(name: str, csrc: Path | None = None):
    """The entry point ``name`` of ``<csrc>/<source>.cu`` (by default
    this package's; the source is ``SOURCE_OF[name]``, else ``name``),
    built if needed, with every ``argtypes`` set (pointers and
    the stream as ``c_void_p``). Safe across threads: the async server
    runs the engine's steps on an executor thread, and a library's first
    use may come from there while another thread asks for it."""
    with _LOCK:
        return _library(name, csrc)


@functools.lru_cache(maxsize=None)
def _library(name: str, csrc: Path | None = None):
    source = SOURCE_OF.get(name, name)
    lib = ctypes.CDLL(str(build([source], csrc)[source]))
    sym, argtypes = ARGTYPES[name]
    fn = getattr(lib, sym)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by an entry."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
