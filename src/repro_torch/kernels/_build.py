"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles, on its
own, into ``build/<name>-<hash>.so`` at the repository root:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -lineinfo -Xptxas -v \
         -o build/<name>-<hash>.so src/repro_torch/csrc/<name>.cu

``<hash>`` covers the source text and the flags, so an edited source
rebuilds and an unchanged one loads the library already built. Each source
stands alone (there are no shared headers to hash). What ``ptxas`` reports
for each kernel (registers, shared memory, spills) is kept beside the
library and read back by :func:`ptxas_report`. Building
happens at first use (never at import), one ``nvcc`` process per source,
all started together by :func:`build_all`. A missing ``nvcc`` or a failed
compile raises with the compiler's stderr; nothing falls back.

Every C entry point returns ``cudaGetLastError()`` after its launches;
:func:`check` turns a non-zero code into an exception, so a refused launch
(too many threads, too much shared memory) never passes silently.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC", "-lineinfo", "-Xptxas", "-v")
# where the CUDA toolkit installs nvcc when it is not on PATH
_DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The ``nvcc`` to compile with; raises if the toolkit is missing."""
    found = shutil.which("nvcc")
    if found:
        return found
    if _DEFAULT_NVCC.exists():
        return str(_DEFAULT_NVCC)
    raise RuntimeError(
        "nvcc not found on PATH or at /usr/local/cuda/bin/nvcc: the "
        "repro_torch CUDA kernels cannot be built, and a CUDA tensor has "
        "no other route")


def sources() -> list[str]:
    """Names of every kernel source under ``csrc/`` (without ``.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _target(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, nvcc: str):
    out = _target(name)
    if out.exists():
        return out, None, None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return out, tmp, proc


def build_all(names: list[str] | None = None) -> dict[str, ctypes.CDLL]:
    """Compile (in parallel) and load the named sources (default: all).

    Returns ``{name: CDLL}``; already-loaded libraries are reused.
    """
    names = sources() if names is None else list(names)
    with _LOCK:
        todo = [n for n in names if n not in _LIBS]
        if todo:
            nvcc = nvcc_path()
            started = {n: _start(n, nvcc) for n in todo}
            errors = []
            for n, (out, tmp, proc) in started.items():
                if proc is None:
                    continue
                _, err = proc.communicate()
                if proc.returncode != 0:
                    errors.append(f"nvcc failed for csrc/{n}.cu "
                                  f"(exit {proc.returncode}):\n{err}")
                    tmp.unlink(missing_ok=True)
                else:
                    out.with_suffix(".ptxas.txt").write_text(err)
                    os.replace(tmp, out)
            if errors:
                raise RuntimeError("\n".join(errors))
            for n, (out, _, _) in started.items():
                _LIBS[n] = ctypes.CDLL(str(out))
        return {n: _LIBS[n] for n in names}


def ptxas_report(name: str) -> str:
    """What ``ptxas -v`` printed when ``csrc/<name>.cu`` was built."""
    report = _target(name).with_suffix(".ptxas.txt")
    return report.read_text() if report.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = build_all([name])[name]
    return lib


def entry(name: str, symbol: str, argtypes: list):
    """C entry point ``symbol`` of ``csrc/<name>.cu`` with its signature
    declared (pointers and the stream as ``c_void_p``, so ctypes never
    truncates them to 32-bit ints); returns an int CUDA error code."""
    fn = getattr(library(name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(code: int, name: str) -> None:
    """Raise if ``csrc/<name>.cu``'s entry point returned a CUDA error."""
    if code != 0:
        describe = getattr(library(name), f"{name}_error_string")
        describe.argtypes = [ctypes.c_int]
        describe.restype = ctypes.c_char_p
        raise RuntimeError(
            f"{name}: CUDA error {code} ({describe(code).decode()}) at launch")
