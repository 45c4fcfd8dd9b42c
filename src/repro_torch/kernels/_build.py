"""Builds the port's CUDA kernels and loads them through ``ctypes``.

Every ``kernels/<name>/csrc/<name>.cu`` is compiled by ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface,
``build/repro_torch_kernels/lib<name>-<hash>.so`` at the root of the
checkout.  The hash covers the sources and the flags, so an edited
kernel is rebuilt and an unchanged one is reused.  Builds start at
first use, one ``nvcc`` per source, all running together.  A failed
build raises with nvcc's error output; nothing falls back.  A source
may include headers of its own (``csrc/*.cuh``); they are part of the
hash.  The flags need no ``-lcuda``: the one driver-API call, TMA's
``cuTensorMapEncodeTiled`` in ``flash_attention``, is looked up through
the runtime's ``cudaGetDriverEntryPoint``.

Threads may reach a kernel's first launch together (the streaming
executor's pool does): :func:`load` builds and loads each library once
per process under a lock, and each build writes its library and its
log to temporary files named for its process and thread, each committed
by ``os.replace``, so no two builds share a file and no reader sees a
torn one.  The wrappers'
launch counters are bumped under a lock too (:func:`count_launches`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["sources", "library_path", "build_all", "load", "build_log",
           "count_launches"]

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def sources() -> Dict[str, Path]:
    """Kernel name -> its ``.cu`` source."""
    return {p.stem: p for p in sorted(KERNELS_DIR.glob("*/csrc/*.cu"))}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = Path(home) / "bin" / "nvcc"
        if candidate.exists():
            nvcc = str(candidate)
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): the CUDA kernels of "
                           "repro_torch cannot be built")
    return nvcc


def library_path(name: str) -> Path:
    src = sources()[name]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for dep in sorted(src.parent.glob("*.cu*")):
        h.update(dep.name.encode())
        h.update(dep.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """nvcc's output (ptxas resource usage) of the library's build."""
    return library_path(name).with_suffix(".log").read_text()


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Builds the named kernels (all by default) that are not built yet,
    one ``nvcc`` process per source, started together.  Returns
    name -> library path."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    out = {n: library_path(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    try:
        for n in todo:
            tmp = out[n].with_name(f"{out[n].name}.{os.getpid()}."
                                   f"{threading.get_ident()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(srcs[n])]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT,
                                         text=True), tmp)
        for n, (proc, tmp) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed to build {srcs[n]} "
                                   f"(exit {proc.returncode}):\n{log}")
            tmp_log = tmp.with_suffix(".log")
            tmp_log.write_text(log)
            os.replace(tmp_log, out[n].with_suffix(".log"))
            os.replace(tmp, out[n])
    finally:
        for proc, tmp in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
            tmp.with_suffix(".log").unlink(missing_ok=True)
    return out


_LOADED: Dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed: once per
    process, however many threads ask at once."""
    lib = _LOADED.get(name)
    if lib is None:
        with _LOAD_LOCK:
            lib = _LOADED.get(name)
            if lib is None:
                path = build_all([name])[name]
                lib = _LOADED[name] = ctypes.CDLL(str(path))
    return lib


_COUNT_LOCK = threading.Lock()


def count_launches(wrapper, n: int) -> None:
    """``wrapper.launches += n``, atomic across threads."""
    with _COUNT_LOCK:
        wrapper.launches += n
