"""Build the package's CUDA sources with ``nvcc`` and load them with
``ctypes``.

Each ``csrc/<name>.cu`` exports a plain C interface and compiles into
its own shared library for ``sm_90a`` (Hopper; the ``a`` keeps
``wgmma`` and ``setmaxnreg`` available). Libraries go to ``build/``
beside this file, named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source is rebuilt and an
unchanged one is reused. Nothing is
built when the package is imported: a kernel's wrapper builds its
library at first launch, and `build` compiles several sources at once,
one ``nvcc`` each, all started together. ``nvcc`` is taken from
``PATH``, else from where PyTorch finds the CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory, spills -> the build log
)


def source_names() -> list[str]:
    """Every kernel source under ``csrc/``, by stem."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    # PyTorch's own lookup: $CUDA_HOME / $CUDA_PATH, then the toolkit's
    # default install location
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built: named by the
    source, the shared headers (``csrc/*.cuh``) and the flags."""
    headers = b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(
        (CSRC_DIR / f"{name}.cu").read_bytes() + headers
        + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_log(name: str) -> str:
    """The compiler's output from the last build of ``name`` (empty when
    the library was reused)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(names=None) -> dict[str, Path]:
    """Compile each named source (default: all) whose library is
    missing, one ``nvcc`` process each, all running at once. Raises
    with the compiler's output if any of them fails."""
    names = source_names() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    try:
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC_DIR / f"{name}.cu")]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )
            running[name] = (proc, tmp, out)
        failed = []
        for name, (proc, tmp, out) in running.items():
            text, _ = proc.communicate()
            out.with_suffix(".log").write_text(text)
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exit {proc.returncode}\n{text}")
            else:
                os.replace(tmp, out)  # atomic: concurrent builders agree
    finally:
        for proc, _, _ in running.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {name: library_path(name) for name in names}


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it (once a process)."""
    return ctypes.CDLL(str(build([name])[name]))
