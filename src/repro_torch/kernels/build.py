"""Build the CUDA sources under ``kernels/csrc/`` at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, which the kernel's module loads with
``ctypes``: no PyTorch headers, so a build takes seconds, not minutes. The
library lands in ``repro_torch/_build/`` (listed in ``.gitignore``) under a
name that carries a hash of the source, so an edited source rebuilds.
``build_all()`` starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]


def sources() -> list[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build_all(names: list[str] | None = None) -> dict[str, str]:
    """Compile every named source that has no library yet, one ``nvcc`` each,
    all started together. Returns ``{name: nvcc's log}`` for what it built
    (``-Xptxas=-v`` puts each kernel's registers and spills in the log)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    todo = [n for n in (names or sources()) if not os.path.exists(_target(n))]
    procs = {}
    for name in todo:
        tmp = f"{_target(name)}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{logs[name]}")
        else:
            # a library cut short by a crash must not be loaded next time
            with open(tmp, "rb") as f:
                os.fsync(f.fileno())
            os.replace(tmp, _target(name))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built first if needed."""
    build_all([name])
    return ctypes.CDLL(_target(name))
