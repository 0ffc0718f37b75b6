"""Shared builder for the native components (csrc/*.cpp, csrc/*.cu).

Artifacts are built into ``.cache/native`` inside the checkout (listed in
.gitignore; ``NADAVCA_TPU_CACHE`` overrides the directory), keyed by a
content hash of the source and the build flags, so the repo never carries
compiled binaries and a stale .so can never shadow an edited source.
Host flags are portable by default (``-O3``); set
``NADAVCA_TPU_NATIVE_ARCH=native`` to opt into ``-march=native`` for the
host-tuned build (the CPU-baseline benchmarks do this explicitly).
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import List, Sequence

REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", ".."))

# the CUDA kernels use Hopper-only instructions: sm_90a, not sm_90
NVCC_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]


def cache_dir() -> str:
    root = os.environ.get("NADAVCA_TPU_CACHE") or os.path.join(
        REPO_ROOT, ".cache", "native")
    os.makedirs(root, exist_ok=True)
    return root


def _build(src_path: str, name: str, cmd: List[str], key: str) -> str:
    src = os.path.abspath(src_path)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + key.encode()).hexdigest()[:16]
    so = os.path.join(cache_dir(), f"lib{name}-{digest}.so")
    if os.path.exists(so):
        return so
    # build to a temp file then rename: concurrent builders race benignly
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=cache_dir())
    os.close(fd)
    try:
        res = subprocess.run(cmd + ["-o", tmp, src], capture_output=True,
                             text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"building {os.path.basename(src)} failed "
                f"({' '.join(cmd)}):\n{res.stderr[-4000:]}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def build_shared(src_path: str, name: str) -> str:
    """Compile one .cpp into a cached shared library; return its path."""
    arch = os.environ.get("NADAVCA_TPU_NATIVE_ARCH", "")
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC"]
    if arch:
        cmd.append(f"-march={arch}")
    return _build(src_path, name, cmd, " ".join(cmd))


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, PATH, or /usr/local/cuda, in that order."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME)")


def build_cuda_shared(src_path: str, name: str,
                      include_dirs: Sequence[str], key: str = "") -> str:
    """Compile one .cu for sm_90a into a cached shared library; path.

    ``key`` joins the content hash (e.g. the version of the headers)."""
    cmd = [nvcc_path(), *NVCC_ARCH, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC"]
    for d in include_dirs:
        cmd += ["-I", d]
    return _build(src_path, name, cmd, " ".join(cmd) + key)
