"""Build and load the CUDA kernels of ``kernels/csrc`` — from the sources in
the repository and nothing else.

Each ``csrc/<name>.cu`` is a translation unit with a plain C interface (it
may include the shared ``csrc/*.cuh`` headers). It is compiled at first use
by ``nvcc`` for ``sm_90a`` into its own shared library under the build
directory (git-ignored), and loaded with ``ctypes``. The library's file name
carries a hash of the source, the headers and the flags, so editing either
rebuilds it and nothing stale is ever loaded.
:func:`build_all` starts one ``nvcc`` per source at once, which is what a
program that needs every kernel should call first.

A failed build raises :class:`KernelCompileError` with the compiler's output;
nothing falls back to another implementation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
KERNEL_SOURCES = ("psram_matmul", "stream_mttkrp", "mttkrp", "segment_sum",
                  "flash_attention")

# No --use_fast_math: the kernels' epilogues are held bit-equal to their plain
# PyTorch versions (true division, rintf, no flush-to-zero).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

BUILD_DIR_ENV = "REPRO_TORCH_BUILD_DIR"

_LOADED: dict[str, ctypes.CDLL] = {}


class KernelCompileError(RuntimeError):
    """``nvcc`` is missing or refused a kernel source."""


def build_dir() -> Path:
    """Where the shared libraries go: ``$REPRO_TORCH_BUILD_DIR`` or
    ``build/repro_torch_kernels`` beside ``src/`` of this checkout."""
    env = os.environ.get(BUILD_DIR_ENV)
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelCompileError(
        "nvcc not found (looked at $CUDA_HOME, $CUDA_PATH, PATH and "
        "/usr/local/cuda): the CUDA kernels cannot be built here"
    )


def _source(name: str) -> Path:
    if name not in KERNEL_SOURCES:
        raise KeyError(f"unknown kernel source {name!r}; have {KERNEL_SOURCES}")
    return CSRC / f"{name}.cu"


def library_path(name: str) -> Path:
    """The hash-named shared library ``name`` builds into: the hash covers
    the source, the shared headers (``csrc/*.cuh``) and the flags."""
    h = hashlib.sha256()
    h.update(_source(name).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Start ``nvcc`` for ``name`` unless its library exists; returns
    ``(process | None, temporary path, final path)``."""
    out = library_path(name)
    if out.exists():
        return None, None, out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_source(name))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, proc, tmp: Path, out: Path) -> Path:
    if proc is None:
        return out
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelCompileError(
            f"nvcc failed on {_source(name)} (exit {proc.returncode}):\n{log}")
    # what -Xptxas -v said (registers, shared memory, spills), kept for reading
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)          # atomic: a concurrent build loses nothing
    return out


def build_all(names=KERNEL_SOURCES) -> dict[str, Path]:
    """Build every kernel source that is not built yet, all ``nvcc``
    processes started together; returns ``{name: library path}``."""
    started = [(n, *_start_build(n)) for n in names]
    built, failure = {}, None
    for name, proc, tmp, out in started:      # wait for every process started
        try:
            built[name] = _finish_build(name, proc, tmp, out)
        except KernelCompileError as e:
            failure = failure or e
    if failure is not None:
        raise failure
    return built


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built first if need be)."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all((name,))[name]))
        _LOADED[name] = lib
    return lib


def check_launch(err: int, lib: ctypes.CDLL, name: str) -> None:
    """Raise if the launch entry of ``csrc/<name>.cu`` reported a CUDA error
    (a refused launch never runs, and a later synchronize does not say so)."""
    if err != 0:
        text = getattr(lib, f"{name}_error_string")
        text.restype = ctypes.c_char_p
        text.argtypes = [ctypes.c_int]
        raise RuntimeError(
            f"{name}: CUDA launch failed with error {err} "
            f"({text(err).decode(errors='replace')})")
