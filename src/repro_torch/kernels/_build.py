"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C function and is compiled on its
own into ``build/repro_torch/<name>-<hash>.so`` at the repository root (the
hash covers the source and the flags, so an edited source rebuilds).  The
build happens at first use, never on import; ``build()`` starts one
``nvcc`` per source at once, so a cold start costs the slowest file, not
the sum.  No PyTorch headers are compiled: pointers, sizes and the stream
cross as plain integers.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("flash_attention", "decode_attention", "mamba2_ssd",
           "rwkv6_wkv")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return str(path)


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"{name}-{key.hexdigest()[:16]}.so"


def build(names=SOURCES, *, verbose: bool = False) -> dict[str, str]:
    """Compile every source in ``names`` that is not built yet, all at once.

    Returns ``{name: compiler output}`` for the sources it compiled
    (``verbose`` adds ``-Xptxas -v``: registers, shared memory, spills).
    Raises if any compile fails."""
    nvcc = None
    running = {}
    for name in names:
        src, out = _target(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in running.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            failed.append(name)
        else:
            os.replace(tmp, out)     # atomic: a reader never sees half a .so
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str, fn: str, argtypes):
    """C function ``fn`` of ``csrc/<name>.cu`` (built on first use), typed
    with ``argtypes`` and returning an int (the CUDA error code)."""
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(_target(name)[1]))
        _libs[name] = lib
    func = getattr(lib, fn)
    if func.argtypes is None:
        func.argtypes, func.restype = argtypes, ctypes.c_int
    return func


def stream_of(t) -> int:
    """The current CUDA stream of ``t``'s device, as an integer handle."""
    return torch.cuda.current_stream(t.device).cuda_stream
