"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Every ``repro_torch/csrc/*.cu`` is compiled on its own by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface (``*.cuh`` are
headers the sources share)::

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/repro_torch_kernels/<name>-<hash>.so

The output lands in ``<checkout>/build/repro_torch_kernels/`` (git-ignored),
named by a hash of the source, the shared headers and the flags, so an
edited source rebuilds and an unchanged one loads the library already
there. Building takes
seconds per file because no source includes PyTorch's headers: wrappers
pass raw pointers from ``tensor.data_ptr()`` and the stream from
``torch.cuda.current_stream().cuda_stream``, all as ``ctypes.c_void_p``.
Each C entry point returns ``cudaGetLastError()`` after its launch; the
wrappers raise on a non-zero value (see ``check``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = tuple(sorted(p.stem for p in CSRC.glob("*.cu")))
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    # the shared headers count too: a source that includes an edited header
    # rebuilds
    src = b"".join(p.read_bytes() for p in
                   [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    h = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{h}.so"


def build_all(names=SOURCES) -> dict:
    """Compile every source whose library is missing, one ``nvcc`` per
    source, all started together. Returns ``{name: {"seconds", "log",
    "cached"}}`` where ``log`` is nvcc's ``-Xptxas -v`` report (registers,
    shared memory, spills per kernel). Raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs, out = {}, {}
    t0 = time.perf_counter()
    for name in names:
        so = _target(name)
        log = so.with_suffix(".log")
        if so.exists():
            out[name] = {"seconds": 0.0, "cached": True,
                         "log": log.read_text() if log.exists() else ""}
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [nvcc, *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so, log)
    failed = []
    for name, (proc, tmp, so, log) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{text}")
            continue
        log.write_text(text)
        os.replace(tmp, so)
        out[name] = {"seconds": time.perf_counter() - t0, "cached": False,
                     "log": text}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            so = _target(name)
            if not so.exists():
                build_all((name,))
            lib = _LIBS[name] = ctypes.CDLL(str(so))
        return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
