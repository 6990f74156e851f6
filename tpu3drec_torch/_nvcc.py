"""The port's kernel layer: build the CUDA C++ sources in `csrc/` with
nvcc, bind their C entry points with ctypes, and route and launch them.

Each source is one shared library with a plain C interface (no PyTorch
headers, so a build takes seconds). Libraries go to `_build/` beside this
file, named by a hash of the source, the shared headers and the flags, so
an edited source never loads a stale build. A build happens at first use;
`build()` compiles several sources at once, one nvcc process each. A
wrapper takes its plain PyTorch form for a CPU tensor and its kernel for
a CUDA tensor (`route`), and calls the kernel through `launch`.
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
from typing import Dict, Iterable

import torch

from tpu3drec_torch.utils.profiling import count

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
KERNEL_SOURCES = tuple(sorted(p.stem for p in CSRC.glob("*.cu")))

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set NVCC or put the CUDA toolkit "
                       "on PATH to build the kernels in tpu3drec_torch/csrc")


def library_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, str]:
    """Compile the named sources in parallel; returns each one's ptxas
    report (registers, shared memory, spills). Raises on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        reports[name] = text
        if proc.returncode != 0:
            failed.append(f"{name} (rc {proc.returncode}):\n{text}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            _LIBS[name] = lib
        return lib


@functools.lru_cache(maxsize=None)
def entry(name: str, symbol: str, argtypes: tuple, restype=ctypes.c_int):
    """The C function `symbol` of csrc/<name>.cu, typed once."""
    fn = getattr(load(name), symbol)
    fn.argtypes, fn.restype = list(argtypes), restype
    return fn


def route(what: str, device) -> str:
    """"plain" for the CPU, "kernel" for CUDA; any other device raises."""
    kind = torch.device(device).type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {device}")
    return "plain" if kind == "cpu" else "kernel"


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """`t`, or a copy where its data starts off a 16-byte boundary."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _on(name: str, device: torch.device):
    if device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got "
                         f"{device}")
    return torch.cuda.device(device)


def launch(name: str, symbol: str, argtypes: tuple, device: torch.device,
           *args) -> None:
    """Calls `symbol`, which takes the stream last and returns a CUDA
    error, with `args` on `device`'s current stream; raises
    `RuntimeError` on an error, else counts once on `<name>.launches`."""
    with _on(name, device):
        err = entry(name, symbol, argtypes)(
            *args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    count(f"{name}.launches")


def query(name: str, symbol: str, argtypes: tuple, device: torch.device,
          *args) -> int:
    """What `symbol` counts for `args` on `device` (a launch's scratch,
    say); its negative return is a CUDA error and raises `RuntimeError`."""
    with _on(name, device):
        n = entry(name, symbol, argtypes, ctypes.c_longlong)(*args)
    if n < 0:
        raise RuntimeError(f"{name}: device query failed: CUDA error {-n}")
    return n
