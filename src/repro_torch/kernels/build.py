"""Builds the port's CUDA sources (``kernels/csrc/*.cu``) at first use.

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface under ``build/kernels/`` at the repository
root, named by a hash of the source, the shared headers (``csrc/*.cuh``)
and the flags, so an edited source is rebuilt and an unchanged one is
loaded as it is. The library is bound with
``ctypes``: no PyTorch headers are compiled, which keeps a build to
seconds. ``nvcc -Xptxas -v``'s report (registers, shared memory, spills)
is kept beside the library as ``.log``.

``bind`` loads a library with its C functions' types set, and the helpers
below it serve every kernel wrapper: the device rule (a CUDA tensor
launches, a CPU tensor takes the plain version), input checks, and
``launch_counts``, which each wrapper increments where it launches its
kernel and nowhere else, so a run can show that its main path went
through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def sources() -> List[str]:
    """Names of every kernel source in ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the CUDA kernels")


def library_path(name: str) -> Path:
    parts = [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in parts)
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source whose library is missing, one ``nvcc``
    per source, all started together. Returns the compiler report of each
    name (the cached report for a library built earlier)."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{report}")
            continue
        out.with_suffix(".log").write_text(report)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: library_path(name).with_suffix(".log").read_text()
            for name in names}


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, built first if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))


# launches per kernel, keyed by kernel name; each kernel module adds its
# names at import
launch_counts: Dict[str, int] = {}
_bound: Dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def bind(name: str, signatures: dict) -> ctypes.CDLL:
    """``load(name)`` with each C function's types set from
    ``signatures`` ({function: (argument types, result type)}); the
    library must export ``<name>_error_string``."""
    if name not in _bound:
        lib = load(name)
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        getattr(lib, f"{name}_error_string").argtypes = [ctypes.c_int]
        getattr(lib, f"{name}_error_string").restype = ctypes.c_char_p
        _bound[name] = lib
    return _bound[name]


def raise_on(status: int, lib: str, what: str) -> None:
    """Raises unless a launch of library ``lib`` (bound) returned 0."""
    if status != 0:
        msg = getattr(_bound[lib], f"{lib}_error_string")(status).decode()
        raise RuntimeError(f"{what} launch failed: {msg} (status {status})")


def on_card(what: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one (the plain path)."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {t.device}")
    return True


def sm_count(t: torch.Tensor) -> int:
    """The number of SMs of the card ``t`` lies on (for launch plans)."""
    return torch.cuda.get_device_properties(t.device).multi_processor_count


def stream(t: torch.Tensor) -> int:
    """PyTorch's current CUDA stream on ``t``'s device, as an int."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_tensor(name: str, t: torch.Tensor, dev: torch.device,
                 dtype: torch.dtype) -> None:
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
