"""Build ``spoofsv_torch/csrc/*.cu`` with ``nvcc`` at first use and bind via ctypes.

Each source becomes a shared library with a plain C interface, compiled for
``sm_90a``, in ``spoofsv_torch/_build/`` (listed in ``.gitignore``). The file
name carries a hash of the source and flags, so an edited source rebuilds.
:func:`build_all` starts one ``nvcc`` per source at once.
Pointers and the stream pass as ``c_void_p``; each launch function returns
``cudaGetLastError()``, which :func:`check` raises on.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signatures of every exported function: name -> (restype, argtypes)
SIGNATURES: Dict[str, Dict[str, Tuple[object, List[object]]]] = {
    "decode": {
        "spoofsv_decode_ring_slots": (_I, []),
        "spoofsv_decode_launch": (_I, [_I, _P] + [_I] * 8 + [_P]),
        "spoofsv_decode_error_string": (ctypes.c_char_p, [_I]),
    },
    "gl": {
        "spoofsv_gl_init_launch": (_I, [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                        _F, _F, _F, _F, _F, _P]),
        "spoofsv_gl_run": (_I, [_P] * 10 + [_I] * 6 + [_F, _P]),
        "spoofsv_gl_error_string": (ctypes.c_char_p, [_I]),
    },
    "highway": {
        "spoofsv_highway_gate_launch": (_I, [_I, _P, _P, _P, _P, _I, _I, _F, _P]),
        "spoofsv_hconv_launch": (_I, [_I] + [_P] * 5 + [_I] * 6 + [_F, _P]),
        "spoofsv_hconv_pair_launch": (_I, [_I] + [_P] * 8 + [_I] * 8 + [_F, _P]),
        "spoofsv_highway_error_string": (ctypes.c_char_p, [_I]),
    },
}

# the kernels' storage-type argument
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, dict] = {}


class LaunchCounter:
    """Launches of one kernel: its wrapper adds one where it launches, and nowhere else."""

    def __init__(self):
        self.launches = 0


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return found


def _target(name: str) -> Tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}_{digest}.so"


def _start(name: str) -> Optional[Tuple[subprocess.Popen, Path, float]]:
    """Start ``nvcc`` for ``name`` unless its library is built; returns the
    process, its temporary output and its start time."""
    src, out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    return proc, tmp, time.perf_counter()


def _finish(name: str, started: Optional[Tuple[subprocess.Popen, Path, float]]) -> ctypes.CDLL:
    """Wait for the build of ``name`` (if one was started), then load and bind it."""
    src, out = _target(name)
    info = {"source": str(src.relative_to(PKG.parent)), "cached": started is None}
    if started is not None:
        proc, tmp, t0 = started
        _, stderr = proc.communicate()
        info["seconds"] = time.perf_counter() - t0
        info["ptxas"] = [ln for ln in stderr.splitlines() if "registers" in ln or "spill" in ln]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{stderr[-4000:]}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for fn, (restype, argtypes) in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.restype = restype
        f.argtypes = argtypes
    BUILD_LOG[name] = info
    _LIBS[name] = lib
    return lib


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; returns the bound library."""
    if name in _LIBS:
        return _LIBS[name]
    return _finish(name, _start(name))


def build_all() -> Dict[str, dict]:
    """Build every kernel library, one ``nvcc`` per source started together,
    and load them; returns the build log."""
    started = {name: _start(name) for name in SIGNATURES if name not in _LIBS}
    try:
        for name, proc in started.items():
            _finish(name, proc)
    finally:   # a failed build leaves no compiler running
        for s in started.values():
            if s is not None and s[0].poll() is None:
                s[0].kill()
                s[0].wait()
    return dict(BUILD_LOG)


def check(lib: ctypes.CDLL, name: str, err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if err != 0:
        msg = getattr(lib, f"spoofsv_{name}_error_string")(err)
        raise RuntimeError(f"{what}: CUDA error {err} ({msg.decode() if msg else '?'})")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(*tensors: torch.Tensor) -> torch.device:
    """All tensors on one CUDA device and contiguous; returns the device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {t.device} vs {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    if dev.type != "cuda":
        raise ValueError(f"expected CUDA tensors, got {dev}")
    return dev
