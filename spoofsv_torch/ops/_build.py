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

from spoofsv_torch.utils.profiling import count, span

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
    "decode_cluster": {
        "spoofsv_decode_cluster_launch": (_I, [_I, _P] + [_I] * 11 + [_P]),
        "spoofsv_decode_cluster_smem": (_I, [_I] * 7),
        "spoofsv_decode_cluster_error_string": (ctypes.c_char_p, [_I]),
    },
    "decode_cluster_probe": {
        "spoofsv_decode_cluster_launch": (_I, [_I, _P] + [_I] * 11 + [_P]),
        "spoofsv_decode_cluster_probe_launch": (_I, [_I, _P, _P] + [_I] * 11 + [_P]),
        "spoofsv_decode_cluster_max_active": (_I, [_I] * 7),
        "spoofsv_decode_cluster_error_string": (ctypes.c_char_p, [_I]),
    },
    "gl": {
        "spoofsv_gl_init_launch": (_I, [_I] + [_P] * 6 + [_I] * 5 + [_F] * 5 + [_P]),
        "spoofsv_gl_run": (_I, [_P] * 10 + [_I] * 6 + [_F, _P]),
        "spoofsv_gl_error_string": (ctypes.c_char_p, [_I]),
    },
    "gl_probe": {
        "spoofsv_gl_init_launch": (_I, [_I] + [_P] * 6 + [_I] * 5 + [_F] * 5 + [_P]),
        "spoofsv_gl_run": (_I, [_P] * 10 + [_I] * 6 + [_F, _P]),
        "spoofsv_gl_probe_read": (_I, [_P]),
        "spoofsv_gl_error_string": (ctypes.c_char_p, [_I]),
    },
    "gl_tc": {
        "spoofsv_gl_tc_run": (_I, [_I] + [_P] * 16 + [_I] * 4 + [_F, _P]),
        "spoofsv_gl_tc_error_string": (ctypes.c_char_p, [_I]),
    },
    "gl_tc_probe": {
        "spoofsv_gl_tc_run": (_I, [_I] + [_P] * 16 + [_I] * 4 + [_F, _P]),
        "spoofsv_gl_tc_error_string": (ctypes.c_char_p, [_I]),
    },
    "highway": {
        "spoofsv_highway_gate_launch": (_I, [_I] + [_P] * 6 + [_I, _P, _I, _I, _F, _P]),
        "spoofsv_highway_error_string": (ctypes.c_char_p, [_I]),
    },
    "hconv_pair": {
        "spoofsv_hconv_launch": (_I, [_I] + [_P] * 6 + [_I] * 7 + [_F, _P]),
        "spoofsv_hconv_pair_launch": (_I, [_I] + [_P] * 11 + [_I] * 10 + [_F, _P]),
        "spoofsv_hconv_smem": (_I, [_I, _I]),
        "spoofsv_hconv_pair_error_string": (ctypes.c_char_p, [_I]),
    },
    "t2_rollout": {
        "spoofsv_t2_att_step": (_I, [_P] * 14 + [_I] * 14 + [_P]),
        "spoofsv_t2_dec_step": (_I, [_P] * 12 + [_I] * 12 + [_F, _P]),
        "spoofsv_t2_att_smem": (_I, [_I] * 8),
        "spoofsv_t2_dec_smem": (_I, [_I] * 6),
        "spoofsv_t2_resident_clusters": (_I, [_I, _I]),
        "spoofsv_t2_rollout_error_string": (ctypes.c_char_p, [_I]),
    },
    "t2_rollout_probe": {
        "spoofsv_t2_att_step": (_I, [_P] * 14 + [_I] * 14 + [_P]),
        "spoofsv_t2_dec_step": (_I, [_P] * 12 + [_I] * 12 + [_F, _P]),
        "spoofsv_t2_att_smem": (_I, [_I] * 8),
        "spoofsv_t2_dec_smem": (_I, [_I] * 6),
        "spoofsv_t2_resident_clusters": (_I, [_I, _I]),
        "spoofsv_t2_probe_read": (_I, [_P]),
        "spoofsv_t2_rollout_error_string": (ctypes.c_char_p, [_I]),
    },
}

# builds of a source with extra flags, for development tools only
# (build_all skips them): name -> (source, flags)
VARIANTS: Dict[str, Tuple[str, List[str]]] = {
    "decode_cluster_probe": ("decode_cluster", ["-DSPOOFSV_K1_PROBE"]),
    "gl_probe": ("gl", ["-DSPOOFSV_GL_PROBE"]),
    "gl_tc_probe": ("gl_tc", ["-DSPOOFSV_GLTC_PROBE"]),
    "t2_rollout_probe": ("t2_rollout", ["-DSPOOFSV_T2_PROBE"]),
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


def _target(name: str) -> Tuple[Path, Path, List[str]]:
    source, extra = VARIANTS.get(name, (name, []))
    src, flags = CSRC / f"{source}.cu", NVCC_FLAGS + extra
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}_{digest}.so", flags


def _start(name: str) -> Optional[Tuple[subprocess.Popen, Path, float]]:
    """Start ``nvcc`` for ``name`` unless its library is built; returns the
    process, its temporary output and its start time."""
    src, out, flags = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen([nvcc(), *flags, "-o", str(tmp), str(src)],
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    count("kernel_builds")
    return proc, tmp, time.perf_counter()


def _finish(name: str, started: Optional[Tuple[subprocess.Popen, Path, float]]) -> ctypes.CDLL:
    """Wait for the build of ``name`` (if one was started), then load and bind it."""
    src, out, _ = _target(name)
    info = {"source": str(src.relative_to(PKG.parent)), "cached": started is None}
    log = out.with_suffix(".ptxas")   # the build's ptxas lines, kept beside the library
    if started is not None:
        proc, tmp, t0 = started
        _, stderr = proc.communicate()
        info["seconds"] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{stderr[-4000:]}")
        log.write_text("\n".join(ln for ln in stderr.splitlines() if "Function properties" in ln
                                 or "registers" in ln or "spill" in ln))
        os.replace(tmp, out)
    info["ptxas"] = log.read_text().splitlines() if log.exists() else []
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
    with span("setup.kernels"):
        return _finish(name, _start(name))


def build_all() -> Dict[str, dict]:
    """Build every kernel library (not the development :data:`VARIANTS`),
    one ``nvcc`` per source started together, and load them; returns the
    build log."""
    with span("setup.kernels"):
        started = {name: _start(name) for name in SIGNATURES
                   if name not in _LIBS and name not in VARIANTS}
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
    """The raw handle of ``device``'s current stream (``current_stream(device)
    .cuda_stream`` builds a Stream object first, on every launch)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def device_ms(fn, name: str, reps: int = 20) -> Tuple[Optional[float], Optional[float]]:
    """Device time of ``reps`` back-to-back calls of ``fn`` under
    ``torch.profiler``: (ms a call of all the device work it runs, kernels and
    copies; ms a launch of the kernels whose name holds ``name``), each None
    when the profiler records no such work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    every, named, count = 0.0, 0.0, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            us = getattr(e, "self_cuda_time_total", 0.0) if us is None else us
            every += us
            if name in e.key:
                named += us
                count += e.count
    return (every / 1e3 / reps if every else None,
            named / 1e3 / count if count and named else None)


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
