"""``libspoofkit``: the host-native speaker-ID stack (FLAC codec, WebRTC VAD,
MFCC, GMM/UBM, i-vector, PLDA, EER), built with ``g++`` at first use.

``src/`` and ``Makefile`` are the port's own copies of the JAX package's
native sources, kept byte-equal to them. :func:`load_lib` runs the
Makefile's recipe (its compiler, flags and source, read from the Makefile)
with the output at ``spoofsv_torch/_build/libspoofkit_<hash>.so``, the hash
taken over the Makefile and sources so an edited one rebuilds, and binds
every exported function's C signature through ctypes. A failed build
raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

NATIVE_DIR = Path(__file__).resolve().parent
SRC_DIR = NATIVE_DIR / "src"
MAKEFILE = NATIVE_DIR / "Makefile"
BUILD_DIR = NATIVE_DIR.parent / "_build"

_V = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_D = ctypes.c_double
_U64 = ctypes.c_uint64
_DP = ctypes.POINTER(ctypes.c_double)
_FP = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int)
_I16P = ctypes.POINTER(ctypes.c_int16)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_U8P = ctypes.POINTER(ctypes.c_uint8)

# every exported function: name -> (restype, argtypes), as the JAX package's
# loaders bind them (spoofkit/ivector.py, spoofkit/flacio.py)
SIGNATURES: Dict[str, Tuple[Optional[object], List[object]]] = {
    "sk_mfcc_new": (_V, [_I] * 3),
    "sk_mfcc_free": (None, [_V]),
    "sk_mfcc_num_frames": (_I, [_V, _I]),
    "sk_mfcc_compute": (None, [_V, _FP, _I, _DP, _DP]),
    "sk_energy_vad": (None, [_DP, _I, _D, _D, _I, _D, _U8P]),
    "sk_cmvn_sliding": (None, [_DP, _I, _I, _I]),
    "sk_add_deltas": (None, [_DP, _I, _I, _I, _I, _DP]),
    "sk_vad_new": (_V, [_I]),
    "sk_vad_free": (None, [_V]),
    "sk_vad_process": (_I, [_V, _I16P, _I, _I]),
    "sk_vad_frames": (_I, [_I, _I16P, _I64, _I, _I, _U8P]),
    "sk_vad_features": (_I, [_I16P, _I, _I16P]),
    "sk_train_diag_ubm": (_V, [_DP, _I, _I, _I, _I, _U64, _I]),
    "sk_diag_ubm_get": (None, [_V, _DP, _DP, _DP]),
    "sk_diag_ubm_from": (_V, [_DP, _DP, _DP, _I, _I]),
    "sk_diag_ubm_free": (None, [_V]),
    "sk_acc_stats": (None, [_V, _DP, _I, _I, _DP, _DP]),
    "sk_train_full_ubm": (_V, [_V, _DP, _I, _I, _I, _I]),
    "sk_full_ubm_get": (None, [_V, _DP, _DP, _DP]),
    "sk_full_ubm_from": (_V, [_DP, _DP, _DP, _I, _I]),
    "sk_full_ubm_free": (None, [_V]),
    "sk_full_acc_stats": (None, [_V, _DP, _I, _I, _DP, _DP]),
    "sk_train_ivector_full": (_V, [_V, _I, _DP, _DP, _I, _I, _U64, _I]),
    "sk_ivector_full_dim": (_I, [_V]),
    "sk_extract_ivector_full": (None, [_V, _DP, _DP, _DP]),
    "sk_ivector_full_free": (None, [_V]),
    "sk_ivector_full_get": (None, [_V, _DP, _DP, _DP]),
    "sk_ivector_full_from": (_V, [_DP, _DP, _DP, _I, _I, _I]),
    "sk_ivector_get": (None, [_V, _DP, _DP, _DP]),
    "sk_ivector_from": (_V, [_DP, _DP, _DP, _I, _I, _I]),
    "sk_plda_get": (None, [_V, _DP, _DP, _DP]),
    "sk_plda_from": (_V, [_DP, _DP, _DP, _I]),
    "sk_train_ivector": (_V, [_DP, _DP, _I, _I, _I, _DP, _DP, _I, _I, _U64, _I]),
    "sk_extract_ivector": (None, [_V, _DP, _DP, _DP]),
    "sk_ivector_free": (None, [_V]),
    "sk_train_plda": (_V, [_DP, _I, _I, _IP, _I, _I]),
    "sk_plda_transform": (None, [_V, _DP, _DP]),
    "sk_plda_llr": (_D, [_V, _DP, _I, _DP]),
    "sk_plda_free": (None, [_V]),
    "sk_compute_eer": (_D, [_DP, _I, _DP, _I, _DP]),
    "sk_flac_probe": (_I, [ctypes.c_char_p, _I64P, _IP, _IP, _IP]),
    "sk_flac_decode_alloc": (_V, [ctypes.c_char_p, _I64P, _IP, _IP, _IP]),
    "sk_flac_pcm_copy": (None, [_V, _I32P]),
    "sk_flac_pcm_free": (None, [_V]),
    "sk_flac_encode": (_I, [ctypes.c_char_p, _I32P, _I64, _I, _I, _I]),
}

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def build_command(out: Path) -> List[str]:
    """The Makefile's recipe, ``$(CXX) $(CXXFLAGS) $(LDFLAGS) $(SRC) -o
    $(OUT)``, with its own values and ``out`` for ``OUT``; run in
    ``NATIVE_DIR``."""
    var = dict(re.findall(r"^(\w+)\s*[:?]?=\s*(.*?)\s*$", MAKEFILE.read_text(), re.M))
    return [var["CXX"], *var["CXXFLAGS"].split(), *var["LDFLAGS"].split(),
            *var["SRC"].split(), "-o", str(out)]


def library_path() -> Path:
    """Where the build of the current sources goes (or already is)."""
    h = hashlib.sha256(MAKEFILE.read_bytes())
    for src in sorted(SRC_DIR.iterdir()):
        h.update(src.name.encode() + src.read_bytes())
    return BUILD_DIR / f"libspoofkit_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless this version of the sources is built;
    returns its path. Raises ``RuntimeError`` with the compiler's output on
    failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = build_command(tmp)
    proc = subprocess.run(cmd, cwd=NATIVE_DIR, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} failed to build libspoofkit:\n{proc.stderr}")
    os.replace(tmp, out)   # another process may have raced us: the same bytes
    return out


def load_lib() -> ctypes.CDLL:
    """The built, bound library (built on the first call of the process)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _LIB = lib
    return _LIB
