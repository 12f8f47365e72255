"""ctypes bindings for the native runtime library (native/mg_runtime.cpp).

The reference's runtime — cycle parser, level bookkeeping, CSV writer — is
C++ (main()'s inline parser MG_solver_CPU.cpp:70-146, linkedlist.cpp,
doPrint2File MG_solver_CPU.cpp:735-754). This framework keeps the compute
path in JAX but mirrors that native runtime here: ``libmg_runtime.so``
provides the Cycle.txt grammar parser (schedule graph-builder) and fast
multithreaded Sol_* CSV I/O.

Every entry point has a pure-Python fallback (schedule.parse_cycle_file,
utils.io), so the library is an acceleration, not a requirement. The .so is
built on first use with ``make -C native`` (pybind11 is unavailable in this
toolchain; plain C ABI + ctypes instead).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parent.parent
_NATIVE_DIR = _REPO_ROOT / "native"
_LIB_PATH = _NATIVE_DIR / "libmg_runtime.so"
_ABI_VERSION = 1

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


class _MgHeader(ctypes.Structure):
    _fields_ = [
        ("length", ctypes.c_double),
        ("min_x", ctypes.c_double),
        ("min_y", ctypes.c_double),
        ("con_step", ctypes.c_int32),
        ("con_n", ctypes.c_int32),
        ("n_max", ctypes.c_int32),
        ("n_min", ctypes.c_int32),
    ]


class _MgInstruction(ctypes.Structure):
    _fields_ = [
        ("kind", ctypes.c_int32),
        ("steps", ctypes.c_int32),
        ("next_n", ctypes.c_int32),
        ("option", ctypes.c_int32),
        ("target_error", ctypes.c_double),
    ]


def _build() -> bool:
    if not (_NATIVE_DIR / "mg_runtime.cpp").exists():
        return False
    try:
        subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                       capture_output=True, timeout=120)
        return _LIB_PATH.exists()
    except (subprocess.SubprocessError, OSError):
        return False


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        if not _LIB_PATH.exists() and not _build():
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(_LIB_PATH))
            lib.mg_runtime_abi_version.restype = ctypes.c_int32
            if lib.mg_runtime_abi_version() != _ABI_VERSION:
                _load_failed = True
                return None
            lib.mg_parse_cycle.restype = ctypes.c_int32
            lib.mg_parse_cycle.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(_MgHeader),
                ctypes.POINTER(_MgInstruction), ctypes.c_int32,
                ctypes.c_char_p, ctypes.c_int32,
            ]
            lib.mg_write_csv.restype = ctypes.c_int32
            lib.mg_write_csv.argtypes = [
                ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                ctypes.c_int64, ctypes.c_char_p, ctypes.c_int32,
            ]
            lib.mg_read_csv.restype = ctypes.c_int32
            lib.mg_read_csv.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_double),
                ctypes.c_int64, ctypes.c_int64,
            ]
            _lib = lib
        except OSError:
            _load_failed = True
    return _lib


def available() -> bool:
    return load() is not None


# ---------------------------------------------------------------------------
# Cycle parsing
# ---------------------------------------------------------------------------

def parse_cycle_native(text: str):
    """Parse Cycle.txt text with the native parser → CycleProgram.

    Returns None if the native library is unavailable; raises ValueError on
    grammar errors (same error class as the Python parser).
    """
    lib = load()
    if lib is None:
        return None
    from .schedule import Ascend, CoarseSolve, CycleProgram, Descend

    raw = text.encode()
    hdr = _MgHeader()
    max_ins = max(64, len(raw))        # token count bounds instruction count
    buf = (_MgInstruction * max_ins)()
    err = ctypes.create_string_buffer(256)
    count = lib.mg_parse_cycle(raw, len(raw), ctypes.byref(hdr), buf, max_ins,
                               err, len(err))
    if count < 0:
        raise ValueError(f"Bad cycle file: {err.value.decode()}")

    instructions = []
    for i in range(count):
        ins = buf[i]
        if ins.kind == -1:
            instructions.append(Descend(next_n=ins.next_n, steps=ins.steps))
        elif ins.kind == 0:
            instructions.append(CoarseSolve(target_error=ins.target_error,
                                            option=ins.option))
        else:
            instructions.append(Ascend(steps=ins.steps))
    return CycleProgram(length=hdr.length, min_x=hdr.min_x, min_y=hdr.min_y,
                        n_max=hdr.n_max, instructions=tuple(instructions))


# ---------------------------------------------------------------------------
# CSV I/O
# ---------------------------------------------------------------------------

def write_csv_native(rows: np.ndarray, path: str, decimals: int = 6) -> bool:
    """Write rows (already in file order) as CSV; False if lib unavailable."""
    lib = load()
    if lib is None:
        return False
    arr = np.ascontiguousarray(rows, dtype=np.float64)
    rc = lib.mg_write_csv(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        arr.shape[0], arr.shape[1], str(path).encode(), decimals)
    if rc != 0:
        raise OSError(f"mg_write_csv failed with code {rc} for {path}")
    return True


def read_csv_native(path: str, n_rows: int, n_cols: int) -> Optional[np.ndarray]:
    lib = load()
    if lib is None:
        return None
    out = np.empty((n_rows, n_cols), dtype=np.float64)
    rc = lib.mg_read_csv(str(path).encode(),
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                         n_rows, n_cols)
    if rc != 0:
        raise OSError(f"mg_read_csv failed with code {rc} for {path}")
    return out
