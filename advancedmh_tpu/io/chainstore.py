"""Streaming chain store — Python bindings over the native writer.

Wraps native/chainstore.cpp (background-thread binary log) via ctypes; the
shared library is built from that source with g++ into the git-ignored
``build/`` directory of the checkout, on first use or ahead of time with
``python -c "from advancedmh_tpu.io.chainstore import build_native;
build_native()"``. Falls back to a synchronous pure-numpy writer when no
toolchain is available (same on-disk format, so readers don't care).

Format: ``<path>.bin`` is raw row-major little-endian float32
``[rows × n_cols]``; ``<path>.json`` records the schema. Reading memory-maps
the log (zero-copy) via :func:`open_reader`.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sysconfig
import threading
from typing import List, Optional, Sequence

import numpy as np

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
_SRC = os.path.join(_REPO_ROOT, "native", "chainstore.cpp")
_LIB_PATH = os.path.join(_REPO_ROOT, "build", "libchainstore.so")
_build_lock = threading.Lock()
_lib = None
_lib_failed = False


def build_native() -> str:
    """Compile native/chainstore.cpp into ``build/`` unless an up-to-date
    library is already there; return its path. The library is written under
    a temporary name and renamed, so a concurrent process never loads a
    half-written file."""
    if os.path.exists(_LIB_PATH) and os.path.getmtime(
        _LIB_PATH
    ) >= os.path.getmtime(_SRC):
        return _LIB_PATH
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread", _SRC,
         "-o", tmp],
        check=True, capture_output=True,
    )
    os.replace(tmp, _LIB_PATH)
    return _LIB_PATH


def _load_native() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _build_lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            lib = ctypes.CDLL(build_native())
            lib.cs_open.restype = ctypes.c_void_p
            lib.cs_open.argtypes = [ctypes.c_char_p, ctypes.c_int64]
            lib.cs_append.restype = ctypes.c_int64
            lib.cs_append.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64
            ]
            lib.cs_flush.restype = ctypes.c_int
            lib.cs_flush.argtypes = [ctypes.c_void_p]
            lib.cs_rows.restype = ctypes.c_int64
            lib.cs_rows.argtypes = [ctypes.c_void_p]
            lib.cs_close.restype = ctypes.c_int
            lib.cs_close.argtypes = [ctypes.c_void_p]
            _lib = lib
        except (OSError, subprocess.CalledProcessError, FileNotFoundError):
            _lib_failed = True
    return _lib


class ChainStore:
    """Append-only float32 row log with async native writes.

    ``columns`` names the row layout (e.g. param names + "lp"); rows are
    appended as (n_rows, n_cols) float32 arrays.
    """

    def __init__(self, path: str, columns: Sequence[str]):
        self.path = path
        self.columns = list(columns)
        self.n_cols = len(self.columns)
        self._rows = 0
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
        with open(path + ".json", "w") as f:
            json.dump({"columns": self.columns, "dtype": "float32"}, f)
        lib = _load_native()
        self._lib = lib
        if lib is not None:
            self._handle = lib.cs_open(
                (path + ".bin").encode(), ctypes.c_int64(self.n_cols)
            )
            if not self._handle:
                raise OSError(f"cs_open failed for {path}.bin")
            self._file = None
        else:  # pure-python fallback
            self._handle = None
            self._file = open(path + ".bin", "wb")

    @property
    def native(self) -> bool:
        return self._handle is not None

    def append(self, rows: np.ndarray) -> None:
        rows = np.ascontiguousarray(rows, dtype=np.float32)
        if rows.ndim != 2 or rows.shape[1] != self.n_cols:
            raise ValueError(
                f"expected (n, {self.n_cols}) rows, got {rows.shape}"
            )
        self._rows += rows.shape[0]
        if self._handle is not None:
            n = self._lib.cs_append(
                self._handle,
                rows.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                ctypes.c_int64(rows.shape[0]),
            )
            if n != rows.shape[0]:
                raise OSError("cs_append failed")
        else:
            rows.tofile(self._file)

    def flush(self) -> None:
        if self._handle is not None:
            err = self._lib.cs_flush(self._handle)
            if err:
                raise OSError(f"chainstore writer error {err}")
        else:
            self._file.flush()

    def close(self) -> None:
        if self._handle is not None:
            err = self._lib.cs_close(self._handle)
            self._handle = None
            if err:
                raise OSError(f"chainstore close error {err}")
        elif self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self) -> "ChainStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def open_reader(path: str):
    """Memory-map a chain store; returns (memmap (rows, n_cols), columns)."""
    with open(path + ".json") as f:
        meta = json.load(f)
    cols = meta["columns"]
    raw = np.memmap(path + ".bin", dtype=np.float32, mode="r")
    rows = raw.size // len(cols)
    return raw[: rows * len(cols)].reshape(rows, len(cols)), cols
