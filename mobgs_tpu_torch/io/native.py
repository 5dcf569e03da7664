"""ctypes binding of the native PLY codec (``native/mobgs_io.cpp``; port of
``mobgs_tpu/io/native.py``).

The library is compiled on first use with ``g++`` into
``build/native/libmobgs_io_<hash>.so`` (the hash over the source and the
flags), never beside the source. Host file IO only. Where the toolchain
or the build is missing, every caller falls back to the Python codec of
``io/ply.py``: the native path is an accelerator, never a dependency.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "mobgs_io.cpp"
BUILD_DIR = ROOT / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")


class _Binding:
    """The loaded library, or None once a build or load has failed."""
    lib: ctypes.CDLL | None = None
    tried = False


def library_path() -> Path:
    sha = hashlib.sha1(SOURCE.read_bytes())
    sha.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libmobgs_io_{sha.hexdigest()[:12]}.so"


def load_library() -> ctypes.CDLL | None:
    if _Binding.lib is not None or _Binding.tried:
        return _Binding.lib
    _Binding.tried = True
    try:
        so = library_path()
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                           check=True, capture_output=True)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
    except (OSError, subprocess.CalledProcessError):
        return None
    i64, f32p = ctypes.c_int64, ctypes.POINTER(ctypes.c_float)
    lib.ply_write_f32.restype = ctypes.c_int
    lib.ply_write_f32.argtypes = [ctypes.c_char_p, ctypes.c_char_p, i64, i64, f32p]
    lib.ply_probe.restype = ctypes.c_int
    lib.ply_probe.argtypes = [ctypes.c_char_p, ctypes.POINTER(i64),
                              ctypes.POINTER(i64), ctypes.POINTER(i64),
                              ctypes.c_char_p, i64]
    lib.ply_read_f32.restype = ctypes.c_int
    lib.ply_read_f32.argtypes = [ctypes.c_char_p, i64, i64, i64, f32p]
    _Binding.lib = lib
    return lib


def ply_write(path: str, names: list[str], data: np.ndarray) -> bool:
    """Native PLY write; False if the library is unavailable or the write
    failed."""
    lib = load_library()
    if lib is None:
        return False
    data = np.ascontiguousarray(data, np.float32)
    n, c = data.shape
    if c != len(names):
        raise ValueError(f"{c} columns for {len(names)} names")
    rc = lib.ply_write_f32(path.encode(), "\n".join(names).encode(), n, c,
                           data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return rc == 0


def ply_read(path: str):
    """Native PLY read → (names, data [n, c] float32), or None if the
    library is unavailable or the file is not a float-only PLY."""
    lib = load_library()
    if lib is None:
        return None
    rows, cols, hdr = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    buf = ctypes.create_string_buffer(65536)
    rc = lib.ply_probe(path.encode(), ctypes.byref(rows), ctypes.byref(cols),
                       ctypes.byref(hdr), buf, len(buf))
    if rc != 0:
        return None
    names = buf.value.decode().strip().split("\n")
    out = np.empty((rows.value, cols.value), np.float32)
    rc = lib.ply_read_f32(path.encode(), hdr.value, rows.value, cols.value,
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        return None
    return names, out
