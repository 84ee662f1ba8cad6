"""ctypes binding for the port's native checkpoint-I/O engine
(``pyrecover_tpu_torch/native/pyrecover_io.cpp``), ported from the JAX
package's ``checkpoint/native_io.py``.

The shared library is built with ``g++`` at first use (one translation
unit, about a second) into ``build/pyrecover_tpu_torch/`` beside the
package, named by the source's hash so an edited source is rebuilt, and
bound with ctypes. When it cannot be built or loaded (no compiler, an
unsupported platform) ``available()`` is False and every caller degrades
as the JAX package does: sidecars fall back to ``sha256::`` and
``xxh64tree:`` sidecars verify through the pure-Python ``utils/xxh.py``.

Beside the JAX engine's calls (``xxh64``, ``tree_hash``, ``write_file``,
``read_file``, ``hash_file``) the port has ``pread_into``: one byte range
of a file read with parallel ``pread`` into a caller's buffer, so a
checkpoint is restored a leaf at a time instead of through a whole-file
buffer. ctypes releases the interpreter lock for every call.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

DEFAULT_CHUNK = 16 * 1024 * 1024

_SRC = Path(__file__).resolve().parent.parent / "native" / "pyrecover_io.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pyrecover_tpu_torch"

_lock = threading.Lock()
_lib = None
_tried = False


def _so_path():
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"libpyrecover_io_{digest}.so"


def _build(so):  # faultcheck: tear-ok -- a build cache, named by its source's hash
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-pthread", "-std=c++17",
           "-o", str(tmp), str(_SRC)]
    subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    os.replace(tmp, so)


def _bind(lib):
    p, u64, i = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int
    err = ctypes.POINTER(ctypes.c_int)
    for name, restype, argtypes in (
        ("pr_xxh64", u64, [p, u64]),
        ("pr_tree_hash", u64, [p, u64, u64, i]),
        ("pr_write_file", u64, [ctypes.c_char_p, p, u64, u64, i, err]),
        ("pr_read_file", u64, [ctypes.c_char_p, p, u64, u64, i, err]),
        ("pr_hash_file", u64, [ctypes.c_char_p, u64, i, err]),
        ("pr_pread_into", u64, [ctypes.c_char_p, u64, p, u64, u64, i, err]),
        ("pr_file_size", u64, [ctypes.c_char_p, err]),
    ):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            # concur: disable-next=blocking-under-lock -- the source's hash
            # names the one-time build this lock guards
            so = _so_path()
            if not so.exists():
                # concur: disable-next=blocking-under-lock -- one-time lazy
                # g++ build, guarded by exactly this lock to prevent a
                # double compile; it completes before the first save can
                _build(so)
            _lib = _bind(ctypes.CDLL(str(so)))
        except (OSError, subprocess.SubprocessError):
            _lib = None
        return _lib


def available():
    """Whether the library built and loaded (tried once per process)."""
    return _load() is not None


def _check(err, op, path):
    if err.value != 0:
        raise OSError(err.value, f"native {op} failed for {path}: {os.strerror(err.value)}")


def _pointer(data):
    """``(address, nbytes)`` of a bytes-like object, without a copy."""
    arr = np.frombuffer(data, dtype=np.uint8)
    return arr.ctypes.data, arr.nbytes, arr  # the array keeps the buffer alive


def xxh64(data) -> int:
    """xxh64 (seed 0) of a bytes-like object."""
    addr, n, _keep = _pointer(data)
    return int(_load().pr_xxh64(addr, n))


def tree_hash(data, chunk=DEFAULT_CHUNK, n_threads=0) -> int:
    """The tree checksum of a bytes-like object."""
    addr, n, _keep = _pointer(data)
    return int(_load().pr_tree_hash(addr, n, chunk, n_threads))


def write_file(path, data, chunk=DEFAULT_CHUNK, n_threads=0) -> int:
    """Parallel write (and fsync) of ``data``, checksummed in the same pass.
    Returns the tree hash."""
    from pyrecover_tpu_torch.resilience import faults

    faults.check("ckpt_write", path=str(path), written=0)
    addr, n, _keep = _pointer(data)
    err = ctypes.c_int(0)
    digest = _load().pr_write_file(str(path).encode(), addr, n, chunk, n_threads,
                                   ctypes.byref(err))
    _check(err, "write", path)
    return int(digest)


def read_file(path, chunk=DEFAULT_CHUNK, n_threads=0):
    """Parallel read of the whole file. Returns ``(bytes, tree hash)``."""
    from pyrecover_tpu_torch.resilience import faults

    lib = _load()
    faults.check("ckpt_read", path=str(path))
    err = ctypes.c_int(0)
    size = lib.pr_file_size(str(path).encode(), ctypes.byref(err))
    _check(err, "stat", path)
    buf = ctypes.create_string_buffer(size)
    digest = lib.pr_read_file(str(path).encode(), buf, size, chunk, n_threads,
                              ctypes.byref(err))
    _check(err, "read", path)
    return bytes(buf.raw), int(digest)


def pread_into(path, offset, out, chunk=DEFAULT_CHUNK, n_threads=0):
    """Fill ``out`` (a writable, C-contiguous bytes-like object, e.g. a uint8
    numpy array) with the file's bytes at ``offset`` by parallel pread.
    Raises ``OSError`` on a failed or short read."""
    arr = np.frombuffer(out, dtype=np.uint8)
    if not arr.flags.writeable:
        raise ValueError("pread_into needs a writable buffer")
    err = ctypes.c_int(0)
    _load().pr_pread_into(str(path).encode(), int(offset), arr.ctypes.data, arr.nbytes,
                          chunk, n_threads, ctypes.byref(err))
    _check(err, "read", path)


def hash_file(path, chunk=DEFAULT_CHUNK, n_threads=0) -> int:
    """Streaming parallel tree checksum of a file."""
    err = ctypes.c_int(0)
    digest = _load().pr_hash_file(str(path).encode(), chunk, n_threads, ctypes.byref(err))
    _check(err, "hash", path)
    return int(digest)
