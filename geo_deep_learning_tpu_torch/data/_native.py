"""ctypes bridge to the port's C++ host readers: ``native/tar_reader.cc``
(tar shards) and ``native/tiff_reader.cc`` (GeoTIFF pixels through libtiff).

The port's counterpart of ``geo_deep_learning_tpu/data/_native.py``, with
its C interface (``gdl_tar_open/next/read/close``,
``gdl_tiff_read_info/read``) and its Python functions. Each reader is built
at first use by one ``g++`` call (``-O3 -fPIC -shared -std=c++17``, plus
``-ltiff`` for TIFF) into ``build/host_readers/`` beside the package, under
a file lock so that concurrent worker processes build it once, into a
temporary name that is then renamed into place. A stamp of the source and
flags decides whether an existing build is current.

What runs is never chosen silently. The first use in a process logs, at
INFO, each kind's decoder and why, e.g. ``tar: native
(build/host_readers/libgdltar.so)`` or ``tiff: numpy codec (no
tiffio.h)``; :data:`DECODERS` keeps those lines. An absence keeps the
Python path: no ``g++``, for TIFF no ``tiffio.h``, or
``GDL_TPU_NO_NATIVE=1`` (both readers off, for parity debugging). Where
the toolchain is present, a build or a load that fails raises, with the
compiler's output.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import logging
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

SRC_DIR = Path(__file__).resolve().parents[1] / "native"
REPO_DIR = Path(__file__).resolve().parents[2]
BUILD_DIR = REPO_DIR / "build" / "host_readers"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")
BUILD_TIMEOUT_S = 300
LOCK_TIMEOUT_S = 600
NAME_BUF = 4096  # the tar reader's name buffer (tar_reader.cc kNameMax + 1)

_DTYPES = {1: np.uint8, 2: np.uint16, 3: np.uint32, 4: np.int8, 5: np.int16, 6: np.int32,
           7: np.float32, 8: np.float64}


@dataclass(frozen=True)
class _Reader:
    kind: str
    source: str
    lib_name: str
    link: tuple[str, ...]
    header: str | None  # a header whose absence means "no such reader here"
    fallback: str  # what runs without it


_TAR = _Reader("tar", "tar_reader.cc", "libgdltar.so", (), None, "tarfile")
_TIFF = _Reader("tiff", "tiff_reader.cc", "libgdltiff.so", ("-ltiff",), "tiffio.h",
                "numpy codec")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL | None] = {}
# kind -> the decoder that runs in this process and why (set at first use)
DECODERS: dict[str, str] = {}
_file_fallback_logged = False


@contextlib.contextmanager
def _file_lock(path: Path):
    """An exclusive ``flock`` on ``path``, waited for at most LOCK_TIMEOUT_S."""
    with path.open("a") as f:
        end = time.monotonic() + LOCK_TIMEOUT_S
        while True:
            try:
                fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except BlockingIOError:
                if time.monotonic() > end:
                    msg = f"waited {LOCK_TIMEOUT_S} s for the build lock {path}"
                    raise TimeoutError(msg) from None
                time.sleep(0.05)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _has_header(gxx: str, header: str) -> bool:
    proc = subprocess.run([gxx, "-E", "-x", "c++", "-", "-o", os.devnull],
                          input=f"#include <{header}>\n", capture_output=True, text=True,
                          timeout=BUILD_TIMEOUT_S, check=False)
    return proc.returncode == 0


def _build(reader: _Reader, gxx: str) -> Path:
    """The reader's library, compiled unless a build of this source and
    these flags exists; raises with the compiler's output if it fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / reader.lib_name
    stamp_path = BUILD_DIR / f"{reader.lib_name}.stamp"
    source = SRC_DIR / reader.source
    h = hashlib.sha256(" ".join((*CXX_FLAGS, *reader.link)).encode())
    h.update(source.read_bytes())
    stamp = h.hexdigest()
    with _file_lock(BUILD_DIR / f"{reader.lib_name}.lock"):
        if lib.exists() and stamp_path.exists() and stamp_path.read_text() == stamp:
            return lib
        tmp = BUILD_DIR / f"{reader.lib_name}.{os.getpid()}.tmp"
        cmd = [gxx, *CXX_FLAGS, "-o", str(tmp), str(source), *reader.link]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=BUILD_TIMEOUT_S, check=False)
            if proc.returncode != 0:
                msg = (f"building the {reader.kind} reader failed: {' '.join(cmd)} -> "
                       f"{proc.returncode}\n{proc.stdout}{proc.stderr}")
                raise RuntimeError(msg)
            os.replace(tmp, lib)
        finally:
            tmp.unlink(missing_ok=True)
        stamp_path.write_text(stamp)
    return lib


def _bind(kind: str, lib: ctypes.CDLL) -> None:
    if kind == "tiff":
        lib.gdl_tiff_read_info.argtypes = [ctypes.c_char_p] + [ctypes.POINTER(ctypes.c_int32)] * 4
        lib.gdl_tiff_read_info.restype = ctypes.c_int
        lib.gdl_tiff_read.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
        lib.gdl_tiff_read.restype = ctypes.c_int
        return
    lib.gdl_tar_open.argtypes = [ctypes.c_char_p]
    lib.gdl_tar_open.restype = ctypes.c_void_p
    lib.gdl_tar_next.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
    lib.gdl_tar_next.restype = ctypes.c_int
    lib.gdl_tar_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.gdl_tar_read.restype = ctypes.c_int
    lib.gdl_tar_close.argtypes = [ctypes.c_void_p]
    lib.gdl_tar_close.restype = None


def _open(reader: _Reader) -> tuple[ctypes.CDLL | None, str]:
    """The loaded library (None where it is absent) and what runs, with why."""
    if os.environ.get("GDL_TPU_NO_NATIVE") == "1":
        return None, f"{reader.fallback} (GDL_TPU_NO_NATIVE=1)"
    gxx = shutil.which("g++")
    if gxx is None:
        return None, f"{reader.fallback} (no g++)"
    if reader.header and not _has_header(gxx, reader.header):
        return None, f"{reader.fallback} (no {reader.header})"
    path = _build(reader, gxx)
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        msg = f"loading the {reader.kind} reader {path} failed: {e}"
        raise RuntimeError(msg) from e
    _bind(reader.kind, lib)
    shown = path.relative_to(REPO_DIR) if path.is_relative_to(REPO_DIR) else path
    return lib, f"native ({shown})"


def _load(reader: _Reader) -> ctypes.CDLL | None:
    if reader.kind in _loaded:
        return _loaded[reader.kind]
    with _lock:
        if reader.kind not in _loaded:
            lib, how = _open(reader)
            DECODERS[reader.kind] = how
            logger.info("%s: %s", reader.kind, how)
            _loaded[reader.kind] = lib
    return _loaded[reader.kind]


def get_lib() -> ctypes.CDLL | None:
    """The libtiff pixel decoder, or None where it is absent here."""
    return _load(_TIFF)


def get_tar_lib() -> ctypes.CDLL | None:
    """The tar reader, or None where it is absent here."""
    return _load(_TAR)


def decoders() -> dict[str, str]:
    """Each kind's decoder in this process and why (builds the readers)."""
    get_tar_lib()
    get_lib()
    return dict(DECODERS)


def iter_tar_members_native(path: str | Path):
    """``(name, bytes)`` of each file member of a tar shard, in archive
    order, through the native reader; None (not an iterator) where the
    reader is absent. A name longer than the reader's buffer, or a
    malformed header, raises ``OSError`` mid-iteration."""
    lib = get_tar_lib()
    if lib is None:
        return None

    def gen():
        handle = lib.gdl_tar_open(str(path).encode())
        if not handle:
            msg = f"cannot open tar shard {path}"
            raise OSError(msg)
        try:
            name_buf = ctypes.create_string_buffer(NAME_BUF)
            size = ctypes.c_int64()
            while True:
                rc = lib.gdl_tar_next(handle, name_buf, ctypes.byref(size))
                if rc == 0:
                    return
                if rc < 0:
                    msg = f"tar parse error {rc} in {path}"
                    raise OSError(msg)
                buf = ctypes.create_string_buffer(size.value)
                if lib.gdl_tar_read(handle, buf) != 0:
                    msg = f"tar read error in {path}"
                    raise OSError(msg)
                yield name_buf.value.decode("utf-8", "replace"), buf.raw
        finally:
            lib.gdl_tar_close(handle)

    return gen()


def read_pixels_native(path: str | Path) -> np.ndarray | None:
    """HWC pixels decoded by libtiff; None where the decoder is absent or
    libtiff cannot decode this file (the numpy codec then reads it; the
    first such file is logged once a process)."""
    global _file_fallback_logged
    lib = get_lib()
    if lib is None:
        return None
    w, h, c, dt = (ctypes.c_int32() for _ in range(4))
    p = str(path).encode()
    rc = lib.gdl_tiff_read_info(p, w, h, c, dt)
    dtype = _DTYPES.get(dt.value) if rc == 0 else None
    out = None
    if dtype is not None:
        out = np.empty((h.value, w.value, c.value), dtype=dtype)
        rc = lib.gdl_tiff_read(p, out.ctypes.data_as(ctypes.c_void_p))
    if rc == 0 and out is not None:
        return out
    if not _file_fallback_logged:
        _file_fallback_logged = True
        logger.warning("tiff: libtiff could not decode %s (code %d); the numpy codec reads "
                       "such files", path, rc)
    return None
