"""ctypes bindings for the native runtime components (``runtime/*.cpp``).

Twin of :mod:`ppqsflhe_tpu.runtime.native`. The C++ pieces mirror the
reference's native layer (a Mongoose HTTP server, OpenSSL Base64) and are
optional: :class:`NativeSerde` falls back to the stdlib's ``base64`` when
the library is not built, as the JAX module does. :func:`build_native`
compiles them with make and g++ into ``build/ppqsflhe_tpu_torch/runtime/``
under the repository root (``bin/artifact_server``, ``lib/libserde.so``),
never inside the package. The server binary is a drop-in for the Python
artifact server of :mod:`..comm.server` (same routes, same metrics CSV);
start it as ``artifact_server <storage_root> <port> [metrics_csv]`` (port
0 picks a free one and prints ``LISTENING <port>``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

SRC = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ppqsflhe_tpu_torch" / "runtime"


def build_native(quiet: bool = True) -> bool:
    """Compile the native components; True on success."""
    try:
        r = subprocess.run(["make", "-C", str(SRC), "all", f"BIN={BUILD_DIR / 'bin'}",
                            f"LIB={BUILD_DIR / 'lib'}"], capture_output=quiet, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return False
    return r.returncode == 0


def native_server_binary() -> str | None:
    p = BUILD_DIR / "bin" / "artifact_server"
    return str(p) if p.exists() else None


class NativeSerde:
    """Base64 codec backed by ``libserde.so`` (fallback: stdlib base64)."""

    def __init__(self):
        self._lib = None
        so = BUILD_DIR / "lib" / "libserde.so"
        if so.exists():
            try:
                lib = ctypes.CDLL(str(so))
            except OSError:
                return
            lib.b64_encode.restype = ctypes.c_size_t
            lib.b64_encode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p]
            lib.b64_decode.restype = ctypes.c_size_t
            lib.b64_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p]
            self._lib = lib

    @property
    def is_native(self) -> bool:
        return self._lib is not None

    def encode(self, data: bytes) -> str:
        if self._lib is None:
            import base64

            return base64.b64encode(data).decode()
        out = ctypes.create_string_buffer(4 * ((len(data) + 2) // 3) + 1)
        n = self._lib.b64_encode(data, len(data), out)
        return out.raw[:n].decode()

    def decode(self, s: str) -> bytes:
        if self._lib is None:
            import base64

            return base64.b64decode(s)
        raw = s.encode()
        out = ctypes.create_string_buffer(3 * ((len(raw) + 3) // 4) + 1)
        n = self._lib.b64_decode(raw, len(raw), out)
        if n == ctypes.c_size_t(-1).value:
            raise ValueError("malformed base64")
        return out.raw[:n]
