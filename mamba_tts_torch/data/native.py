"""ctypes bindings for the native data runtime (native/libttsdata.so) — the
PyTorch port's own copy of ``mamba_tts_tpu/data/native.py``: it loads the
library built from the repository's ``native/`` sources and imports nothing
of either package.

The C++ library provides tar/tar.gz indexing, RIFF WAV decoding, polyphase
resampling, and multi-threaded batch loading — the roles the reference
delegates to torchaudio/libsndfile/soxr native code.  Falls back cleanly:
callers check :func:`available` and use the pure-Python path otherwise.
"""
from __future__ import annotations

import ctypes
import os
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

_LIB = None
_SEARCH = [
    Path(__file__).resolve().parents[2] / "native" / "libttsdata.so",
    Path(os.environ.get("TTSDATA_LIB", "")),
]


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    for p in _SEARCH:
        if p and p.is_file():
            lib = ctypes.CDLL(str(p))
            lib.tts_tar_open.restype = ctypes.c_void_p
            lib.tts_tar_open.argtypes = [ctypes.c_char_p]
            lib.tts_tar_count.restype = ctypes.c_int
            lib.tts_tar_count.argtypes = [ctypes.c_void_p]
            lib.tts_tar_find.restype = ctypes.c_int
            lib.tts_tar_find.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.tts_tar_name.restype = ctypes.c_int
            lib.tts_tar_name.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
            ]
            lib.tts_tar_close.argtypes = [ctypes.c_void_p]
            lib.tts_tar_read_wav.restype = ctypes.c_long
            lib.tts_tar_read_wav.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ]
            lib.tts_decode_wav.restype = ctypes.c_long
            lib.tts_decode_wav.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ]
            lib.tts_tar_read_batch.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                ctypes.POINTER(ctypes.c_long),
            ]
            lib.tts_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
            _LIB = lib
            return lib
    return None


def available() -> bool:
    return _load() is not None


def _take(lib, ptr, n) -> np.ndarray:
    arr = np.ctypeslib.as_array(ptr, shape=(n,)).copy()
    lib.tts_free(ptr)
    return arr


def decode_wav_bytes(data: bytes, target_sr: int = 0) -> Optional[np.ndarray]:
    """Decode WAV bytes to mono float32 (optionally resampled)."""
    lib = _load()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_float)()
    n = lib.tts_decode_wav(data, len(data), target_sr, ctypes.byref(out))
    if n < 0:
        return None
    return _take(lib, out, n)


class NativeTarReader:
    """Indexed tar/tar.gz WAV reader with multi-threaded batch decode."""

    def __init__(self, path: str):
        lib = _load()
        if lib is None:
            raise RuntimeError("libttsdata.so not built (run `make -C native`)")
        self._lib = lib
        self._h = lib.tts_tar_open(path.encode())
        if not self._h:
            raise IOError(f"failed to index tar: {path}")

    def __len__(self) -> int:
        return self._lib.tts_tar_count(self._h)

    def names(self) -> List[str]:
        buf = ctypes.create_string_buffer(4096)
        out = []
        for i in range(len(self)):
            n = self._lib.tts_tar_name(self._h, i, buf, 4096)
            if n >= 0:
                out.append(buf.value.decode())
        return out

    def find(self, name: str) -> int:
        return self._lib.tts_tar_find(self._h, name.encode())

    def read_wav(self, name_or_id, target_sr: int = 16000) -> Optional[np.ndarray]:
        i = self.find(name_or_id) if isinstance(name_or_id, str) else int(name_or_id)
        if i < 0:
            return None
        out = ctypes.POINTER(ctypes.c_float)()
        n = self._lib.tts_tar_read_wav(self._h, i, target_sr, ctypes.byref(out))
        if n < 0:
            return None
        return _take(self._lib, out, n)

    def read_batch(
        self, names_or_ids: Sequence, target_sr: int = 16000, n_threads: int = 8
    ) -> List[Optional[np.ndarray]]:
        ids = [
            self.find(x) if isinstance(x, str) else int(x) for x in names_or_ids
        ]
        count = len(ids)
        c_ids = (ctypes.c_int * count)(*ids)
        bufs = (ctypes.POINTER(ctypes.c_float) * count)()
        lens = (ctypes.c_long * count)()
        self._lib.tts_tar_read_batch(
            self._h, c_ids, count, target_sr, n_threads, bufs, lens
        )
        out: List[Optional[np.ndarray]] = []
        for i in range(count):
            if ids[i] < 0 or lens[i] < 0:
                out.append(None)
            else:
                out.append(_take(self._lib, bufs[i], lens[i]))
        return out

    def close(self):
        if self._h:
            self._lib.tts_tar_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
