"""Native (C++) host components, loaded via ctypes.

The reference implements its entire host runtime in C++; here the Python
orchestration layer calls into native code for the host-side hot loops
(tokenization — the index-build bottleneck). Compiled lazily with g++ on
first use and cached next to the source; falls back to the pure-numpy path
when no toolchain is available.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_LOCK = threading.Lock()
_LIB = None
_TRIED = False

_SRC = os.path.join(os.path.dirname(__file__), "tokenizer.cpp")
_SO = os.path.join(os.path.dirname(__file__), "libmttok.so")


def get_native_lib():
    """Returns the loaded ctypes library, or None if unavailable."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        try:
            if (not os.path.exists(_SO)
                    or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
                # build under a private name, then rename: processes that
                # build at once never load a half-written library
                tmp = f"{_SO}.{os.getpid()}.tmp"
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                     _SRC, "-o", tmp],
                    check=True, capture_output=True, timeout=120)
                os.replace(tmp, _SO)
            lib = ctypes.CDLL(_SO)
            lib.mt_tokenize.restype = ctypes.c_int
            lib.mt_tokenize.argtypes = [
                ctypes.c_char_p, ctypes.c_int,                  # text
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int,   # fold table
                ctypes.c_int, ctypes.c_int,                     # minlen, step
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int,   # codes
                ctypes.POINTER(ctypes.c_int32),                 # tok_off
                ctypes.POINTER(ctypes.c_int32),                 # len
                ctypes.POINTER(ctypes.c_int32),                 # pos
                ctypes.POINTER(ctypes.c_int32),                 # char_start
                ctypes.POINTER(ctypes.c_int32),                 # char_end
                ctypes.c_int,                                   # cap_tokens
            ]
            lib.mt_crc64.restype = ctypes.c_uint64
            lib.mt_crc64.argtypes = [ctypes.c_char_p, ctypes.c_int]
            # bulk-build dictionary API
            lib.mt_dict_new.restype = ctypes.c_void_p
            lib.mt_dict_free.argtypes = [ctypes.c_void_p]
            lib.mt_dict_n_terms.restype = ctypes.c_int
            lib.mt_dict_n_terms.argtypes = [ctypes.c_void_p]
            lib.mt_dict_pool_len.restype = ctypes.c_int64
            lib.mt_dict_pool_len.argtypes = [ctypes.c_void_p]
            lib.mt_dict_export.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int64)]
            lib.mt_dict_tokenize.restype = ctypes.c_int
            lib.mt_dict_tokenize.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
            _LIB = lib
        except (OSError, subprocess.SubprocessError):
            _LIB = None
        return _LIB
