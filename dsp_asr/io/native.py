"""ctypes bindings for the native batch WAV loader (native/wavio.cpp).

The shared library is built on first use with g++ (cached next to this
file); everything degrades gracefully to the pure-Python loader in
dsp_asr/io/wav.py when no compiler is available, so the framework never
hard-depends on the native path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_LOCK = threading.Lock()
_LIB = None
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO, "native", "wavio.cpp")
_SO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_libwavio.so")


class NativeUnavailable(RuntimeError):
    pass


def _build() -> str:
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
           _SRC, "-o", _SO]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        detail = getattr(e, "stderr", str(e))
        raise NativeUnavailable(f"building libwavio failed: {detail}")
    return _SO


def get_lib():
    """Load (building if needed) the native library."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        so = _SO
        src_mtime = os.path.getmtime(_SRC) if os.path.exists(_SRC) else 0
        if not os.path.exists(so) or os.path.getmtime(so) < src_mtime:
            so = _build()
        lib = ctypes.CDLL(so)
        lib.dsp_decode_wav.restype = ctypes.c_int
        lib.dsp_decode_wav.argtypes = [
            ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.dsp_decode_wav_batch.restype = ctypes.c_int
        lib.dsp_decode_wav_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ]
        _LIB = lib
        return lib


def available() -> bool:
    try:
        get_lib()
        return True
    except (NativeUnavailable, OSError):
        # OSError: ctypes.CDLL on an incompatible/corrupt .so (different
        # arch/glibc than the prebuilt artifact) — degrade to the pure-
        # Python loader exactly like a missing library
        return False


def read_wav_batch(paths, target_sr: int = 16000, max_samples: int = 32000,
                   n_threads: int = 0):
    """Decode many WAVs at once -> (float32 [n, max_samples], lengths [n]).

    Failed files yield a zero row with length 0 (callers may assert
    ``(lengths > 0).all()``).
    """
    lib = get_lib()
    n = len(paths)
    out = np.zeros((n, max_samples), dtype=np.float32)
    lens = np.zeros(n, dtype=np.int64)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    failures = lib.dsp_decode_wav_batch(
        arr, n, target_sr,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_samples,
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n_threads,
    )
    return out, lens, failures


def read_wav_native(path: str, target_sr: int = 16000,
                    max_samples: int = 32000):
    """Single-file native decode -> (float32 [max_samples], length)."""
    lib = get_lib()
    out = np.zeros(max_samples, dtype=np.float32)
    length = ctypes.c_int64(0)
    rc = lib.dsp_decode_wav(
        path.encode(), target_sr,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_samples, ctypes.byref(length))
    if rc:
        raise IOError(f"native WAV decode failed ({rc}): {path}")
    return out, int(length.value)


def load_corpus_dir_native(root: str, target_sr: int = 16000,
                           max_samples: int = 32000, n_threads: int = 0):
    """Threaded corpus load: root/<label>/*.wav -> {label: [signals]}."""
    labels, paths, spans = [], [], []
    for label in sorted(os.listdir(root)):
        d = os.path.join(root, label)
        if not os.path.isdir(d):
            continue
        files = [os.path.join(d, f) for f in sorted(os.listdir(d))
                 if f.lower().endswith(".wav")]
        if files:
            spans.append((label, len(paths), len(paths) + len(files)))
            paths.extend(files)
    out, lens, failures = read_wav_batch(paths, target_sr, max_samples,
                                         n_threads)
    if failures:
        bad = [paths[i] for i in range(len(paths)) if lens[i] == 0]
        raise IOError(f"{failures} WAV files failed to decode: {bad[:5]}")
    corpus = {}
    for label, lo, hi in spans:
        corpus[label] = [out[i, : lens[i]] for i in range(lo, hi)]
    return corpus
