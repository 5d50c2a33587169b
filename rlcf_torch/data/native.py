"""ctypes binding of the repo's host C++ pipeline (``native/rlcf_host.cpp``):
the view generators and the JPEG/PNG decoder.

The port's own loader: it compiles the C++ source with ``g++`` into the
package's git-ignored build directory (``rlcf_torch/_build/``) at first use
and never writes into ``native/``. It builds the way ``native/Makefile``
prefers, with the codecs (``-DRLCF_WITH_CODECS -ljpeg -lpng``); where the
JPEG or PNG headers or libraries are missing it builds without them, and the
view generators still run. Each library's file name carries a hash of the
source and its flags, so a library built without codecs (or from another
source) is never loaded in place of the one asked for.

Two view generators are bound: the patch-major u8 one of the token path and
the NHWC u8 one of the NHWC path (``tta_cls --viewgen native`` with a policy
outside token mode or a reward ensemble), both from one seeded RNG stream;
and the decoder (``decode_rgb_native``, ``load_canonical_native``) with the
eval transform (``preprocess_native``). Unlike the JAX package, which decodes
with PIL when its library has no codecs, ``require_decoder`` raises there,
naming what the build missed: no run labelled native decodes with PIL.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG_DIR), "native", "rlcf_host.cpp")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_BUILD_LOCK = threading.Lock()
_BASE_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-shared", "-pthread")
CODEC_FLAGS, CODEC_LIBS = ("-DRLCF_WITH_CODECS",), ("-ljpeg", "-lpng")


def lib_path(codecs: bool, build_dir: str = None) -> str:
    """The library of this source built with or without the codecs (in
    ``build_dir``, default the package's): its name carries a hash of the
    source and the flags."""
    flags = _BASE_FLAGS + (CODEC_FLAGS + CODEC_LIBS if codecs else ())
    with open(_SRC, "rb") as fh:
        key = hashlib.sha256(fh.read() + " ".join(flags).encode()).hexdigest()[:16]
    return os.path.join(build_dir or _BUILD_DIR, f"librlcf_host_{'codecs' if codecs else 'plain'}_{key}.so")


def build(codecs: bool, build_dir: str = None):
    """Build (once) the library with or without the codecs: ``(path, None)``,
    or ``(None, what g++ reported missing)`` when it does not build."""
    if not os.path.exists(_SRC):
        raise RuntimeError(f"native source not found at {_SRC}")
    path = lib_path(codecs, build_dir)
    if os.path.exists(path):
        return path, None
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.build.{os.getpid()}.{threading.get_ident()}"
    cmd = ["g++", *_BASE_FLAGS, *(CODEC_FLAGS if codecs else ()), "-o", tmp, _SRC, *(CODEC_LIBS if codecs else ())]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, errors="replace")
        if res.returncode != 0:
            lines = [ln.strip() for ln in res.stderr.splitlines() if "error" in ln or "cannot find" in ln]
            return None, "; ".join(lines[-3:]) or res.stderr.strip()[-500:]
        os.replace(tmp, path)  # atomic: a concurrent build never loads a half-written file
        return path, None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _bind(path: str):
    lib = ctypes.CDLL(path)
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.rlcf_generate_views_batch_patch_u8.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_uint64,
        ctypes.c_int, u8p, ctypes.c_int, u8p, ctypes.c_int,
    ]
    lib.rlcf_generate_views_batch_patch_u8.restype = ctypes.c_int
    lib.rlcf_generate_views_batch_u8.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_uint64, u8p, ctypes.c_int,
    ]
    lib.rlcf_generate_views_batch_u8.restype = None
    lib.rlcf_preprocess_batch.argtypes = [u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p,
                                          ctypes.c_int]
    lib.rlcf_preprocess_batch.restype = None
    lib.rlcf_native_version.restype = ctypes.c_int
    if hasattr(lib, "rlcf_load_canonical"):
        intp = ctypes.POINTER(ctypes.c_int)
        lib.rlcf_decode_dims.argtypes = [ctypes.c_char_p, ctypes.c_long, intp, intp]
        lib.rlcf_decode_dims.restype = ctypes.c_int
        lib.rlcf_decode_rgb.argtypes = [ctypes.c_char_p, ctypes.c_long, u8p]
        lib.rlcf_decode_rgb.restype = ctypes.c_int
        lib.rlcf_load_canonical.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_int, u8p]
        lib.rlcf_load_canonical.restype = ctypes.c_int
    return lib


@functools.lru_cache()
def _load():
    """(the bound library, why it has no codecs or None): the codec build
    where it builds and loads (a machine may have the headers and libraries
    to link but not the shared libraries to run it), else the codec-free one."""
    with _BUILD_LOCK:
        path, missing = build(codecs=True)
        if path is not None:
            try:
                return _bind(path), None
            except OSError as exc:   # a codec library the loader cannot find
                missing = str(exc)
        path, error = build(codecs=False)
        if path is None:
            raise RuntimeError(f"g++ failed to build {_SRC}: {error}")
    return _bind(path), missing


def _lib():
    return _load()[0]


def available() -> bool:
    """True when the host pipeline builds and loads (raises nothing)."""
    try:
        return _lib().rlcf_native_version() >= 1
    except Exception:
        return False


def generate_views_native_u8(
    images: np.ndarray,
    n_views: int,
    resolution: int = 224,
    augmix: bool = True,
    severity: float = 1.0,
    crop_min: float = 0.08,
    seed: int = 0,
    n_threads: int = 0,
) -> np.ndarray:
    """[N, H, W, 3] u8 -> NHWC u8 views [N, V, R, R, 3], the views of
    ``generate_views_native_patch_u8`` for the same seed (the same views as
    ``rlcf_tpu``'s binding), normalized on the device by the classifier."""
    images = np.ascontiguousarray(images, dtype=np.uint8)
    n, h, w, _ = images.shape
    out = np.empty((n, n_views, resolution, resolution, 3), np.uint8)
    _lib().rlcf_generate_views_batch_u8(
        images, n, h, w, n_views, resolution, int(augmix), float(severity), float(crop_min),
        np.uint64(seed), out, n_threads,
    )
    return out


def generate_views_native_patch_u8(
    images: np.ndarray,
    n_views: int,
    p_policy: int,
    p_reward: int = 0,
    resolution: int = 224,
    augmix: bool = True,
    severity: float = 1.0,
    crop_min: float = 0.08,
    seed: int = 0,
    n_threads: int = 0,
):
    """[N, H, W, 3] u8 -> patch-major u8 views [N, V, (R/p)^2, p^2*3].

    View 0 is the resized source, views 1.. RandomResizedCrop + flip +
    AugMix, from one seeded RNG stream (the same views as ``rlcf_tpu``'s
    binding for the same seed). With ``p_reward`` the same views also come
    back patchified at the reward's patch size, as a pair.
    """
    if resolution % p_policy or (p_reward and resolution % p_reward):
        raise ValueError(
            f"patch sizes must tile the resolution exactly: {resolution} vs "
            f"policy {p_policy}" + (f", reward {p_reward}" if p_reward else "")
        )
    images = np.ascontiguousarray(images, dtype=np.uint8)
    n, h, w, _ = images.shape
    out1 = np.empty((n, n_views, (resolution // p_policy) ** 2, p_policy * p_policy * 3), np.uint8)
    if p_reward:
        out2 = np.empty((n, n_views, (resolution // p_reward) ** 2, p_reward * p_reward * 3), np.uint8)
    else:
        out2 = out1  # dummy buffer; p2=0 disables the second output in C++
    rc = _lib().rlcf_generate_views_batch_patch_u8(
        images, n, h, w, n_views, resolution, int(augmix), float(severity), float(crop_min),
        np.uint64(seed), p_policy, out1, p_reward, out2, n_threads,
    )
    if rc != 0:
        raise ValueError("native patch view generation rejected the patch/resolution combination")
    return (out1, out2) if p_reward else out1


def decode_available() -> bool:
    """True when the library carries the JPEG/PNG decoder (raises nothing)."""
    try:
        return hasattr(_lib(), "rlcf_load_canonical")
    except Exception:
        return False


def require_decoder():
    """Build (once) and check the decoder; raises when the library was built
    without its codecs, naming what was missing (to compile, link or load)."""
    lib, missing = _load()
    if not hasattr(lib, "rlcf_load_canonical"):
        raise RuntimeError("--decode native: the host library (native/rlcf_host.cpp) was built without its JPEG/PNG "
                           f"codecs; the codec build ({' '.join(CODEC_FLAGS + CODEC_LIBS)}) needs jpeglib.h and png.h "
                           f"to compile and libjpeg and libpng to link and load, and here: {missing}. Use --decode pil")


def decode_rgb_native(data: bytes):
    """Decode JPEG/PNG bytes to a full-size u8 HWC RGB array, or None for an
    unsupported container or colorspace or a corrupt file (the caller then
    decodes that file with PIL, as the JAX package does)."""
    lib = _lib()
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.rlcf_decode_dims(data, len(data), ctypes.byref(h), ctypes.byref(w)) != 0:
        return None
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.rlcf_decode_rgb(data, len(data), out) != 0:
        return None
    return out


def load_canonical_native(data: bytes, size: int):
    """Decode + bicubic short-side resize + center crop -> [size, size, 3] u8
    in one call that releases the GIL (a thread pool decodes in parallel), or
    None where ``decode_rgb_native`` gives None."""
    out = np.empty((size, size, 3), np.uint8)
    if _lib().rlcf_load_canonical(data, len(data), size, out) != 0:
        return None
    return out


def preprocess_native(images: np.ndarray, resolution: int = 224, n_threads: int = 0) -> np.ndarray:
    """The eval transform for a u8 batch [N, H, W, 3] -> CLIP-normalized
    float32 [N, R, R, 3] (short-side resize, center crop)."""
    images = np.ascontiguousarray(images, dtype=np.uint8)
    n, h, w, _ = images.shape
    out = np.empty((n, resolution, resolution, 3), np.float32)
    _lib().rlcf_preprocess_batch(images, n, h, w, resolution, out, n_threads)
    return out
