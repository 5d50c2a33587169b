"""ctypes binding of the repo's host C++ view pipeline (``native/rlcf_host.cpp``).

The port's own loader: it compiles the C++ source with ``g++`` into the
package's git-ignored build directory (``rlcf_torch/_build/``) at first use
and never writes into ``native/``. Two view generators are bound: the
patch-major u8 one of the token path and the NHWC u8 one of the NHWC path
(``tta_cls --viewgen native`` with a policy outside token mode or a reward
ensemble), both from one seeded RNG stream.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import threading

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG_DIR), "native", "rlcf_host.cpp")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "librlcf_host.so")
_BUILD_LOCK = threading.Lock()


def _build():
    if not os.path.exists(_SRC):
        raise RuntimeError(f"native source not found at {_SRC}")
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB_PATH}.build.{os.getpid()}"
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-fPIC", "-shared", "-pthread", "-o", tmp, _SRC]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed to build {_SRC}:\n{res.stderr[-4000:]}")
        os.replace(tmp, _LIB_PATH)  # atomic: a concurrent build never loads a half-written file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


@functools.lru_cache()
def _lib():
    with _BUILD_LOCK:
        if not os.path.exists(_LIB_PATH) or os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC):
            _build()
    lib = ctypes.CDLL(_LIB_PATH)
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
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
    lib.rlcf_native_version.restype = ctypes.c_int
    return lib


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
