"""The port's binding of the native JPEG/PNG decoder (``rlcf_torch/data/native.py``)
and its callers (``data/transforms.py``, ``data/datasets.py``, the image CLIs),
as ``tests/test_native_decode.py`` holds the JAX package's: against PIL (PNG
bit-exact, JPEG within the IDCT builds' 2 gray levels, the canonical square
within the resize kernels' tolerance) and against ``rlcf_tpu.data.native``
on the same bytes (equal: one C++ source). Also what the port does on
purpose otherwise: a library built without its codecs is refused loudly,
never decoded with PIL under the native name."""

import io
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from rlcf_tpu.data import native as jnative
from rlcf_torch.data import native, transforms
from rlcf_torch.data.datasets import iter_canonical

from torch_port_fixtures import write_fine_grained_tree


@pytest.fixture(scope="module", autouse=True)
def decoders():
    """The port's decoder builds here (the codec headers and libraries are
    installed); the JAX package's library is built with them too."""
    native.require_decoder()
    assert jnative.decode_available()


def _rand_img(h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _encode(img, fmt, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format=fmt, **kw)
    return buf.getvalue()


def _both(data):
    """The port's and the JAX package's decode of the same bytes, held equal."""
    got, want = native.decode_rgb_native(data), jnative.decode_rgb_native(data)
    assert (got is None) == (want is None)
    if got is not None:
        np.testing.assert_array_equal(got, want)
    return got


def _pil(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _bomb(seed, side):
    data = bytearray(_encode(_rand_img(8, 8, seed=seed), "PNG"))
    data[16:24] = struct.pack(">II", side, side)  # IHDR width, height
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])) & 0xFFFFFFFF)
    return bytes(data)


def test_png_decode_bit_exact():
    img = _rand_img(123, 77, seed=1)
    np.testing.assert_array_equal(_both(_encode(img, "PNG")), img)


def test_jpeg_decode_matches_pil():
    data = _encode(_rand_img(200, 317, seed=2), "JPEG", quality=92)
    assert np.abs(_both(data).astype(int) - _pil(data).astype(int)).max() <= 2


def test_grayscale_jpeg_and_palette_png():
    gray = np.random.default_rng(3).integers(0, 256, (64, 48), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(gray, mode="L").save(buf, format="JPEG", quality=95)
    data = buf.getvalue()
    assert np.abs(_both(data).astype(int) - _pil(data).astype(int)).max() <= 2
    buf = io.BytesIO()
    Image.fromarray(_rand_img(40, 52, seed=4)).convert("P", palette=Image.ADAPTIVE).save(buf, format="PNG")
    np.testing.assert_array_equal(_both(buf.getvalue()), _pil(buf.getvalue()))


def test_rgba_png_drops_alpha_like_pil():
    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(5).integers(0, 256, (33, 47, 4), dtype=np.uint8), mode="RGBA").save(
        buf, format="PNG")
    np.testing.assert_array_equal(_both(buf.getvalue()), _pil(buf.getvalue()))


def test_gamma_tagged_png_matches_pil():
    """PIL ignores gAMA; the decoder does too."""
    img = _rand_img(30, 44, seed=11)
    data = _encode(img, "PNG")
    chunk = struct.pack(">I", 4) + b"gAMA" + struct.pack(">I", 100000)
    chunk += struct.pack(">I", zlib.crc32(b"gAMA" + struct.pack(">I", 100000)) & 0xFFFFFFFF)
    tagged = data[:33] + chunk + data[33:]
    np.testing.assert_array_equal(_pil(tagged), img)
    np.testing.assert_array_equal(_both(tagged), img)


def test_unsupported_and_bomb_headers_refused():
    assert _both(b"\x00\x01not an image") is None
    assert native.load_canonical_native(b"GIF89a....", 64) is None
    assert _both(_bomb(13, 60000)) is None
    assert native.load_canonical_native(_bomb(12, 65000), 64) is None


def test_truncated_and_cmyk_jpeg_go_to_pil_and_are_counted(tmp_path):
    img = _rand_img(40, 50, seed=9)
    data = _encode(img, "JPEG", quality=90)
    assert _both(data[: len(data) // 2]) is None   # libjpeg would gray-pad it; PIL raises
    cmyk = tmp_path / "cmyk.jpg"
    Image.fromarray(img).convert("CMYK").save(cmyk, format="JPEG", quality=90)
    assert _both(cmyk.read_bytes()) is None
    png = tmp_path / "a.png"
    Image.fromarray(img).save(png)
    transforms.DECODE_COUNTS.clear()
    out = transforms.preprocess_many([str(cmyk), str(png), img], 32, decode="native", workers=2)
    np.testing.assert_array_equal(out[0], transforms.preprocess_pil(str(cmyk), 32))
    np.testing.assert_array_equal(out[2], transforms.preprocess_pil(img, 32))
    assert dict(transforms.DECODE_COUNTS) == {"native": 1, "pil": 2}


@pytest.mark.parametrize("shape", [(300, 500), (500, 300), (256, 256), (97, 311)])
def test_load_canonical_matches_pil_two_step(shape, tmp_path):
    img = _rand_img(*shape, seed=shape[0])
    data = _encode(img, "PNG")   # lossless: only the resize differs
    can = native.load_canonical_native(data, 128)
    np.testing.assert_array_equal(can, jnative.load_canonical_native(data, 128))
    ref = transforms.center_crop(transforms.resize_short_side_pil(img, 128), 128)
    d = np.abs(can.astype(int) - ref.astype(int))
    assert can.shape == ref.shape == (128, 128, 3) and d.mean() < 1.0 and (d > 8).mean() < 2e-3
    path = tmp_path / "x.png"
    path.write_bytes(data)
    np.testing.assert_array_equal(transforms.load_canonical(str(path), 128), can)
    np.testing.assert_array_equal(native.preprocess_native(img[None], 64), jnative.preprocess_native(img[None], 64))


def _image_folder(root, n_per_class=3):
    rng = np.random.default_rng(0)
    k = 0
    for cls in ("alpha", "beta"):
        os.makedirs(os.path.join(root, cls))
        for i in range(n_per_class):
            img = rng.integers(0, 256, (90 + 7 * k, 120 - 5 * k, 3), dtype=np.uint8)
            fmt, ext = ("JPEG", ".jpg") if k % 2 == 0 else ("PNG", ".png")
            Image.fromarray(img).save(os.path.join(root, cls, f"im{i}{ext}"), format=fmt)
            k += 1


def test_iter_canonical_and_iter_batches_native(tmp_path):
    """The same order and labels as PIL's, images within a gray level on
    average, and equal to the JAX package's native iterators."""
    from rlcf_tpu.data import datasets as JD
    from rlcf_torch.data import datasets as TD

    _image_folder(str(tmp_path))
    ds, jds = TD.ImageFolderDataset(str(tmp_path)), JD.ImageFolderDataset(str(tmp_path))
    pil = list(TD.iter_canonical(ds, 64, seed=3, decode="pil"))
    nat = list(TD.iter_canonical(ds, 64, seed=3, decode="native", workers=3))
    jnat = list(JD.iter_canonical(jds, 64, seed=3, decode="native", workers=3))
    assert [l for _, l in pil] == [l for _, l in nat] == [l for _, l in jnat]
    for (a, _), (b, _), (c, _) in zip(pil, nat, jnat):
        assert np.abs(a.astype(int) - b.astype(int)).mean() < 1.0
        np.testing.assert_array_equal(b, c)
    pil = list(TD.iter_batches(ds, batch_size=4, resolution=48, seed=1))
    nat = list(TD.iter_batches(ds, batch_size=4, resolution=48, seed=1, decode="native", workers=2))
    jnat = list(JD.iter_batches(jds, batch_size=4, resolution=48, seed=1, decode="native", workers=2))
    assert len(pil) == len(nat) == len(jnat) == 2
    for (ia, la), (ib, lb), (ic, lc) in zip(pil, nat, jnat):
        np.testing.assert_array_equal(la, lb)
        np.testing.assert_array_equal(lb, lc)
        assert np.abs(ia - ib).mean() < 0.015   # 1 gray ~ 0.015 normalized
        np.testing.assert_array_equal(ib, ic)
    synthetic = list(TD.iter_canonical(TD.SyntheticDataset(n=5, size=96), 64, decode="native", workers=2))
    assert len(synthetic) == 5 and synthetic[0][0].shape == (64, 64, 3)


@pytest.mark.parametrize("cli,extra", [
    ("tta_cls", []), ("tune_cls", []), ("zero_shot", []),
    ("tta_retrieval", ["--annotations", "x.json", "--vis_root", "y"]), ("tta_caption", []),
    ("extract_features", ["--annotations", "x.json", "--out", "o.npz"]), ("clipscore_eval", ["c.json", "imgs"]),
])
def test_every_image_cli_takes_the_decode_flags(cli, extra):
    import importlib

    args = importlib.import_module(f"rlcf_torch.cli.{cli}").get_args(extra + ["--decode", "native", "--decode_workers",
                                                                              "3"])
    assert args.decode == "native" and args.decode_workers == 3


@pytest.mark.parametrize("cli", ["tta_cls", "zero_shot"])
def test_cli_runs_native_decode(tmp_path, capsys, cli):
    """A fine-grained tree's JPEGs through ``--decode native``: every image
    decoded natively, the count printed once."""
    import importlib

    write_fine_grained_tree(tmp_path / "data", "cars", n_classes=2, per_class=2)
    argv = [str(tmp_path / "data"), "--device", "cpu", "--test_sets", "cars", "--limit", "4", "--arch", "test-small",
            "--resolution", "64", "--precision", "fp32", "--output", str(tmp_path / "out"), "--decode", "native",
            "--decode_workers", "2"]
    argv += ["--batch_size", "2"] if cli == "zero_shot" else [
        "--reward_arch", "test-small", "--batch_size", "4", "--tta_steps", "1", "--sample_k", "2", "--episode_group",
        "2", "--viewgen", "fused"]
    r = importlib.import_module(f"rlcf_torch.cli.{cli}").main(argv)["cars"]
    assert 0 <= r["top1"] <= r["top5"] <= 100
    assert "decode native: 4 images by the native decoder, 0 by PIL" in capsys.readouterr().out


@pytest.mark.parametrize("missing", ["to build", "to load"])
def test_codec_free_build_is_refused(tmp_path, monkeypatch, missing):
    """A library without its codecs (a codec library that does not exist at
    link time, or one that links but whose shared library the loader cannot
    find) runs the view generators, and ``--decode native`` raises, naming
    what was missed, before any model loads; nothing is decoded with PIL
    under the native name."""
    from rlcf_torch.cli import common, zero_shot

    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path / "build"))
    if missing == "to build":
        monkeypatch.setattr(native, "CODEC_LIBS", ("-ljpeg", "-lrlcf_missing_codec"))
    else:
        bind = native._bind

        def unloadable(path):
            if "codecs" in os.path.basename(path):
                raise OSError("librlcf_missing_codec.so: cannot open shared object file")
            return bind(path)

        monkeypatch.setattr(native, "_bind", unloadable)
    native._load.cache_clear()
    try:
        assert native.available() and not native.decode_available()
        assert os.path.basename(native.lib_path(False)) in os.listdir(tmp_path / "build")
        with pytest.raises(RuntimeError, match="built without its JPEG/PNG codecs.*rlcf_missing_codec"):
            transforms.preprocess_many([str(tmp_path)], 32, decode="native")
        monkeypatch.setattr(common, "load_policy", lambda *a, **k: pytest.fail("a model loaded before the refusal"))
        with pytest.raises(RuntimeError, match="rlcf_missing_codec"):
            zero_shot.main(["--device", "cpu", "--test_sets", "synthetic", "--decode", "native"])
        with pytest.raises(RuntimeError, match="without its JPEG/PNG codecs"):
            list(iter_canonical([], decode="native"))
    finally:
        native._load.cache_clear()
