"""``rlcf_torch.cli.extract_features`` and ``rlcf_torch.cli.train_caption``
(``--device cpu``) against the JAX package's CLIs on one synthetic
COCO-caption tree, the same CLIP checkpoint (OpenAI format), OPT checkpoint
(HF format, a 600-entry vocabulary so that every caption id has a row) and
vocabulary files: the extraction's tokens and masks equal and embeddings
within 1e-5 (fp32; one npz and a sharded store), and training runs from the
same mapper (``--resume`` with a checkpoint of epoch -1) whose per-epoch
losses agree within rtol 1e-5 and checkpoints within 3e-5. Then the bf16
chain (C8): the JAX trainer cannot read the JAX extraction's bf16 file and
the port's trainer can; either trainer reads the port's float32 file. The
refusals, ``--dry_run``, ``--synthetic`` and the card check run the port alone."""

import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from rlcf_tpu.cli import extract_features as jax_extract
from rlcf_tpu.cli import train_caption as jax_train
from rlcf_tpu.models import opt as JO
from rlcf_torch.cli import extract_features, train_caption
from rlcf_torch.core import policy as Po
from rlcf_torch.data.sharded_embeddings import ShardedEmbeddings
from rlcf_torch.models import mappers as TM
from rlcf_torch.models import opt as TO
from rlcf_torch.tasks import caption as Cap
from torch_port_fixtures import chip_smoke, hf_opt_state_dict, openai_state_dict, tiny_cfgs
from torch_port_fixtures import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(autouse=True)
def tiny_opt_heads(monkeypatch):
    """The tiny OPT's hidden width (32) is no released size: 2 heads, in both packages."""
    monkeypatch.setitem(JO._OPT_N_HEADS, 32, 2)
    monkeypatch.setitem(TO._OPT_N_HEADS, 32, 2)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The tree (4 images x 3 captions), the vocabulary, the CLIP and OPT
    checkpoints, and the extraction argv of either CLI."""
    root = tmp_path_factory.mktemp("train_caption")
    ann, images = chip_smoke.write_caption_tree(str(root / "coco"), 4, caps_per_image=3, size=(40, 56))
    vocab, merges = chip_smoke.write_opt_vocab(str(root / "vocab"), size=600, newline_id=None)
    torch.save(openai_state_dict(tiny_cfgs()[1]), str(root / "clip.pt"))
    torch.save({k: torch.from_numpy(v) for k, v in hf_opt_state_dict(proj=False, V=600).items()}, str(root / "opt.pt"))
    extract = lambda out, precision="fp32", *extra: [
        "--annotations", ann, "--images_root", images, "--arch", "test-small", "--clip_checkpoint",
        str(root / "clip.pt"), "--precision", precision, "--resolution", "32", "--opt_vocab", vocab,
        "--opt_merges", merges, "--prefix_length", "4", "--token_len", "8", "--out", out, *extra]
    return {"root": root, "extract": extract}


@pytest.fixture(scope="module")
def extracted(tree):
    """Both CLIs' fp32 extractions, one npz and a sharded store (shards of 5 captions) each."""
    root, out = tree["root"], {}
    for name, main, extra in (("jax", jax_extract.main, ()), ("port", extract_features.main, ("--device", "cpu"))):
        main(tree["extract"](str(root / f"{name}.npz"), "fp32", *extra))
        main(tree["extract"](str(root / f"{name}_sharded.npz"), "fp32", "--shard_size", "5", *extra))
        out[name] = str(root / f"{name}.npz"), str(root / f"{name}_sharded.npz")
    return out


def _assert_same_arrays(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        if want[key].dtype.kind == "f":
            assert got[key].dtype == np.float32
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-5, err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_extract_npz_matches_jax(extracted):
    """Tokens, masks, captions and image names equal; both embeddings within 1e-5."""
    load = lambda path: dict(np.load(path, allow_pickle=True))
    got, want = load(extracted["port"][0]), load(extracted["jax"][0])
    _assert_same_arrays(got, want)
    assert got["tokens"].shape == (12, 8) and got["mask"].shape == (12, 12) and got["image_embeddings"].shape[0] == 12


def test_extract_sharded_matches_jax(extracted):
    """The same manifest counts and keys, each shard's arrays as the JAX
    store's (an image whose captions straddle a shard is encoded in both)."""
    got, want = ShardedEmbeddings(extracted["port"][1]), ShardedEmbeddings(extracted["jax"][1])
    assert got.counts == want.counts == [5, 5, 2] and got.keys == want.keys
    for i in range(len(got.counts)):
        _assert_same_arrays(dict(got.load_shard(i)), dict(want.load_shard(i)))


def _train_argv(root, emb, out, cap_model, kind, normalize, resume, epochs=2, *extra):
    return ["--embeddings", emb, "--cap_model", cap_model, "--noise_variance", "0", "--normalize_prefix",
            str(normalize), "--mapping_type", kind, "--llm", "test-tiny-opt", "--opt_checkpoint",
            str(root / "opt.pt"), "--prefix_length", "4", "--clip_length", "2", "--epochs",
            str(epochs), "--train_batch_size", "4", "--train_lr", "1e-3", "--warmup_steps", "2", "--resume", resume,
            "--output", out, *extra]


def _start_mapper(root, kind, epoch):
    """A mapper checkpoint at ``epoch`` of the tiny model both CLIs build (``--resume`` starts after it)."""
    path = str(root / f"start_{kind}_{epoch}.npz")
    mcfg = TM.MapperConfig(kind, clip_dim=16, llm_dim=32, prefix_length=4, clip_length=2)
    Cap.save_mapper_checkpoint(path, TM.init_mapper_params(mcfg, seed=3), epoch=epoch)
    return path, mcfg


@pytest.mark.parametrize("cap_model,kind,normalize,store,epoch", [
    ("CapDec", "mlp", 0, "npz", -1), ("ClipCap", "transformer", 1, "sharded", -1), ("ClipCap", "mlp", 0, "npz", 0)])
def test_train_matches_jax(tree, extracted, cap_model, kind, normalize, store, epoch):
    """From the JAX extraction: CapDec with --noise_variance 0 (the text
    embeddings, untouched), ClipCap with --normalize_prefix 1 on the sharded
    store (image embeddings, the shard-order shuffle), and --resume after
    epoch 0 (the last epoch of two only; the optimizer and the schedule
    start afresh in both). Losses within rtol 1e-5, each checkpoint within 3e-5."""
    root = tree["root"]
    emb = extracted["jax"][0 if store == "npz" else 1]
    start, mcfg = _start_mapper(root, kind, epoch)
    tag = f"{cap_model}_{kind}_{store}_{epoch}"
    want = jax_train.main(_train_argv(root, emb, str(root / f"jax_{tag}"), cap_model, kind, normalize, start))
    got = train_caption.main(_train_argv(root, emb, str(root / f"port_{tag}"), cap_model, kind, normalize, start, 2,
                                         "--device", "cpu"))
    assert len(got) == len(want) == 1 - epoch
    np.testing.assert_allclose(got, want, rtol=1e-5)
    names = sorted(os.listdir(root / f"jax_{tag}"))
    assert names == sorted(os.listdir(root / f"port_{tag}"))
    assert [n for n in names if n.startswith("ckpt")] == [f"ckpt-{e:03d}.npz" for e in range(epoch + 1, 2)] + \
        ["ckpt-latest.npz"]
    template = TM.init_mapper_params(mcfg)
    for name in (n for n in names if n.startswith("ckpt")):
        (w, we), (g, ge) = (Cap.load_mapper_checkpoint(str(root / f"{pkg}_{tag}" / name), template)
                            for pkg in ("jax", "port"))
        assert ge == we
        for a, b in zip(Po.tree_leaves(g), Po.tree_leaves(w)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=3e-5, err_msg=name)


def test_bf16_chain_c8(tree, tmp_path):
    """The JAX extraction at its default bf16 writes embeddings ``np.load``
    reads as ``|V2``: the JAX trainer raises on them; the port's trainer
    reads them as bf16 (exactly the values ml_dtypes decodes). The port's
    bf16 extraction writes float32, which both trainers take."""
    jax_file, port_file = str(tmp_path / "jax_bf16.npz"), str(tmp_path / "port_bf16.npz")
    jax_extract.main(tree["extract"](jax_file, "bf16"))
    extract_features.main(tree["extract"](port_file, "bf16", "--device", "cpu"))
    raw = np.load(jax_file)["text_embeddings"]
    assert raw.dtype.kind == "V" and raw.dtype.itemsize == 2
    np.testing.assert_array_equal(train_caption.as_float32(raw), raw.view(ml_dtypes.bfloat16).astype(np.float32))
    assert np.load(port_file)["text_embeddings"].dtype == np.float32
    start, _ = _start_mapper(tree["root"], "mlp", -1)
    argv = lambda emb, out: _train_argv(tree["root"], emb, str(tmp_path / out), "CapDec", "mlp", 0, start, 1)
    with pytest.raises(TypeError):
        jax_train.main(argv(jax_file, "jax_on_jax"))
    runs = [train_caption.main(argv(jax_file, "port_on_jax") + ["--device", "cpu"]),
            jax_train.main(argv(port_file, "jax_on_port")),
            train_caption.main(argv(port_file, "port_on_port") + ["--device", "cpu"])]
    assert all(len(r) == 1 and np.isfinite(r[0]) for r in runs)
    np.testing.assert_allclose(runs[2], runs[1], rtol=1e-5)


def test_train_synthetic_and_capdec_noise(tmp_path):
    """``--synthetic`` (the JAX CLI's tiny set) with CapDec's noise drawn
    from ``--seed``: finite losses, the same on a rerun, the checkpoints written."""
    argv = lambda out: ["--synthetic", "--epochs", "2", "--train_batch_size", "16", "--warmup_steps", "1",
                        "--seed", "3", "--device", "cpu", "--output", str(tmp_path / out)]
    first, again = train_caption.main(argv("a")), train_caption.main(argv("b"))
    assert first == again and len(first) == 2 and np.isfinite(first).all()
    assert sorted(os.listdir(tmp_path / "a")) == ["ckpt-000.npz", "ckpt-001.npz", "ckpt-latest.npz",
                                                  "hparams_caption_train.json"]


@pytest.mark.parametrize("cli,flags,item", [
    ("extract", ["--download", "1"], "A15"),
    ("train", ["--download", "1"], "A15")])
def test_refusals(tree, monkeypatch, cli, flags, item):
    """Each refusal comes before any model loads."""
    from rlcf_torch.cli import common

    monkeypatch.setattr(common, "load_policy", lambda *a, **k: pytest.fail("a model loaded before the refusal"))
    monkeypatch.setattr(Cap, "init_caption_params", lambda *a, **k: pytest.fail("a model built before the refusal"))
    argv = tree["extract"]("unused.npz") if cli == "extract" else ["--synthetic"]
    with pytest.raises(SystemExit, match=item):
        (extract_features if cli == "extract" else train_caption).main(argv + flags + ["--device", "cpu"])


def test_dry_run(capsys):
    assert extract_features.main(["--annotations", "a.json", "--out", "f.npz", "--shard_size", "7", "--dry_run"]) is None
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line[len("DRY RUN OK: "):])["shard_size"] == 7
    assert train_caption.main(["--synthetic", "--dry_run", "--warmup_steps", "3"]) is None
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("DRY RUN OK: ") and json.loads(line[len("DRY RUN OK: "):])["warmup_steps"] == 3


def test_cuda_without_a_card_raises(tree, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        extract_features.main(tree["extract"](str(tmp_path / "f.npz")))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_caption.main(["--synthetic", "--output", str(tmp_path)])
