"""``rlcf_torch.cli.tta_caption --device cpu`` against ``rlcf_tpu.cli.tta_caption``
on one synthetic COCO-caption tree: the same OPT (an HF-format checkpoint),
mapper (a ClipCap-format checkpoint), CLIP towers (OpenAI-format
checkpoints) and vocabulary files, so ``results_caption.json`` and
``results_clipscore.json`` must be equal. The image ids of ``--dataset_mode``
1 and 2, the ``--synthetic`` run, the refusals and ``--dry_run`` run the port
alone."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from rlcf_tpu.models import mappers as JM
from rlcf_tpu.models import opt as JO
from rlcf_torch.cli import tta_caption
from rlcf_torch.models import opt as TO
from torch_port_fixtures import chip_smoke, hf_mapper_state_dict, hf_opt_state_dict, openai_state_dict, tiny_cfgs
from torch_port_fixtures import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The eval tree, the checkpoints and the vocabulary, and the JAX CLI's
    results on them (``--dataset_mode 0``)."""
    root = tmp_path_factory.mktemp("caption")
    ann, images = chip_smoke.write_caption_tree(str(root / "coco"), 2, caps_per_image=2, size=(40, 56))
    vocab, merges = chip_smoke.write_opt_vocab(str(root / "vocab"), size=600, newline_id=None)
    opt_sd = hf_opt_state_dict(proj=False)
    opt_sd["model.decoder.embed_tokens.weight"] *= 2.0   # peaked enough that the beams rank clearly apart
    torch.save({k: torch.from_numpy(v) for k, v in opt_sd.items()}, str(root / "opt.pt"))
    mcfg = JM.MapperConfig("transformer", clip_dim=16, llm_dim=32, prefix_length=4, clip_length=2)
    torch.save({k: torch.from_numpy(v) for k, v in hf_mapper_state_dict(mcfg).items()}, str(root / "mapper.pt"))
    clip_cfg = tiny_cfgs()[1]
    for name, seed in (("feature", 0), ("reward", 1)):
        torch.save(openai_state_dict(clip_cfg, seed=seed), str(root / f"{name}.pt"))
    argv = lambda out, mode="0", annotations=ann: [
        "--annotations", annotations, "--images_root", images, "--dataset_mode", mode, "--llm", "test-tiny-opt",
        "--opt_checkpoint", str(root / "opt.pt"), "--checkpoint", str(root / "mapper.pt"),
        "--opt_vocab", vocab, "--opt_merges", merges, "--clip_model_type", "test-small",
        "--clip_checkpoint", str(root / "feature.pt"), "--reward_arch", "test-small",
        "--reward_checkpoint", str(root / "reward.pt"), "--precision", "fp32", "--resolution", "32",
        "--tta_steps", "2", "--sample_k", "3", "--tta_lr", "1e-2", "--prefix_length", "4", "--clip_length", "2",
        "--episode_group", "2", "--output", out]
    from rlcf_tpu.cli import tta_caption as jax_cli

    with pytest.MonkeyPatch.context() as mp:   # the tiny hidden width (32) is no released OPT size
        mp.setitem(JO._OPT_N_HEADS, 32, 2)
        jax_cli.main(argv(str(root / "jax")))
    return {"root": root, "argv": argv, "want": _read(str(root / "jax")), "images": images}


def _read(out):
    with open(os.path.join(out, "results_caption.json")) as fh, \
            open(os.path.join(out, "results_clipscore.json")) as fh2:
        return json.load(fh), json.load(fh2)


def test_cli_matches_jax(tree, monkeypatch):
    monkeypatch.setitem(TO._OPT_N_HEADS, 32, 2)
    out = str(tree["root"] / "port0")
    result = tta_caption.main(tree["argv"](out) + ["--device", "cpu"])
    got = _read(out)
    assert got == tree["want"]
    assert result["results"] == got[0] and len(result["group_seconds"]) == 1
    assert [r["image_id"] for r in got[0]] == [1000, 1007]
    assert list(got[1]) == ["COCO_val2014_000000001000.jpg", "COCO_val2014_000000001007.jpg"]
    assert len({r["caption"] for r in got[0]}) == 2
    with open(os.path.join(out, "caption_trace.txt")) as fh:
        trace = fh.read()
    assert trace.count("FINAL:") == 2 and trace.count("] ") == 2 * 2 * 3   # 2 steps x 2 images x 3 samples


@pytest.mark.parametrize("mode", ["1", "2"])
def test_cli_dataset_mode_ids(tree, monkeypatch, mode):
    """Flickr30k (1) takes the numeric stem, NoCaps (2) the annotation's
    image_id (`caption/image_llm/datasets/coco_cap.py:239-289`); the captions
    are the JAX CLI's of the same images."""
    monkeypatch.setitem(TO._OPT_N_HEADS, 32, 2)
    root = tree["root"]
    with open(root / "coco" / "annotations.json") as fh:
        ann = json.load(fh)
    if mode == "1":   # the same images under Flickr's numeric names
        os.makedirs(os.path.join(tree["images"], "flickr"), exist_ok=True)
        for a in ann:
            rel = f"flickr/{a['image_id'] * 3}.jpg"
            shutil.copy(os.path.join(tree["images"], a["image"]), os.path.join(tree["images"], rel))
            a["image"] = rel
    path = str(root / f"ann{mode}.json")
    with open(path, "w") as fh:
        json.dump(ann, fh)
    out = str(root / f"port{mode}")
    tta_caption.main(tree["argv"](out, mode, path) + ["--device", "cpu"])
    results, per_image = _read(out)
    want = [3000, 3021] if mode == "1" else [1000, 1007]
    assert [r["image_id"] for r in results] == want
    assert list(per_image) == [os.path.basename(a["image"]) for a in ann]
    assert [r["caption"] for r in results] == [r["caption"] for r in tree["want"][0]]


def test_cli_synthetic(tmp_path):
    out = tta_caption.main(["--synthetic", "--limit", "3", "--tta_steps", "1", "--sample_k", "2", "--episode_group", "2",
                            "--clip_model_type", "test-small", "--reward_arch", "test-small", "--precision", "fp32",
                            "--resolution", "64", "--device", "cpu", "--output", str(tmp_path)])
    assert [r["image_id"] for r in out["results"]] == ["synthetic_0", "synthetic_1", "synthetic_2"]
    assert len(out["group_seconds"]) == 2
    for name in ("results_caption.json", "results_clipscore.json", "caption_trace.txt", "hparams_caption.json"):
        assert (tmp_path / name).exists()


@pytest.mark.parametrize("flags,item", [
    (["--tp", "2"], "A14"), (["--dp", "2"], "A14"), (["--download", "1"], "A15"),
    (["--multiple_reward_models", "1"], "one reward CLIP"),
])
def test_cli_refusals(flags, item, monkeypatch):
    """Each refusal comes before any model loads. --dp and --tp (ROADMAP A14)
    are ported: in a single process the mesh's error names the launcher."""
    from rlcf_torch.cli import common

    monkeypatch.setattr(common, "load_policy", lambda *a, **k: pytest.fail("a model loaded before the refusal"))
    if item == "A14":
        with pytest.raises(ValueError, match="torchrun"):
            tta_caption.main(["--synthetic", "--device", "cpu", *flags])
        return
    with pytest.raises(SystemExit, match=item):
        tta_caption.main(["--synthetic", "--device", "cpu", *flags])


def test_cli_needs_a_card_unless_told_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tta_caption.main(["--synthetic", "--output", str(tmp_path)])


def test_cli_dry_run(capsys):
    assert tta_caption.main(["--synthetic", "--dry_run", "--decode_seg_len", "0"]) is None
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("DRY RUN OK: ") and json.loads(line[len("DRY RUN OK: "):])["decode_seg_len"] == 0
    assert np.isclose(json.loads(line[len("DRY RUN OK: "):])["tta_lr"], 3e-6)
