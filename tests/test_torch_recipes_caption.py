"""The caption recipes' twins (``scripts/torch/``) against the JAX package's
CLIs, on the CPU: each recipe's commands as bash expands them, run in
process in both packages from the same checkpoints (OpenAI-format CLIP
towers under ``CLIP_VIT_B16``, ``CLIP_VIT_L14`` and ``CLIP_VIT_B32``, an
HF-format OPT under ``OPT_125M``, a ClipCap-format mapper as the recipes'
third argument) and one synthetic OPT vocabulary (``OPT_VOCAB``,
``OPT_MERGES``). Every flag the recipe sets stays; the test sets only the
towers (tiny ViTs under a ``test-*`` arch, the tiny OPT and mapper),
``--resolution``, ``--sample_k`` and ``--precision fp32``, and ``--device
cpu`` on the port's side.

``tta_capdec_c2n.sh`` on three synthetic NoCaps splits (``--dataset_mode 2``,
4 TTA steps, ``clipscore_eval --out_json`` a split, then
``tools/nocaps_domain_report.py`` as a process over each package's metric
files), and ``eval_coco.sh`` (``--tta_steps 0``, the reward the policy's
ViT-B/16) with and without its references: captions and per-image files
equal, CLIPScore and RefCLIPScore within 1e-5 (``tests/test_torch_clipscore.py``),
the reference metrics equal, and the merged NoCaps table equal to JAX's."""

import json

import numpy as np
import pytest
import torch

from rlcf_tpu.models import mappers as JM
from rlcf_tpu.models import opt as JO
from rlcf_torch.models import opt as TO

from torch_port_fixtures import (chip_smoke, hf_mapper_state_dict, hf_opt_state_dict, openai_state_dict,
                                 recipe_pair, run_command, tiny_cfgs, with_flags)
from torch_port_fixtures import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread", "opt_heads")

SCORE_TOL = dict(rtol=1e-5, atol=1e-5)
SCORES = ("clipscore", "ref_clipscore")
CAPTION_TOWERS = dict(clip_model_type="test-small", reward_arch="test-small", llm="test-tiny-opt", prefix_length=4,
                      clip_length=2, resolution=32, precision="fp32", sample_k=2)
DOMAINS = ("in-domain", "near-domain", "out-domain")


@pytest.fixture(scope="module")
def opt_heads():
    """The tiny OPT's hidden width (32) is no released OPT size: its heads."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(JO._OPT_N_HEADS, 32, 2)
        mp.setitem(TO._OPT_N_HEADS, 32, 2)
        yield


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The NoCaps splits (2 images each), a COCO-caption tree (2 images),
    the mapper checkpoint and the recipes' variables."""
    root = tmp_path_factory.mktemp("recipes_caption")
    vocab, merges = chip_smoke.write_opt_vocab(str(root / "vocab"), size=600, newline_id=None)
    env = {"OPT_125M": str(root / "opt.pt"), "OPT_VOCAB": vocab, "OPT_MERGES": merges}
    opt_sd = hf_opt_state_dict(proj=False)
    opt_sd["model.decoder.embed_tokens.weight"] *= 2.0   # peaked enough that the beams rank clearly apart
    torch.save({k: torch.from_numpy(v) for k, v in opt_sd.items()}, env["OPT_125M"])
    mcfg = JM.MapperConfig("transformer", clip_dim=16, llm_dim=32, prefix_length=4, clip_length=2)
    torch.save({k: torch.from_numpy(v) for k, v in hf_mapper_state_dict(mcfg).items()}, str(root / "mapper.pt"))
    for var, seed in (("CLIP_VIT_B16", 0), ("CLIP_VIT_L14", 1), ("CLIP_VIT_B32", 3)):
        env[var] = str(root / f"{var}.pt")
        torch.save(openai_state_dict(tiny_cfgs()[1], seed=seed), env[var])
    (root / "work").mkdir()
    return {"root": root, "env": env, "mapper": str(root / "mapper.pt"), "runs": {},
            "nocaps": chip_smoke.write_nocaps_splits(root / "nocaps", 2, size=(40, 56)),
            "coco": chip_smoke.write_caption_tree(str(root / "coco"), 2, caps_per_image=2, size=(40, 56))}


def _flags(cmd):
    if cmd[0] != "-m":   # the report tool
        return cmd
    return with_flags(cmd, **(CAPTION_TOWERS if cmd[1].endswith("tta_caption") else dict(resolution=32)))


def _run(pair):
    """One command pair, JAX's first -> {package: what it returned}."""
    return {package: run_command(_flags(cmd) + (["--device", "cpu"] if package == "torch" and cmd[0] == "-m" else []))
            for package, cmd in zip(("jax", "torch"), pair)}


def _read(path):
    with open(path) as fh:
        return json.load(fh)


def _assert_metrics_same(got, want):
    """A ``clipscore_eval`` summary: the scores (and each image's) within
    1e-5, the rest equal."""
    assert sorted(got) == sorted(want)
    for key in want:
        if key in SCORES:
            np.testing.assert_allclose(got[key], want[key], **SCORE_TOL)
        elif key == "per_instance":
            assert list(got[key]) == list(want[key])
            for image, row in want[key].items():
                assert sorted(got[key][image]) == sorted(row)
                for name, value in row.items():
                    np.testing.assert_allclose(got[key][image][name], value, **SCORE_TOL)
        else:
            assert got[key] == want[key], key


@pytest.mark.parametrize("refs", [True, False], ids=["references", "no references"])
def test_eval_coco_matches_jax(tree, tmp_path, monkeypatch, refs):
    """``eval_coco.sh``: ``tta_caption --tta_steps 0 --normalize_prefix 1``
    with the policy's ViT-B/16 as the reward, then ``clipscore_eval`` with
    the optional references (the 4th argument) or without."""
    ann, images = tree["coco"]
    args = [ann, images, tree["mapper"]] + ([f"{images}/references.json"] if refs else [])
    monkeypatch.chdir(tmp_path)
    caption_pair, score_pair = recipe_pair("eval_coco.sh", args, tree["env"], tmp_path)
    assert ("--references_json" in score_pair[1]) == refs
    captions, scores = _run(caption_pair), _run(score_pair)
    assert [r["image_id"] for r in captions["torch"]["results"]] == [a["image"] for a in _read(ann)]
    for name in ("results_caption.json", "results_clipscore.json"):
        assert _read(f"exp/torch/eval_coco/{name}") == _read(f"exp/eval_coco/{name}"), name
    _assert_metrics_same(scores["torch"], scores["jax"])
    assert ("ref_clipscore" in scores["torch"]) == refs


def _c2n(tree, monkeypatch):
    """``tta_capdec_c2n.sh``'s commands (a caption run and its CLIPScore for
    each split, then the report), each pair run once a module."""
    monkeypatch.chdir(tree["root"] / "work")
    if "c2n" not in tree["runs"]:
        tree["runs"]["c2n"] = recipe_pair("tta_capdec_c2n.sh", [*tree["nocaps"], tree["mapper"]], tree["env"],
                                          tree["root"] / "work")
    return tree["runs"]["c2n"]


def _c2n_split(tree, monkeypatch, s):
    pairs = _c2n(tree, monkeypatch)
    if s not in tree["runs"]:
        tree["runs"][s] = [_run(pairs[2 * s]), _run(pairs[2 * s + 1])]
    return pairs[2 * s : 2 * s + 2], tree["runs"][s]


@pytest.mark.parametrize("s", range(3), ids=DOMAINS)
def test_c2n_split_matches_jax(tree, monkeypatch, s):
    """One NoCaps split of ``tta_capdec_c2n.sh``: ``tta_caption --dataset_mode
    2`` (image ids from the annotations), 4 steps at lr 3e-6, then
    ``clipscore_eval`` with the split's references and ``--out_json``."""
    (caption_pair, score_pair), (captions, scores) = _c2n_split(tree, monkeypatch, s)
    assert captions["torch"]["results"] == _read(f"exp/torch/capdec_c2n_{chip_smoke.NOCAPS_SPLITS[s]}"
                                                 "/results_caption.json")
    for name in ("results_caption.json", "results_clipscore.json"):
        jax_out, torch_out = (c[c.index("--output") + 1] for c in caption_pair)
        assert _read(f"{torch_out}/{name}") == _read(f"{jax_out}/{name}"), name
    refs = _read(f"{tree['nocaps'][0]}/nocaps_{chip_smoke.NOCAPS_SPLITS[s]}.json")
    assert [r["image_id"] for r in captions["torch"]["results"]] == [a["image_id"] for a in refs]
    _assert_metrics_same(scores["torch"], scores["jax"])
    jax_json, torch_json = (c[c.index("--out_json") + 1] for c in score_pair)
    _assert_metrics_same(_read(torch_json), _read(jax_json))
    assert _read(torch_json)["n_images"] == 2


def test_c2n_report_matches_jax(tree, monkeypatch):
    """The recipe's last command: the report merges each package's three
    metric files; the merged tables agree (scores within 1e-5)."""
    pairs = _c2n(tree, monkeypatch)
    for s in range(3):
        _c2n_split(tree, monkeypatch, s)
    (report,) = pairs[6:]
    assert report[1][0] == "tools/nocaps_domain_report.py" and len(report[1]) == 6
    _run(report)
    got, want = (_read(cmd[cmd.index("--out") + 1]) for cmd in (report[1], report[0]))
    assert list(got["domains"]) == list(want["domains"]) == list(DOMAINS)
    for domain in DOMAINS:
        _assert_metrics_same(got["domains"][domain], want["domains"][domain])
    _assert_metrics_same(got["overall"], want["overall"])
    assert got["overall"]["n_images"] == 6
