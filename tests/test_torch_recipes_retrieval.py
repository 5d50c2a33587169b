"""The retrieval recipes' twins (``scripts/torch/``) against the JAX
package's CLI, on the CPU: each recipe's commands as bash expands them, run
in process in both packages on synthetic karpathy-format trees (the smoke
script's writer) from the same OpenAI-format checkpoints (``CLIP_VIT_B16``,
``CLIP_VIT_L14``). Every flag the recipe sets stays; the test sets only the
towers (a tiny ViT under a ``test-*`` arch), ``--resolution``, the
``sample_k`` counts (the tiny galleries hold fewer items than the recipes
sample) and ``--precision fp32``, and ``--device cpu`` on the port's side.
Each direction's score matrix within 2e-4 + 2e-4 relative, the same R@k
metrics and the same ``results_retrieval.json``."""

import json

import numpy as np
import pytest
import torch

from rlcf_tpu.tasks.retrieval import RetrievalTTA as JRetrievalTTA
from rlcf_torch.tasks.retrieval import RetrievalTTA

from torch_port_fixtures import chip_smoke, openai_state_dict, recipe_pair, run_command, tiny_cfgs, with_flags
from torch_port_fixtures import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = dict(rtol=2e-4, atol=2e-4)
TOWERS = dict(arch="test-small", reward_arch="test-small", resolution=32, precision="fp32")


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Two retrieval trees (Flickr-like and COCO-like) and the recipes'
    checkpoint variables."""
    root = tmp_path_factory.mktemp("recipes_retrieval")
    cfg = tiny_cfgs()[1]
    env = {}
    for var, seed in (("CLIP_VIT_B16", 0), ("CLIP_VIT_L14", 1)):
        env[var] = str(root / f"{var}.pt")
        torch.save(openai_state_dict(cfg, seed=seed), env[var])
    return {"flickr": chip_smoke.write_retrieval_tree(root / "flickr", 4, caps_per_image=2, size=(40, 56)),
            "coco": chip_smoke.write_retrieval_tree(root / "coco", 3, caps_per_image=2, size=(40, 56), seed=1),
            "env": env}


def _run_pairs(pairs, tmp_path, monkeypatch, flags):
    """Each (JAX, port) command pair in turn, JAX's first, every direction's
    ``RetrievalTTA.run`` recorded -> [{package: (result, [(direction,
    scores)])}]."""
    monkeypatch.chdir(tmp_path)
    runs, originals = [], {owner: owner.run for owner in (JRetrievalTTA, RetrievalTTA)}
    for jcmd, tcmd in pairs:
        out = {}
        for package, cmd, owner in (("jax", jcmd, JRetrievalTTA), ("torch", tcmd, RetrievalTTA)):
            seen, run = [], originals[owner]

            def recording(self, *a, _run=run, _seen=seen, **k):
                scores = _run(self, *a, **k)
                _seen.append((self.direction, np.asarray(scores)))
                return scores

            monkeypatch.setattr(owner, "run", recording)
            argv = with_flags(cmd, **flags) + (["--device", "cpu"] if package == "torch" else [])
            out[package] = (run_command(argv), seen)
        runs.append(out)
    return runs


def test_tta_flickr_ret_matches_jax(trees, tmp_path, monkeypatch):
    """``tta_flickr_ret.sh``: both directions, 8 steps at lr 1e-6, weight
    decay 5e-4, sample_k 12 (t2i) and 16 (i2t) cut to the tiny galleries,
    ``--momentum_update 0 --update_freq 32 --tta_momentum 0.9998``."""
    pairs = recipe_pair("tta_flickr_ret.sh", trees["flickr"], trees["env"], tmp_path)
    (out,) = _run_pairs(pairs, tmp_path, monkeypatch, dict(TOWERS, sample_k_t2i=3, sample_k_i2t=4))
    assert set(out["torch"][0]["group_seconds"]) == {"i2t", "t2i"}
    _assert_same(out, tmp_path, "ret_flickr", 4, 8)


def _assert_same(out, tmp_path, name, n_img, n_txt):
    """Each direction's scores, the metrics and the results file, under
    ``exp/torch/<name>`` (the port) and ``exp/<name>`` (JAX)."""
    (tres, tseen), (jres, jseen) = out["torch"], out["jax"]
    assert [d for d, _ in tseen] == [d for d, _ in jseen] == ["i2t", "t2i"]
    for (_, ts), (_, js), shape in zip(tseen, jseen, ((n_img, n_txt), (n_txt, n_img))):
        assert ts.shape == shape
        np.testing.assert_allclose(ts, js, **TOL)
    assert tres["metrics"] == jres
    got, want = (json.loads((tmp_path / "exp" / pkg / name / "results_retrieval.json").read_text())
                 for pkg in ("torch", ""))
    assert got == want


def test_zero_shot_retrieval_matches_jax(trees, tmp_path, monkeypatch):
    """``zero_shot.sh``: ``--tta_steps 0`` both directions on Flickr30k, then
    on COCO, the reward the policy's ViT-B/16 (one checkpoint for both)."""
    args = [*trees["flickr"], *trees["coco"]]
    pairs = recipe_pair("zero_shot.sh", args, trees["env"], tmp_path)
    assert len(pairs) == 2
    runs = _run_pairs(pairs, tmp_path, monkeypatch, TOWERS)
    for out, name, (n_img, n_txt) in zip(runs, ("zeroshot_flickr_ret", "zeroshot_coco_ret"), ((4, 8), (3, 6))):
        _assert_same(out, tmp_path, name, n_img, n_txt)
