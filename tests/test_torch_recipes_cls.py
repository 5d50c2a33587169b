"""The classification recipes' twins (``scripts/torch/``) against the JAX
package's CLIs, on the CPU: each recipe's commands as bash expands them,
run in process in both packages on one synthetic ImageFolder ImageNet-A tree
(200 class folders, ``--test_sets A`` as the recipes read it) from the same
OpenAI-format checkpoints (``CLIP_VIT_B16``, ``CLIP_VIT_L14``). Every flag
the recipe sets stays; the test sets only the towers (a tiny ViT under a
``test-*`` arch), ``--resolution``, ``--batch_size`` (views) and
``--precision fp32``, and ``--device cpu`` on the port's side.

On the CPU both CLIs' ``--viewgen auto`` picks the device view generator,
whose draws differ between the packages (ROADMAP §C, "JAX's recipe, not
JAX's draws"): the JAX CLI's generator hands each group the port's views of
the same canonical images (checked equal). Each group's selections are
equal, its per-step losses and final logits within 2e-4, and the results
equal."""

import numpy as np
import pytest
import torch

from rlcf_tpu.tasks.classification import EncoderTTAClassifier as JEncoder
from rlcf_tpu.tasks.classification import PromptTTAClassifier as JPrompt
from rlcf_torch.tasks.classification import EncoderTTAClassifier, PromptTTAClassifier

from torch_port_fixtures import chip_smoke, openai_state_dict, recipe_pair, run_command, tiny_cfgs, with_flags
from torch_port_fixtures import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = dict(rtol=2e-4, atol=2e-4)
N_IMAGES = 2
TOWERS = dict(arch="test-small", resolution=32, precision="fp32")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The ImageFolder tree and the recipes' checkpoint variables."""
    root = tmp_path_factory.mktemp("recipes_cls")
    data, labels = chip_smoke.write_imagefolder_tree(root / "data", "A", N_IMAGES)
    cfg = tiny_cfgs()[1]
    env = {}
    for var, seed in (("CLIP_VIT_B16", 0), ("CLIP_VIT_L14", 1)):
        env[var] = str(root / f"{var}.pt")
        torch.save(openai_state_dict(cfg, seed=seed), env[var])
    return {"data": data, "labels": labels, "env": env}


def _run_both(name, args, tree, tmp_path, monkeypatch, owners, flags):
    """The recipe's one command in both packages (the port's first), each
    group's canonical images, views and ``adapt`` outputs recorded; the JAX
    CLI's generator returns the port's views. -> {package: (result, [(images,
    views)], [(logits, aux)])}"""
    from rlcf_tpu.data import augment as JA
    from rlcf_torch.data import augment as TA

    ((jcmd, tcmd),) = recipe_pair(name, args, tree["env"], tmp_path)
    monkeypatch.chdir(tmp_path)
    out = {}
    for package, cmd, aug, owner in (("torch", tcmd, TA, owners[1]), ("jax", jcmd, JA, owners[0])):
        groups, seen = [], []
        make = aug.make_view_generator

        def making(*a, _make=make, _package=package, _groups=groups, **k):
            gen = _make(*a, **k)

            def generate(imgs, rng):
                if _package == "torch":
                    views = gen(imgs, rng)
                    _groups.append((np.asarray(imgs), views.clone()))
                    return views
                want_imgs, views = out["torch"][1][len(_groups)]
                np.testing.assert_array_equal(np.asarray(imgs), want_imgs)   # the same canonical images
                _groups.append((np.asarray(imgs), views))
                import jax.numpy as jnp

                return jnp.asarray(views.numpy())

            return generate

        adapt = owner.adapt

        def recording(self, views, _adapt=adapt, _seen=seen, **k):
            logits, aux = _adapt(self, views, **k)
            _seen.append((np.asarray(logits), {key: np.asarray(v) for key, v in aux.items()}))
            return logits, aux

        monkeypatch.setattr(aug, "make_view_generator", making)
        monkeypatch.setattr(owner, "adapt", recording)
        argv = with_flags(cmd, **flags) + (["--device", "cpu"] if package == "torch" else [])
        out[package] = (run_command(argv)["A"], groups, seen)
    return out


def _assert_same(out, n_groups, steps, n_classes=200):
    (tres, tgroups, tseen), (jres, jgroups, jseen) = out["torch"], out["jax"]
    assert len(tgroups) == len(jgroups) == len(tseen) == len(jseen) == n_groups
    for (tl, taux), (jl, jaux) in zip(tseen, jseen):
        np.testing.assert_array_equal(taux["selected"], jaux["selected"])
        assert tl.shape[1] == n_classes and taux["losses"].shape[1] == steps
        np.testing.assert_allclose(taux["losses"], jaux["losses"], **TOL)
        np.testing.assert_allclose(tl, jl, **TOL)
    assert (tres["top1"], tres["top5"]) == (jres["top1"], jres["top5"])
    assert tres.get("n", N_IMAGES) == N_IMAGES


@pytest.mark.parametrize("name,steps", [("rlcf-prompt.sh", 3), ("tpt-prompt.sh", 1)])
def test_prompt_recipe_matches_jax(tree, tmp_path, monkeypatch, name, steps):
    """``rlcf-prompt.sh`` (the main path) and ``tpt-prompt.sh`` (the entropy
    loss, 1 step at lr 5e-3). The TPT recipe passes no reward, so the CLI
    builds its default one (here the test's tower from ``CLIP_VIT_L14``'s
    checkpoint): in both packages the episode still runs the reward tower on
    the selected views, whose similarities the TPT loss does not read
    (recorded equal)."""
    rsims = {}
    prepare = PromptTTAClassifier.prepare

    def port_prepare(self, views):
        img_feats, sel, r_sim = prepare(self, views)
        rsims.setdefault("torch", []).append(r_sim.numpy())
        return img_feats, sel, r_sim

    setup = JPrompt.setup

    def jax_setup(self, *a, **k):
        out = setup(self, *a, **k)
        jprepare = self._prepare

        def recording(*pa, **pk):
            img_feats, sel, r_sim = jprepare(*pa, **pk)
            rsims.setdefault("jax", []).append(np.asarray(r_sim))
            return img_feats, sel, r_sim

        self._prepare = recording
        return out

    monkeypatch.setattr(PromptTTAClassifier, "prepare", port_prepare)
    monkeypatch.setattr(JPrompt, "setup", jax_setup)
    flags = dict(TOWERS, batch_size=8, reward_arch="test-small", reward_checkpoint=tree["env"]["CLIP_VIT_L14"])
    out = _run_both(name, [tree["data"], "A"], tree, tmp_path, monkeypatch, (JPrompt, PromptTTAClassifier), flags)
    _assert_same(out, 1, steps)
    assert len(rsims["torch"]) == len(rsims["jax"]) == 1
    assert rsims["torch"][0].shape == (N_IMAGES, 1, 200)   # [N, selected views, classes]
    np.testing.assert_allclose(rsims["torch"][0], rsims["jax"][0], **TOL)
    assert (tmp_path / "exp" / "torch" / f"{name.split('-')[0]}_prompt_A" / "results.json").exists()


@pytest.mark.parametrize("kd", ["KD", "DKD", "ATKD"])
def test_kd_tune_matches_jax(tree, tmp_path, monkeypatch, kd):
    """``kd-tune.sh``: ``--loss kd --kd_loss <kd>``, 3 steps at lr 7e-3,
    distilling the reward's logits."""
    flags = dict(TOWERS, batch_size=8, reward_arch="test-small")
    out = _run_both("kd-tune.sh", [tree["data"], "A", kd], tree, tmp_path, monkeypatch,
                    (JPrompt, PromptTTAClassifier), flags)
    _assert_same(out, 1, 3)
    assert (tmp_path / "exp" / "torch" / f"kd_{kd}_A" / "results.json").exists()


@pytest.mark.parametrize("name", ["rlcf-tune.sh", "tpt-tune.sh"])
def test_tune_recipe_matches_jax(tree, tmp_path, monkeypatch, name):
    """Encoder TTA: ``rlcf-tune.sh`` (momentum EMA every 256 images) and
    ``tpt-tune.sh`` (the entropy loss, weight decay 5e-4, no momentum), 3
    steps at lr 1e-5, one image a group."""
    flags = dict(TOWERS, batch_size=8, reward_arch="test-small")
    out = _run_both(name, [tree["data"], "A"], tree, tmp_path, monkeypatch, (JEncoder, EncoderTTAClassifier), flags)
    _assert_same(out, N_IMAGES, 3)


def test_zero_shot_recipe_matches_jax(tree, tmp_path, monkeypatch):
    """``zero-shot.sh``: CLIP zero-shot over ImageNet-A's 200 prompts, each
    batch's logits within 2e-4, the same labels and result."""
    from rlcf_tpu.metrics.classification import AccuracyMeter as JMeter
    from rlcf_torch.metrics.classification import AccuracyMeter as TMeter

    ((jcmd, tcmd),) = recipe_pair("zero-shot.sh", [tree["data"], "A"], tree["env"], tmp_path)
    monkeypatch.chdir(tmp_path)
    seen = {}
    for package, cmd, meter in (("jax", jcmd, JMeter), ("torch", tcmd, TMeter)):
        update, seen[package] = meter.update, []

        def recording(self, logits, labels, _update=update, _seen=seen[package]):
            _seen.append((np.asarray(logits), np.asarray(labels)))
            return _update(self, logits, labels)

        monkeypatch.setattr(meter, "update", recording)
        argv = with_flags(cmd, **TOWERS) + (["--device", "cpu"] if package == "torch" else [])
        seen[package + " result"] = run_command(argv)["A"]
    assert len(seen["torch"]) == len(seen["jax"]) == 1
    (tl, tlab), (jl, jlab) = seen["torch"][0], seen["jax"][0]
    np.testing.assert_array_equal(tlab, jlab)
    assert sorted(tlab) == tree["labels"] and tl.shape == (N_IMAGES, 200)
    np.testing.assert_allclose(tl, jl, **TOL)
    assert seen["torch result"] == seen["jax result"]
