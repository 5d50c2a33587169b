"""Whole CLI runs on fine-grained trees against the JAX package's CLIs, from
one OpenAI-format checkpoint per tower: ``tta_cls --viewgen native`` on a
Zhou-split set (Stanford Cars, whose prompts truncate to a text length of
24) and on FGVC-Aircraft (each group's selections equal, per-step losses
and final logits within 2e-4 in fp32, the same result), and ``zero_shot``
on a Zhou-split set (each batch's logits within 2e-4, the same labels and
result)."""

import numpy as np
import pytest
import torch

from rlcf_tpu.models import clip as JC
from rlcf_tpu.tasks.classification import PromptTTAClassifier as JClassifier
from rlcf_torch.tasks.classification import PromptTTAClassifier

from torch_port_fixtures import openai_state_dict, write_fine_grained_tree

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture
def checkpoints(tmp_path):
    paths = []
    for seed in (0, 1):
        paths.append(str(tmp_path / f"clip{seed}.pt"))
        torch.save(openai_state_dict(JC.get_config("test-small"), seed=seed), paths[-1])
    return paths


def _run_both(clis, argv, tmp_path, patches):
    """Run the JAX CLI, then the port's (``--device cpu``), each with its
    ``(owner, method)`` wrapped to record what it returns."""
    seen = {}
    for name, cli, (owner, attr) in zip(("jax", "torch"), clis, patches):
        original, seen[name] = getattr(owner, attr), []

        def recording(self, *a, _original=original, _seen=seen[name]):
            out = _original(self, *a)
            _seen.append((a, out))
            return out

        setattr(owner, attr, recording)
        try:
            extra = ["--device", "cpu"] if name == "torch" else []
            seen[name + " result"] = cli.main(argv + extra + ["--output", str(tmp_path / name)])
        finally:
            setattr(owner, attr, original)
    return seen


@pytest.mark.parametrize("set_id", ["cars", "aircraft"])
def test_tta_cls_fine_grained_matches_jax(tmp_path, checkpoints, set_id):
    from rlcf_tpu.cli import tta_cls as jcli
    from rlcf_torch.cli import tta_cls as tcli
    from rlcf_torch.data import native

    if not native.available():
        pytest.skip("no C++ toolchain for the native view pipeline")
    write_fine_grained_tree(tmp_path / "data", set_id, n_classes=3, per_class=1)
    argv = [str(tmp_path / "data"), "--test_sets", set_id, "--limit", "3", "--arch", "test-small",
            "--reward_arch", "test-small", "--clip_checkpoint", checkpoints[0], "--reward_checkpoint", checkpoints[1],
            "--precision", "fp32", "--resolution", "64", "--batch_size", "8", "--tta_steps", "2", "--sample_k", "2",
            "--selection_p", "0.25", "--lr", "7e-3", "--ctx_init", "a_photo_of_a", "--viewgen", "native",
            "--episode_group", "2"]
    seen = _run_both((jcli, tcli), argv, tmp_path,
                     ((JClassifier, "adapt_tokens"), (PromptTTAClassifier, "adapt_tokens")))
    assert len(seen["torch"]) == len(seen["jax"]) == 2
    for (targs, (tl, taux)), (jargs, (jl, jaux)) in zip(seen["torch"], seen["jax"]):
        np.testing.assert_array_equal(np.asarray(targs[0]), np.asarray(jargs[0]))   # the same views
        np.testing.assert_array_equal(taux["selected"].numpy(), np.asarray(jaux["selected"]))
        np.testing.assert_allclose(taux["losses"].numpy(), np.asarray(jaux["losses"]), **TOL)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    tres, jres = seen["torch result"][set_id], seen["jax result"][set_id]
    assert tres["n"] == 3 and (tres["top1"], tres["top5"]) == (jres["top1"], jres["top5"])
    if set_id == "cars":   # Stanford Cars' prompts truncate to a text length of 24
        from rlcf_torch.core.prompt import build_prompt_state
        from rlcf_torch.data.class_names import get_classnames
        from rlcf_torch.models.convert import load_clip_checkpoint

        params, _ = load_clip_checkpoint(checkpoints[0])
        assert build_prompt_state(params, get_classnames("cars")).fixed_embed.shape[1] == 24


def test_zero_shot_fine_grained_matches_jax(tmp_path, checkpoints):
    from rlcf_tpu.cli import zero_shot as jcli
    from rlcf_tpu.metrics.classification import AccuracyMeter as JMeter
    from rlcf_torch.cli import zero_shot as tcli
    from rlcf_torch.metrics.classification import AccuracyMeter as TMeter

    write_fine_grained_tree(tmp_path / "data", "dtd", n_classes=4, per_class=1)
    argv = [str(tmp_path / "data"), "--test_sets", "dtd", "--dataset_mode", "test", "--limit", "3", "--arch",
            "test-small", "--clip_checkpoint", checkpoints[0], "--precision", "fp32", "--resolution", "64",
            "--batch_size", "2"]
    seen = _run_both((jcli, tcli), argv, tmp_path, ((JMeter, "update"), (TMeter, "update")))
    assert len(seen["torch"]) == len(seen["jax"]) == 2
    for ((tl, tlab), _), ((jl, jlab), _) in zip(seen["torch"], seen["jax"]):
        np.testing.assert_array_equal(np.asarray(tlab), np.asarray(jlab))
        np.testing.assert_allclose(np.asarray(tl), np.asarray(jl), **TOL)
    assert seen["torch result"]["dtd"] == seen["jax result"]["dtd"]
