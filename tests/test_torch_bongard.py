"""Bongard-HOI on the CPU against ``rlcf_tpu``: ``BongardTTA.adapt_tasks``
on the same weights and task images in both class-token modes, float and u8
images, dense and through the fused attention's plain version (fp32; query
logits and per-step support losses within 2e-4), and ``tta_cls --test_sets
bongard`` on a synthetic tree from one checkpoint against the JAX CLI's run
(each group's query logits within 2e-4, the same result)."""

import jax
import numpy as np
import pytest
import torch

from rlcf_tpu.core.episode import EpisodeConfig as JEpisodeConfig
from rlcf_tpu.models import clip as JC
from rlcf_tpu.tasks import bongard as JB
from rlcf_torch.core.episode import EpisodeConfig
from rlcf_torch.models import convert as TV
from rlcf_torch.tasks import bongard as TB

from torch_port_fixtures import chip_smoke, jax_params_numpy, openai_state_dict, tiny_cfgs

TOL = dict(rtol=2e-4, atol=2e-4)
LABELS = np.tile(np.array([0] * 6 + [1] * 6, dtype=np.int32), (2, 1))


@pytest.fixture(scope="module")
def towers():
    jcfg, tcfg = tiny_cfgs()
    jp = JC.init_clip_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, TV.from_jax_params(jax_params_numpy(jp), tcfg)


def _task_images(u8):
    rng = np.random.default_rng(0)
    if u8:
        return rng.integers(0, 256, size=(2, 14, 32, 32, 3), dtype=np.uint8)
    return rng.normal(size=(2, 14, 32, 32, 3)).astype(np.float32)


@pytest.mark.parametrize("learned_cls,u8,attn,ctx_init", [
    (True, False, "dense", None), (False, False, "dense", None), (True, True, "dense", None),
    (True, False, "fused", None), (False, False, "fused", "a photo of a"), (True, False, "dense", "a photo of a")])
def test_adapt_tasks_matches_jax(towers, learned_cls, u8, attn, ctx_init):
    jcfg, tcfg, jp, tp = towers
    ek = dict(tta_steps=3, lr=0.05, weight_decay=5e-4)
    jtta = JB.BongardTTA(jp, jcfg, JEpisodeConfig(**ek), ctx_init=ctx_init, n_ctx=2, learned_cls=learned_cls).setup()
    ttta = TB.BongardTTA(tp, tcfg, EpisodeConfig(**ek), ctx_init=ctx_init, n_ctx=2, learned_cls=learned_cls)
    ttta.attn = attn   # "fused" runs the kernel's plain version on the CPU
    ttta.setup()
    imgs = _task_images(u8)
    jl, jaux = jtta.adapt_tasks(imgs, LABELS)
    tl, taux = ttta.adapt_tasks(imgs, LABELS)
    assert tl.shape == (2, TB.N_QUERY, 2) and taux["losses"].shape == (2, 3)
    assert TB.N_SUPPORT == JB.N_SUPPORT and TB.N_QUERY == JB.N_QUERY
    np.testing.assert_allclose(taux["losses"].numpy(), np.asarray(jaux["losses"]), **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    if not ctx_init:   # fp32 context and class tokens: the text tower runs in fp32 whatever the weights
        assert ttta.prompt_state.ctx0.dtype == torch.float32


def test_tta_cls_bongard_cli_matches_jax(tmp_path):
    from rlcf_tpu.cli import tta_cls as jcli
    from rlcf_torch.cli import tta_cls as tcli

    root = chip_smoke.write_bongard_tree(tmp_path / "data", n_tasks=3, swap_split=True)
    clip_path = tmp_path / "clip.pt"
    torch.save(openai_state_dict(JC.get_config("test-small"), seed=0), clip_path)
    argv = [root, "--test_sets", "bongard", "--arch", "test-small", "--reward_arch", "test-small",
            "--clip_checkpoint", str(clip_path), "--precision", "fp32", "--resolution", "64", "--tta_steps", "2",
            "--lr", "5e-3", "--episode_group", "2", "--learned_cls", "1"]
    seen = {}
    for name, cli, cls in (("jax", jcli, JB.BongardTTA), ("torch", tcli, TB.BongardTTA)):
        adapt, seen[name] = cls.adapt_tasks, []

        def recording(self, imgs, labels, _adapt=adapt, _seen=seen[name]):
            q_logits, aux = _adapt(self, imgs, labels)
            _seen.append((np.asarray(imgs).shape, np.asarray(q_logits), np.asarray(aux["losses"])))
            return q_logits, aux

        cls.adapt_tasks = recording
        try:
            extra = ["--device", "cpu"] if name == "torch" else []
            seen[name + " result"] = cli.main(argv + extra + ["--output", str(tmp_path / name)])["bongard"]
        finally:
            cls.adapt_tasks = adapt
    assert [s[0] for s in seen["torch"]] == [s[0] for s in seen["jax"]] == [(2, 14, 64, 64, 3), (1, 14, 64, 64, 3)]
    for (_, tl, tloss), (_, jl, jloss) in zip(seen["torch"], seen["jax"]):
        np.testing.assert_allclose(tloss, jloss, **TOL)
        np.testing.assert_allclose(tl, jl, **TOL)
    tres, jres = seen["torch result"], seen["jax result"]
    assert {k: tres[k] for k in jres} == jres and jres["n_queries"] == 6 and len(tres["group_seconds"]) == 2
