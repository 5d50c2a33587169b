"""CoCoOp on the CPU against ``rlcf_tpu``: the instance-conditioned episode
group on the same weights and meta-net (carried across as numpy: the port
draws its own meta-net from a torch generator, which cannot reproduce JAX's
draws) at 0 and 2 steps, on u8 and float views, dense and through the fused
attention's plain version (fp32; selections equal, per-step losses and final
logits within 2e-4); the checkpoint converter on a ``torch.save``d state
dict with and without prefixes; and ``tta_cls --cocoop --viewgen native``
from one checkpoint against the JAX CLI's run."""

import jax
import numpy as np
import pytest
import torch

from rlcf_tpu.core.episode import EpisodeConfig as JEpisodeConfig
from rlcf_tpu.models import clip as JC
from rlcf_tpu.tasks import classification as JT
from rlcf_torch.core.episode import EpisodeConfig
from rlcf_torch.models import convert as TV
from rlcf_torch.tasks import classification as TT

from torch_port_fixtures import jax_params_numpy, openai_state_dict, tiny_cfgs

CLASSNAMES = ["goldfish", "tiger cat", "airliner", "acoustic guitar", "great white shark"]
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def towers():
    jcfg, tcfg = tiny_cfgs(embed=32)   # the meta-net's hidden width is embed // 16
    jp = JC.init_clip_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, TV.from_jax_params(jax_params_numpy(jp), tcfg)


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, dtype=np.float32), **TOL)


@pytest.mark.parametrize("steps,u8,attn", [(0, True, "dense"), (2, True, "dense"), (2, False, "dense"),
                                           (2, True, "fused")])
def test_cocoop_adapt_matches_jax(towers, steps, u8, attn):
    jcfg, tcfg, jp, tp = towers
    ek = dict(tta_steps=steps, selection_p=0.25, lr=5e-3, loss="tpt")
    jclf = JT.CoCoOpTTAClassifier(jp, jcfg, JEpisodeConfig(**ek)).setup(CLASSNAMES)
    meta = {k: np.array(v) for k, v in jclf.meta_net.items()}
    tclf = TT.CoCoOpTTAClassifier(tp, tcfg, EpisodeConfig(**ek), meta_net=meta)
    tclf.attn = tclf.text_attn = attn   # "fused" runs the kernel's plain version on the CPU
    tclf.setup(CLASSNAMES)
    rng = np.random.default_rng(1)
    views = (rng.integers(0, 256, size=(3, 16, 32, 32, 3), dtype=np.uint8) if u8
             else rng.normal(size=(3, 16, 32, 32, 3)).astype(np.float32))
    jl, jaux = jclf.adapt(views)
    tl, taux = tclf.adapt(views)
    np.testing.assert_array_equal(taux["selected"].numpy(), np.asarray(jaux["selected"]))
    assert tl.shape == (3, len(CLASSNAMES)) and taux["losses"].shape == (3, steps)
    _close(taux["losses"], jaux["losses"])
    _close(tl, jl)
    if steps == 0:   # each episode's context is its own image's: alone, an image gives its logits in the group
        _close(tclf.adapt(views[:1])[0], tl[:1].numpy())


def test_meta_net_forward_matches_jax():
    meta = JT.init_meta_net(jax.random.PRNGKey(3), 32, 64)
    x = np.random.default_rng(2).normal(size=(5, 32)).astype(np.float32)
    got = TT.meta_net_forward({k: torch.from_numpy(np.array(v)) for k, v in meta.items()}, torch.from_numpy(x))
    _close(got, JT.meta_net_forward(meta, x))
    init = TT.init_meta_net(32, 64)
    assert {k: tuple(v.shape) for k, v in init.items()} == {k: tuple(v.shape) for k, v in meta.items()}
    assert all(bool((init[k] == 0).all()) for k in ("b1", "b2"))
    assert abs(float(init["w1"].std()) - 32 ** -0.5) < 0.05


@pytest.mark.parametrize("prefix", ["prompt_generator.", "prompt_learner.", ""])
def test_convert_cocoop_checkpoint_matches_jax(tmp_path, prefix):
    from rlcf_tpu.models.convert import load_torch_file as jload
    from rlcf_torch.models.convert import load_torch_file

    rng = np.random.default_rng(0)
    t = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    sd = {prefix + "ctx": t(4, 64), prefix + "meta_net.linear1.weight": t(2, 32),
          prefix + "meta_net.linear1.bias": t(2), prefix + "meta_net.linear2.weight": t(64, 2),
          prefix + "meta_net.linear2.bias": t(64), prefix + "token_prefix": t(1, 1, 64)}
    path = tmp_path / "cocoop.pth"
    torch.save({"state_dict": sd}, path)
    ctx, meta = TT.convert_cocoop_checkpoint(load_torch_file(str(path)))
    jctx, jmeta = JT.convert_cocoop_checkpoint(jload(str(path)))
    np.testing.assert_array_equal(ctx.numpy(), np.asarray(jctx))
    assert set(meta) == set(jmeta) == {"w1", "b1", "w2", "b2"}
    for k in meta:
        assert meta[k].dtype == torch.float32
        np.testing.assert_array_equal(meta[k].numpy(), np.asarray(jmeta[k]))
    with pytest.raises(KeyError):
        TT.convert_cocoop_checkpoint({"ctx": sd[prefix + "ctx"]})


def test_tta_cls_cocoop_cli_matches_jax(tmp_path):
    """``tta_cls --cocoop --viewgen native`` in both packages from one policy
    checkpoint and one CoCoOp checkpoint (``--load``): each group's logits,
    selections and losses within 2e-4, and the same result."""
    from rlcf_torch.data import native

    if not native.available():
        pytest.skip("no C++ toolchain for the native view pipeline")
    from rlcf_tpu.cli import tta_cls as jcli
    from rlcf_torch.cli import tta_cls as tcli

    cfg = JC.get_config("test-small")
    clip_path, load_path = tmp_path / "clip.pt", tmp_path / "cocoop.pth"
    torch.save(openai_state_dict(cfg, seed=0), clip_path)
    rng = np.random.default_rng(4)
    t = lambda *shape: torch.from_numpy((rng.normal(size=shape) * 0.05).astype(np.float32))
    E, D = cfg.embed_dim, cfg.text_width
    torch.save({"prompt_learner.ctx": t(4, D), "prompt_learner.meta_net.linear1.weight": t(E // 16, E),
                "prompt_learner.meta_net.linear1.bias": t(E // 16),
                "prompt_learner.meta_net.linear2.weight": t(D, E // 16),
                "prompt_learner.meta_net.linear2.bias": t(D)}, load_path)
    argv = [".", "--test_sets", "synthetic", "--limit", "3", "--arch", "test-small", "--reward_arch", "test-small",
            "--clip_checkpoint", str(clip_path), "--precision", "fp32", "--resolution", "64", "--batch_size", "8",
            "--tta_steps", "2", "--selection_p", "0.25", "--lr", "5e-3", "--cocoop", "--loss", "tpt",
            "--load", str(load_path), "--ctx_init", "a_photo_of_a", "--viewgen", "native", "--episode_group", "2"]
    seen = {}
    for name, cli, cls in (("jax", jcli, JT.CoCoOpTTAClassifier), ("torch", tcli, TT.CoCoOpTTAClassifier)):
        adapt, seen[name] = cls.adapt, []

        def recording(self, views, _adapt=adapt, _seen=seen[name]):
            logits, aux = _adapt(self, views)
            _seen.append((np.asarray(logits), np.asarray(aux["selected"]), np.asarray(aux["losses"])))
            return logits, aux

        cls.adapt = recording
        try:
            extra = ["--device", "cpu"] if name == "torch" else []
            seen[name + " result"] = cli.main(argv + extra + ["--output", str(tmp_path / name)])["synthetic"]
        finally:
            cls.adapt = adapt
    assert len(seen["torch"]) == len(seen["jax"]) == 2
    for (tl, tsel, tloss), (jl, jsel, jloss) in zip(seen["torch"], seen["jax"]):
        np.testing.assert_array_equal(tsel, jsel)
        np.testing.assert_allclose(tloss, jloss, **TOL)
        np.testing.assert_allclose(tl, jl, **TOL)
    tres, jres = seen["torch result"], seen["jax result"]
    assert tres["n"] == 3 and (tres["top1"], tres["top5"]) == (jres["top1"], jres["top5"])
