"""The port's process mesh and collectives (``rlcf_torch/parallel/``) on the
CPU over gloo, ranks launched by ``torch_parallel_workers.launch``, against
the JAX package's mesh on the tests' 8-device virtual mesh: make_mesh's
layouts and errors, round_to_dp, dp_slice / dp_gather, gather_replicated's
gradient (this rank's slice, no sum over the ranks), the prompt classifier's
tp text features and its context gradient (psummed over tp) against the
unsharded gradient, and fused_views_sharded bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlcf_tpu.core import prompt as JPr
from rlcf_tpu.core.episode import EpisodeConfig as JEpisodeConfig, step_loss
from rlcf_tpu.core.reward import ClipReward as JClipReward, RewardConfig as JRewardConfig
from rlcf_tpu.models import clip as JC
from rlcf_tpu.parallel import mesh as JM
from rlcf_torch.core.episode import EpisodeConfig
from rlcf_torch.core.reward import ClipReward, RewardConfig
from rlcf_torch.models import convert as TV
from rlcf_torch.ops.augmix import fused_views, fused_views_sharded
from rlcf_torch.parallel import mesh as TM
from rlcf_torch.tasks.classification import PromptTTAClassifier

from torch_parallel_workers import launch
from torch_port_fixtures import jax_params_numpy, tiny_cfgs

REQUESTS = {"tp2": dict(n_devices=4, tp=2), "all": dict(n_devices=4), "dp3tp2": dict(n_devices=4, dp=3, tp=2),
            "tp3": dict(n_devices=4, tp=3), "too_many": dict(n_devices=16)}
ERROR_WORDS = {"dp3tp2": "must factor", "tp3": "does not divide", "too_many": "visible"}
NAMES = [f"class number {i}" for i in range(8)]


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    return launch(tmp_path_factory.mktemp("mesh"), 4, "mesh", {"requests": REQUESTS})


def _jax_mesh(kw):
    try:
        return JM.make_mesh(**kw), None
    except ValueError as e:
        return None, str(e)


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_make_mesh_matches_jax(mesh_run, name):
    """The same factorizations, the same rank layout (tp the fast axis) and
    the same errors as JAX's make_mesh on 4 of the virtual devices."""
    jmesh, jerr = _jax_mesh(REQUESTS[name])
    if jerr is not None:
        assert ERROR_WORDS[name] in jerr
        err = mesh_run["errors"][name]
        assert ERROR_WORDS[name] in err and "processes" in err and "torchrun" in err
        return
    got = mesh_run[name]
    assert got["shape"] == dict(jmesh.shape)
    where = {d.id: tuple(int(i) for i in np.argwhere(jmesh.devices == d)[0]) for d in jmesh.devices.flat}
    assert got["coords"] == [where[d.id] for d in jax.devices()[:4]]


def test_round_to_dp_matches_jax(mesh_run):
    jmesh = JM.make_mesh(4, tp=2)
    assert mesh_run["round"] == {n: JM.round_to_dp(n, jmesh) for n in range(1, 8)}
    assert TM.round_to_dp(3, None) == JM.round_to_dp(3, None) == 3


def test_dp_slice_and_gather(mesh_run):
    x = torch.arange(24.0).reshape(8, 3)
    assert [tuple(s[:, 0].tolist()) for s in mesh_run["dp_slice"]] == [(0, 3, 6, 9)] * 2 + [(12, 15, 18, 21)] * 2
    torch.testing.assert_close(mesh_run["dp_gather"], 2 * x)
    torch.testing.assert_close(mesh_run["dp_untiled"], x[:3])   # a batch that does not tile dp stays whole


def test_gather_replicated_gradient_is_the_ranks_slice(mesh_run):
    """Each rank's rows get their slice of the replicated loss's gradient:
    ``torch.distributed.nn``'s all_gather would give tp times that."""
    w = torch.arange(12.0).reshape(4, 3)
    torch.testing.assert_close(mesh_run["gathered"], torch.cat([torch.arange(6.0).reshape(2, 3) + 10 * r
                                                                for r in range(2)]))
    for r, g in enumerate(mesh_run["row_grad"]):
        torch.testing.assert_close(g, w[2 * r: 2 * r + 2])


def test_all_reduce_grads_and_replicate(mesh_run):
    a, b = mesh_run["reduced"]
    torch.testing.assert_close(a, torch.full((2,), 3.0))
    torch.testing.assert_close(b, torch.ones(3, dtype=torch.float64))
    assert all(t.tolist() == [0.0, 0.0] for t in mesh_run["replicated"])


def test_single_process_mesh_names_torchrun(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert TM.init_distributed("cpu") is False
    assert TM.make_mesh().shape == {"dp": 1, "tp": 1}
    with pytest.raises(ValueError, match="torchrun"):
        TM.make_mesh(tp=2)
    with pytest.raises(ValueError, match="torchrun"):
        TM.make_mesh(n_devices=2, dp=2)


@pytest.fixture(scope="module")
def tp_text(tmp_path_factory):
    jcfg, tcfg = tiny_cfgs("tp-test", embed=16, res=32, layers=1, width=32, patch=16, text_width=32, text_layers=1)
    jp = JC.init_clip_params(jax.random.PRNGKey(0), jcfg)
    tp = TV.from_jax_params(jax_params_numpy(jp), tcfg)
    rng = np.random.default_rng(0)
    sel_feats = rng.normal(size=(1, 4, 16)).astype(np.float32)   # one episode's 4 selected views
    reward_sim = (rng.uniform(-1, 1, size=(1, 4, len(NAMES))) * 0.3).astype(np.float32)
    run = launch(tmp_path_factory.mktemp("tp_text"), 4, "tp_text",
                 {"params": tp, "cfg": tcfg, "names": NAMES, "sel_feats": sel_feats, "reward_sim": reward_sim,
                  "sample_k": 2, "tp": 4})
    return jcfg, jp, tcfg, tp, sel_feats, reward_sim, run


def test_tp_text_features_match_jax(tp_text):
    jcfg, jp, tcfg, tp, _, _, run = tp_text
    assert run["n_local_classes"] == len(NAMES) // 4
    pt = JPr.build_prompt_state(jp, NAMES, ctx_init="a photo of a")
    ref = JC.normalize(JC.encode_text_embeds(jp, jcfg, JPr.splice_prompts(pt.ctx0, pt), pt.eot_idx)
                       .astype(jnp.float32))
    np.testing.assert_allclose(run["feats"].numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_tp_ctx_gradient_is_the_unsharded_gradient(tp_text):
    """The prompt classifier's context gradient of one RLCF step under tp 4,
    as its episodes take it (``step_grad_fn``: the tp text features, the
    step loss, the psum over tp), equals the unsharded gradient (JAX's and
    the port's one-process classifier's); each rank's own is only its
    classes' share. A tp-fold gradient fails here."""
    jcfg, jp, tcfg, tp, sel_feats, reward_sim, run = tp_text
    pt = JPr.build_prompt_state(jp, NAMES, ctx_init="a photo of a")
    scale = jnp.exp(jp["logit_scale"])
    jreward = JClipReward(jp, jcfg, JRewardConfig(sample_k=2))

    def loss_ref(ctx):
        tf = JC.normalize(JC.encode_text_embeds(jp, jcfg, JPr.splice_prompts(ctx, pt), pt.eot_idx)
                          .astype(jnp.float32))
        logits = scale * jnp.asarray(sel_feats[0]) @ tf.T
        return step_loss(logits, jnp.asarray(reward_sim[0]), JEpisodeConfig(sample_k=2), jreward.score_samples)

    loss, want = jax.value_and_grad(loss_ref)(pt.ctx0)
    np.testing.assert_allclose(run["grad"].numpy(), np.asarray(want), rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(run["loss"].numpy(), [float(loss)], rtol=1e-5, atol=1e-6)
    clf = PromptTTAClassifier(tp, tcfg, ClipReward(tp, tcfg, RewardConfig(sample_k=2)), EpisodeConfig(sample_k=2),
                              ctx_init="a photo of a").setup(NAMES)
    cparams, _, ctx0, pt_args, _, _ = clf.weights()
    _, mine = clf.step_grad_fn(cparams, ctx0[None], pt_args, torch.as_tensor(sel_feats), torch.as_tensor(reward_sim))
    torch.testing.assert_close(run["grad"], mine[0], rtol=2e-4, atol=2e-5)
    assert not torch.allclose(run["grad_local"], mine[0], rtol=1e-2, atol=1e-4)
    assert not torch.allclose(2 * run["grad"], mine[0], rtol=1e-2, atol=1e-4)


def test_fused_views_sharded_bit_for_bit(tmp_path):
    """Each rank draws the whole group's view parameters and keeps its rows:
    the gathered views (policy and reward tokens) equal the unsharded ones."""
    images = np.random.default_rng(3).integers(0, 256, size=(4, 3, 40, 40), dtype=np.uint8)
    kw = dict(n_views=4, resolution=32, src_size=40, p_policy=16, p_reward=8)
    run = launch(tmp_path, 2, "fused_views", {"images": images, "seed": 11, "kw": kw})
    want = fused_views(torch.as_tensor(images), torch.Generator().manual_seed(11), **kw)
    assert torch.equal(run["views"], want[0]) and torch.equal(run["reward"], want[1])
    with pytest.raises(ValueError, match="must tile dp=2"):
        fused_views_sharded(torch.as_tensor(images[:3]), torch.Generator(), TM.Mesh(2, 1), **kw)
