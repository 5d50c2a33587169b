"""Every text tower takes the fused attention kernel on the card, whatever its
vision tower is (the JAX package's rule for text towers, ``best_attn(None)``):
with the card's choice patched in (``best_attn`` asked for ``cuda``; on CPU
tensors ``"fused"`` runs the kernel's plain version), each call site's text
tower is recorded under ResNet policies and a ResNet reward, where the
vision towers' own choice is dense."""

import numpy as np
import pytest
import torch

from rlcf_torch.core.episode import EpisodeConfig
from rlcf_torch.core.reward import ClipReward, RewardConfig
from rlcf_torch.models import clip as TC
from rlcf_torch.tokenizer import tokenize

NAMES = ["goldfish", "tiger cat", "airliner"]


@pytest.fixture
def recorded(monkeypatch):
    """(text-tower attns, image-tower attns) passed while the card's choice is patched in."""
    text, image = [], []
    best_attn, encode_text_embeds, encode_image = TC.best_attn, TC.encode_text_embeds, TC.encode_image
    monkeypatch.setattr(TC, "best_attn", lambda cfg=None, device="cpu": best_attn(cfg, "cuda"))

    def text_tower(*a, attn="dense", **k):
        text.append(attn)
        return encode_text_embeds(*a, attn=attn, **k)

    def image_tower(*a, attn="dense", **k):
        image.append(attn)
        return encode_image(*a, attn=attn, **k)

    monkeypatch.setattr(TC, "encode_text_embeds", text_tower)
    monkeypatch.setattr(TC, "encode_image", image_tower)
    return text, image


@pytest.fixture(scope="module")
def resnet():
    cfg = TC.ClipConfig("rn", 64, 64, (1, 1, 1, 1), 16, None, 64, 2)   # test-tiny-rn with the full vocabulary
    return cfg, TC.init_clip_params(cfg, seed=0), TC.init_clip_params(cfg, seed=1)


def _views(n=2, v=4, res=64):
    return np.random.default_rng(0).integers(0, 256, size=(n, v, res, res, 3), dtype=np.uint8)


def _check(text, image):
    assert text and set(text) == {"fused"}, text
    assert set(image) <= {"dense"}, image   # the ResNet towers' choice stays dense


def test_reward_class_features(recorded, resnet):
    cfg, _, rparams = resnet
    reward = ClipReward(rparams, cfg, RewardConfig())
    reward.set_class_features(tokenize(NAMES))
    reward.text_features(torch.as_tensor(tokenize(NAMES[:1]).astype(np.int64)))
    _check(*recorded)


def test_prompt_tta_resnet_policy(recorded, resnet):
    from rlcf_torch.tasks.classification import PromptTTAClassifier

    cfg, params, rparams = resnet
    clf = PromptTTAClassifier(params, cfg, ClipReward(rparams, cfg, RewardConfig(sample_k=2)),
                              EpisodeConfig(tta_steps=1, selection_p=0.5, sample_k=2)).setup(NAMES)
    clf.adapt(_views())
    _check(*recorded)


def test_encoder_tta_resnet_policy(recorded, resnet):
    from rlcf_torch.tasks.classification import EncoderTTAClassifier

    cfg, params, rparams = resnet
    EncoderTTAClassifier(params, cfg, ClipReward(rparams, cfg, RewardConfig()), EpisodeConfig()).setup(NAMES)
    _check(*recorded)


def test_cocoop_resnet_policy(recorded, resnet):
    from rlcf_torch.tasks.classification import CoCoOpTTAClassifier

    cfg, params, _ = resnet
    CoCoOpTTAClassifier(params, cfg, EpisodeConfig(tta_steps=1, selection_p=0.5, loss="tpt")).setup(NAMES).adapt(
        _views())
    _check(*recorded)


def test_bongard_resnet_policy(recorded, resnet):
    from rlcf_torch.tasks.bongard import BongardTTA

    cfg, params, _ = resnet
    tta = BongardTTA(params, cfg, EpisodeConfig(tta_steps=1), ctx_init="a photo of a").setup()
    labels = np.tile(np.array([0] * 6 + [1] * 6, dtype=np.int32), (1, 1))
    tta.adapt_tasks(_views(1, 14), labels)
    _check(*recorded)


@pytest.mark.parametrize("direction", ["i2t", "t2i"])
def test_retrieval_resnet_policy(recorded, resnet, direction):
    from rlcf_torch.tasks.retrieval import RetrievalTTA

    cfg, params, rparams = resnet
    tta = RetrievalTTA(params, cfg, ClipReward(rparams, cfg, RewardConfig(sample_k=2)),
                       EpisodeConfig(tta_steps=1, sample_k=2, adam_eps=1e-6), direction=direction)
    if direction == "i2t":
        tta.set_text_gallery(["a dog on a beach", "a red car", "two cats"])
        tta.adapt_queries(np.random.default_rng(1).normal(size=(2, 64, 64, 3)).astype(np.float32))
    else:
        gallery = np.random.default_rng(1).normal(size=(3, 64, 64, 3)).astype(np.float32)
        tta.set_image_gallery([gallery], [gallery])
        tta.adapt_queries(tokenize(["a dog on a beach", "a red car"]))
    _check(*recorded)
