"""Retrieval's host pieces against ``rlcf_tpu``: the R@k metrics on random
score matrices with ties, the BLIP caption cleaning and the karpathy-format
annotation loader bit for bit, and ``load_config`` on the retrieval
experiment configs with dot-list overrides."""

import json
import pathlib

import numpy as np
import pytest

from rlcf_tpu.metrics import retrieval as JM
from rlcf_tpu.tasks import retrieval as JR
from rlcf_tpu.utils import config as JCfg
from rlcf_torch.metrics import retrieval as TM
from rlcf_torch.tasks import retrieval as TR
from rlcf_torch.utils import config as TCfg

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _gallery(n_img, caps, seed):
    rng = np.random.default_rng(seed)
    img2txt, txt2img, tid = {}, {}, 0
    for i in range(n_img):
        img2txt[i] = []
        for _ in range(int(rng.integers(1, caps + 1))):
            img2txt[i].append(tid)
            txt2img[tid] = i
            tid += 1
    # scores rounded to a coarse grid: many ties, which argsort must break alike
    s_i2t = np.round(rng.normal(size=(n_img, tid)), 1).astype(np.float32)
    s_t2i = np.round(rng.normal(size=(tid, n_img)), 1).astype(np.float32)
    return s_i2t, s_t2i, txt2img, img2txt


@pytest.mark.parametrize("n_img,caps,seed", [(2, 2, 0), (7, 5, 1), (40, 5, 2), (13, 1, 3)])
def test_retrieval_metrics_match_jax(n_img, caps, seed):
    s_i2t, s_t2i, txt2img, img2txt = _gallery(n_img, caps, seed)
    np.testing.assert_array_equal(TM._ranks_i2t(s_i2t, img2txt), JM._ranks_i2t(s_i2t, img2txt))
    np.testing.assert_array_equal(TM._ranks_t2i(s_t2i, txt2img), JM._ranks_t2i(s_t2i, txt2img))
    assert TM.retrieval_metrics(s_i2t, s_t2i, txt2img, img2txt) == JM.retrieval_metrics(s_i2t, s_t2i, txt2img,
                                                                                        img2txt)


@pytest.mark.parametrize("caption,prompt,max_words", [
    ('A Man "Rides"! a wave.', "", 50), ("  Two   dogs; playing (in) the snow~  \n", "", 50),
    (" ".join(["word"] * 60), "", 50), ("hi", "a photo of ", 50), ("A*B#C:D", "", 2), ("", "", 50)])
def test_blip_caption_process_matches_jax(caption, prompt, max_words):
    assert TR.blip_caption_process(caption, prompt, max_words) == JR.blip_caption_process(caption, prompt, max_words)


@pytest.mark.parametrize("process_text", [True, False])
def test_load_karpathy_annotations_matches_jax(tmp_path, process_text):
    ann = [{"image": "val/a.jpg", "caption": ["A man RIDES a wave.", "cap two!"]},
           {"image": "val/b.png", "caption": "a single caption (no list)"},
           {"image": "c.jpg", "caption": ["x", "y", "z"]}]
    path = tmp_path / "ann.json"
    path.write_text(json.dumps(ann))
    t = TR.load_karpathy_annotations(str(path), "/imgs", process_text=process_text)
    j = JR.load_karpathy_annotations(str(path), "/imgs", process_text=process_text)
    assert (t.image_paths, t.texts, t.img2txt, t.txt2img) == (j.image_paths, j.texts, j.img2txt, j.txt2img)


@pytest.mark.parametrize("name,overrides", [
    ("exp_coco_ret_tta.yaml", []),
    ("exp_coco_ret_tta.yaml", ["lr=2e-6", "run.seed=3", "sample_k=16", "retrieval_task=image2text"]),
    ("exp_flickr_ret_tta.yaml", ["tta_steps=4", "model.reward.arch=ViT-L/14", "flag=true"])])
def test_load_config_matches_jax(name, overrides):
    path = str(ROOT / "configs" / name)
    cfg = TCfg.load_config(path, overrides)
    assert cfg == JCfg.load_config(path, overrides) and cfg["arch"] == "ViT-B/16"
    from rlcf_tpu.core.episode import EpisodeConfig as JEp
    from rlcf_torch.core.episode import EpisodeConfig as TEp

    import dataclasses
    assert dataclasses.asdict(TCfg.materialize(TEp, cfg)) == dataclasses.asdict(JCfg.materialize(JEp, cfg))


def test_load_config_refuses_a_bad_override():
    with pytest.raises(ValueError, match="key=value"):
        TCfg.load_config(None, ["lr"])
