"""The port's caption metrics and CLIPScore evaluation against the JAX
package's: the copied BLEU / ROUGE-L / CIDEr-D / METEOR scorers on
``tests/test_caption_metrics.py``'s inputs (equal), and
``rlcf_torch.cli.clipscore_eval --device cpu`` against
``rlcf_tpu.cli.clipscore_eval`` on one synthetic tree with the same
OpenAI-format ViT checkpoint, fp32: CLIPScore and RefCLIPScore within 1e-5,
the reference metrics equal."""

import json

import numpy as np
import pytest
import torch

from rlcf_tpu.metrics import caption_metrics as JMet
from rlcf_torch.cli import clipscore_eval
from rlcf_torch.metrics import caption_metrics as TMet
from test_caption_metrics import CANDS, PERFECT, REFS
from torch_port_fixtures import chip_smoke, openai_state_dict, tiny_cfgs
from torch_port_fixtures import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("cands", [CANDS, PERFECT], ids=["candidates", "perfect"])
def test_caption_metrics_match_jax(cands):
    assert TMet.get_all_metrics(REFS, cands) == JMet.get_all_metrics(REFS, cands)
    for fn in ("bleu", "rouge_l", "cider_d", "_meteor_exact"):
        assert getattr(TMet, fn)(REFS, cands) == getattr(JMet, fn)(REFS, cands), fn
    for text in cands + [r for refs in REFS for r in refs] + ["The dog's (big) ball -- isn't it?"]:
        assert TMet.ptb_tokenize(text) == JMet.ptb_tokenize(text)


def test_ensure_wordnet_only_probes(monkeypatch):
    """The port's ``ensure_wordnet`` downloads nothing: it probes again."""
    import nltk

    monkeypatch.setattr(nltk, "download", lambda *a, **k: pytest.fail("ensure_wordnet downloaded"))
    assert TMet.ensure_wordnet() == JMet.meteor_mode()


@pytest.fixture(scope="module")
def scored(tmp_path_factory):
    """A tree of 3 images with 2 references each, candidates, a ViT
    checkpoint, and the JAX CLI's summary and per-instance scores."""
    from rlcf_tpu.cli import clipscore_eval as jax_cli

    root = tmp_path_factory.mktemp("clipscore")
    _, images = chip_smoke.write_caption_tree(str(root / "coco"), 3, caps_per_image=2, size=(40, 56))
    with open(root / "coco" / "references.json") as fh:
        refs = json.load(fh)
    candidates = {k: v[0].lower() if i != 1 else "a purple elephant juggling" for i, (k, v) in enumerate(refs.items())}
    with open(root / "candidates.json", "w") as fh:
        json.dump(candidates, fh)
    torch.save(openai_state_dict(tiny_cfgs()[1], seed=3), str(root / "scorer.pt"))
    argv = lambda tag: [str(root / "candidates.json"), images, "--references_json",
                        str(root / "coco" / "references.json"), "--clip_checkpoint", str(root / "scorer.pt"),
                        "--resolution", "32", "--out_json", str(root / f"{tag}.json"),
                        "--save_per_instance", str(root / f"{tag}_per.json")]
    want = jax_cli.main(argv("jax"))
    return {"root": root, "argv": argv, "want": want}


def test_clipscore_eval_matches_jax(scored):
    root = scored["root"]
    got = clipscore_eval.main(scored["argv"]("port") + ["--device", "cpu"])
    want = scored["want"]
    for key in ("clipscore", "ref_clipscore"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-5)
    for key in ("bleu", "meteor", "rouge", "cider", "meteor_mode", "caption_metrics_backend"):
        assert got[key] == want[key], key
    per = [json.load(open(root / f"{tag}_per.json")) for tag in ("port", "jax")]
    assert list(per[0]) == list(per[1])
    for k in per[1]:
        for m in ("CLIPScore", "RefCLIPScore"):
            np.testing.assert_allclose(per[0][k][m], per[1][k][m], rtol=1e-5, atol=1e-5)
    summary = [json.load(open(root / f"{tag}.json")) for tag in ("port", "jax")]
    assert sorted(summary[0]) == sorted(summary[1]) and summary[0]["n_images"] == 3


def test_clipscore_eval_refusals_and_dry_run(scored, capsys):
    with pytest.raises(SystemExit, match="download_nltk"):
        clipscore_eval.main(scored["argv"]("x") + ["--download_nltk", "1"])
    assert clipscore_eval.main(scored["argv"]("x") + ["--dry_run"]) is None
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1][len("DRY RUN OK: "):])["precision"] == "fp32"
