"""Whole ``tta_retrieval`` runs against the JAX package's CLI, from one
OpenAI-format checkpoint per tower (fp32, ``test-small``, both directions):
on its ``--synthetic`` gallery and on a karpathy-format annotation file
over a small image tree (the smoke script's writer). Each direction's score
matrix within 2e-4 + 2e-4 relative, the same R@k metrics, the same output
files; and the options the port refuses, each naming its item."""

import json

import numpy as np
import pytest
import torch

from rlcf_tpu.models import clip as JC
from rlcf_tpu.tasks import retrieval as JR
from rlcf_torch.tasks import retrieval as TR

from torch_port_fixtures import chip_smoke, openai_state_dict

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    paths = []
    for seed in (0, 1):
        paths.append(str(root / f"clip{seed}.pt"))
        torch.save(openai_state_dict(JC.get_config("test-small"), seed=seed), paths[-1])
    return paths


def _run_both(argv, tmp_path):
    """The JAX CLI, then the port's (``--device cpu``), each engine's ``run``
    recorded: {package: (result, [score matrices in direction order])}."""
    from rlcf_tpu.cli import tta_retrieval as jcli
    from rlcf_torch.cli import tta_retrieval as tcli

    out = {}
    for name, cli, owner in (("jax", jcli, JR.RetrievalTTA), ("torch", tcli, TR.RetrievalTTA)):
        seen, run = [], owner.run

        def recording(self, *a, _run=run, _seen=seen, **k):
            scores = _run(self, *a, **k)
            _seen.append((self.direction, scores))
            return scores

        owner.run = recording
        try:
            extra = ["--device", "cpu"] if name == "torch" else []
            out[name] = (cli.main(argv + extra + ["--output", str(tmp_path / name)]), seen)
        finally:
            owner.run = run
    return out


def _argv(checkpoints, *extra):
    return ["--arch", "test-small", "--reward_arch", "test-small", "--clip_checkpoint", checkpoints[0],
            "--reward_checkpoint", checkpoints[1], "--precision", "fp32", "--resolution", "64", "--tta_steps", "2",
            "--lr", "1e-3", "--sample_k", "3", "--group_size", "4", *extra]


def _assert_same(out, tmp_path, n_img, n_txt, t2i_up_to_row_shift=False):
    (tres, tseen), (jres, jseen) = out["torch"], out["jax"]
    assert [d for d, _ in tseen] == [d for d, _ in jseen] == ["i2t", "t2i"]
    for (d, ts), (_, js), shape in zip(tseen, jseen, ((n_img, n_txt), (n_txt, n_img))):
        assert ts.shape == shape and (ts > -100).all()
        if d == "t2i" and t2i_up_to_row_shift:
            ts, js = (x - x.mean(axis=1, keepdims=True) for x in (ts, js))
        np.testing.assert_allclose(ts, js, **TOL)
    assert tres["metrics"] == jres
    assert set(tres["group_seconds"]) == {"i2t", "t2i"} and len(tres["group_seconds"]["t2i"]) == -(-n_txt // 4)
    for name in ("results_retrieval.json", "evaluate.txt", "hparams_retrieval.json"):
        assert (tmp_path / "torch" / name).exists() and (tmp_path / "jax" / name).exists()
    assert json.loads((tmp_path / "torch" / "results_retrieval.json").read_text()) == json.loads(
        (tmp_path / "jax" / "results_retrieval.json").read_text())


def test_annotation_run_matches_jax(tmp_path, checkpoints):
    """Images decoded and preprocessed from files (PIL), captions through the
    BLIP cleaning, the RLCF loss."""
    ann, root = chip_smoke.write_retrieval_tree(tmp_path / "coco", 5, caps_per_image=2, size=(40, 72))
    _assert_same(_run_both(_argv(checkpoints, "--annotations", ann, "--vis_root", root), tmp_path), tmp_path, 5, 10)


@pytest.mark.parametrize("loss", [[], ["--loss", "kd", "--kd_loss", "DKD"]], ids=["rlcf", "dkd"])
def test_synthetic_run_matches_jax(tmp_path, checkpoints, loss):
    """The fabricated gallery, under the RLCF loss and the DKD variant. Under
    DKD the t2i rows are held up to a shift of each row: a distillation loss
    is blind to a shift of a row's logits, and the text tower's features
    move along such a direction (the gallery features of random towers lie
    close together) by AdamW's +-lr steps on rounding noise (ROADMAP C3), up
    to ~3e-3 apart between the packages in the final forward. A shift leaves
    every rank, and so the metrics, as they are."""
    out = _run_both(_argv(checkpoints, "--synthetic", *loss), tmp_path)
    _assert_same(out, tmp_path, 6, 12, t2i_up_to_row_shift=bool(loss))


def test_single_direction_saves_its_scores(tmp_path, checkpoints):
    from rlcf_torch.cli import tta_retrieval as tcli

    res = tcli.main(_argv(checkpoints, "--synthetic", "--retrieval_task", "text2image", "--device", "cpu",
                          "--output", str(tmp_path)))
    assert res["metrics"] is None and list(res["group_seconds"]) == ["t2i"]
    assert np.load(tmp_path / "scores_text2image.npy").shape == (12, 6)


@pytest.mark.parametrize("flags,item", [(["--tp", "2"], "A14"), (["--download", "1"], "A15"),
                                        (["--multiple_reward_models", "1"], "single reward CLIP")])
def test_unported_options_are_refused(flags, item):
    """--tp (ROADMAP A14) is ported: in a single process the mesh's error names the launcher."""
    from rlcf_torch.cli import tta_retrieval as tcli

    if item == "A14":
        with pytest.raises(ValueError, match="torchrun"):
            tcli.main(["--synthetic", "--device", "cpu", *flags])
        return
    with pytest.raises(SystemExit, match=item):
        tcli.main(["--synthetic", "--device", "cpu", *flags])


def test_dry_run(capsys):
    from rlcf_torch.cli import tta_retrieval as tcli

    assert tcli.main(["--synthetic", "--retrieval_task", "image2text", "--dry_run"]) is None
    printed = json.loads(capsys.readouterr().out.split("DRY RUN OK: ", 1)[1])
    assert printed["retrieval_task"] == "image2text" and printed["device"] == "cuda"
    assert "synthetic_classes" not in printed   # no flag the JAX CLI lacks, but --device


def test_no_card_is_refused(monkeypatch, tmp_path):
    """The entry point runs on the card unless --device cpu is given: with no
    card it fails, and goes on neither on the CPU nor anywhere else."""
    from rlcf_torch.cli import tta_retrieval as tcli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--synthetic", "--output", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
