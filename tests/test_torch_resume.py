"""``tta_cls --resume`` on the CPU: the progress journal (JAX's
``progress_<set>.jsonl``, one ``{"n", "c1", "c5"}`` line a group) of a run
and its resumption equals that of one uninterrupted run, with the same
counts, and equals the JAX CLI's journal on the same synthetic set and
weights (one OpenAI-format checkpoint per tower)."""

import json

import pytest
import torch

from rlcf_tpu.models import clip as JC

from torch_port_fixtures import openai_state_dict


@pytest.fixture(scope="module")
def argv(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    paths = []
    for seed in (0, 1):
        paths.append(str(root / f"clip{seed}.pt"))
        torch.save(openai_state_dict(JC.get_config("test-small"), seed=seed), paths[-1])
    return [".", "--test_sets", "synthetic", "--arch", "test-small", "--reward_arch", "test-small",
            "--clip_checkpoint", paths[0], "--reward_checkpoint", paths[1], "--precision", "fp32", "--resolution", "64",
            "--batch_size", "8", "--tta_steps", "1", "--sample_k", "2", "--selection_p", "0.25", "--lr", "7e-3",
            "--ctx_init", "a_photo_of_a", "--viewgen", "native", "--episode_group", "2"]


def _journal(out):
    with open(out / "progress_synthetic.jsonl") as fh:
        return [json.loads(line) for line in fh]


def _port(argv, out, *extra):
    from rlcf_torch.cli import tta_cls

    return tta_cls.main(argv + ["--device", "cpu", "--output", str(out), *extra])["synthetic"]


def test_resumed_run_equals_one_run(argv, tmp_path, capsys):
    """--limit 4, then --limit 10 --resume into the same output: the second
    run passes over the 4 samples the journal holds, draws its groups' views
    from the seeds after theirs, and ends with the journal and counts of one
    --limit 10 run (the last group of 2 samples too)."""
    first = _port(argv, tmp_path / "a", "--limit", "4")
    assert first["n"] == 4 and len(_journal(tmp_path / "a")) == 2
    resumed = _port(argv, tmp_path / "a", "--limit", "10", "--resume")
    assert "resuming synthetic: 4 samples already scored" in capsys.readouterr().out
    assert len(resumed["group_seconds"]) == 3   # only the groups after the journal's ran
    one = _port(argv, tmp_path / "b", "--limit", "10")
    assert _journal(tmp_path / "a") == _journal(tmp_path / "b") and len(_journal(tmp_path / "b")) == 5
    assert {k: resumed[k] for k in ("n", "c1", "c5", "top1", "top5")} == \
        {k: one[k] for k in ("n", "c1", "c5", "top1", "top5")}


def test_journal_and_counts_equal_jax_cli(argv, tmp_path):
    from rlcf_tpu.cli import tta_cls as jcli

    jres = jcli.main(argv + ["--limit", "6", "--output", str(tmp_path / "jax")])["synthetic"]
    tres = _port(argv, tmp_path / "torch", "--limit", "6")
    assert _journal(tmp_path / "torch") == _journal(tmp_path / "jax")
    assert (tres["top1"], tres["top5"]) == (jres["top1"], jres["top5"])
