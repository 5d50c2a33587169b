"""The smoke script's parallelism phase (4j) rehearsed on the CPU: its rank
script under torchrun (``launch_ranks``: one launch runs several CLIs in
turn, every rank writes its record, rank 0 what the engine returned), held
to the same flags in one process, and its comparison of sharded and
one-process groups (``compare_group_logits``, ``swaps_at_boundary``)."""

import importlib.util
import pathlib

import pytest
import torch

from rlcf_torch.cli import tta_cls, tune_cls
from rlcf_torch.tasks.classification import EncoderTTAClassifier, PromptTTAClassifier

_PATH = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
_SPEC = importlib.util.spec_from_file_location("chip_smoke", _PATH)
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)

CLS = ["--device", "cpu", "--test_sets", "synthetic", "--limit", "2", "--arch", "test-small", "--reward_arch",
       "test-small", "--precision", "fp32", "--resolution", "64", "--batch_size", "8", "--tta_steps", "2",
       "--sample_k", "2", "--episode_group", "2", "--viewgen", "fused"]
ENCODER = ["--device", "cpu", "--test_sets", "synthetic", "--limit", "2", "--arch", "test-small", "--reward_arch",
           "test-small", "--precision", "fp32", "--resolution", "64", "--batch_size", "8", "--tta_steps", "2",
           "--sample_k", "2", "--episode_group", "2", "--lr", "1e-3"]
RETRIEVAL = ["--device", "cpu", "--synthetic", "--arch", "test-small", "--reward_arch", "test-small", "--precision",
             "fp32", "--resolution", "64", "--tta_steps", "1", "--sample_k", "3", "--group_size", "4",
             "--retrieval_task", "image2text", "--tp", "2"]


def test_launch_ranks_runs_the_clis_in_turn(tmp_path):
    runs = [{"name": "tp cls", "module": "rlcf_torch.cli.tta_cls", "argv": CLS + ["--tp", "2", "--output",
                                                                                 str(tmp_path / "cls")],
             "record": ("rlcf_torch.tasks.classification", "PromptTTAClassifier", "_run_group")},
            {"name": "tp retrieval", "module": "rlcf_torch.cli.tta_retrieval",
             "argv": RETRIEVAL + ["--output", str(tmp_path / "ret")],
             "record": ("rlcf_torch.tasks.retrieval", "RetrievalTTA", "adapt_queries")}]
    out, wall = chip_smoke.launch_ranks(str(tmp_path), 4, runs, timeout=150)
    assert wall > 0 and sorted(out) == ["tp cls", "tp retrieval"]
    for name, (ranks, recorded) in out.items():
        assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
        assert all(r["backend"] == "gloo" and r["world"] == 4 and r["ranks_per_device"] == 1 for r in ranks)
        assert all(set(r["launches"]) == {"fwd", "bwd", "augmix"} for r in ranks)   # 0 on the CPU: plain versions
    assert len(out["tp retrieval"][1]) == 2 and out["tp retrieval"][1][0].shape == (4, 12)
    with chip_smoke.recorded_calls(PromptTTAClassifier, "_run_group") as want:
        tta_cls.main(CLS + ["--output", str(tmp_path / "one")])
    got = out["tp cls"][1]
    summary = chip_smoke.compare_group_logits("tp cls", got, want, 1, [torch.zeros(2, 8)])
    assert summary["selections_equal"] and summary["max_abs_logit_diff"] <= 2e-4


def test_compare_group_logits_reports_a_near_tie_and_refuses_the_rest():
    logits = torch.zeros(1, 3)
    one = [(logits, {"selected": torch.tensor([[0, 1]])})]
    swapped = [(logits, {"selected": torch.tensor([[0, 2]])})]
    tie = [torch.tensor([[0.0, 1.0, 1.0 + 1e-5, 3.0]])]   # the 2nd and 3rd lowest entropies within 2e-4
    apart = [torch.tensor([[0.0, 1.0, 2.0, 3.0]])]
    summary = chip_smoke.compare_group_logits("x", swapped, one, 2, tie)
    assert summary["near_tie_groups"] == [0] and summary["views_swapped"] == 1
    with pytest.raises(AssertionError, match="off a near-tie"):
        chip_smoke.compare_group_logits("x", swapped, one, 2, apart)
    # a near-tie at the boundary does not excuse a swap of views away from it
    far = [(logits, {"selected": torch.tensor([[2, 3]])})]
    with pytest.raises(AssertionError, match="off a near-tie"):
        chip_smoke.compare_group_logits("x", far, one, 2, tie)
    reordered = [(logits, {"selected": torch.tensor([[1, 0]])})]
    assert chip_smoke.compare_group_logits("x", reordered, one, 2, apart)["selections_equal"]
    with pytest.raises(AssertionError, match="logits differ"):
        chip_smoke.compare_group_logits("x", [(logits + 1e-3, one[0][1])], one, 2, apart)
    # a row swapped at the near-tie adapted on another view: its logits are held against the one-process
    # run made again on the sharded selection, and without such a run against the one process's
    moved = [(logits + 0.5, {"selected": torch.tensor([[0, 2]])})]
    with pytest.raises(AssertionError, match="logits differ"):
        chip_smoke.compare_group_logits("x", moved, one, 2, tie)
    on_swapped = lambda out: (lambda sel: [(out, {"selected": s}) for s in sel])
    summary = chip_smoke.compare_group_logits("x", moved, one, 2, tie, rerun=on_swapped(logits + 0.5))
    assert summary["views_swapped"] == 1 and summary["logits_held_on"] == "the sharded selections"
    with pytest.raises(AssertionError, match="logits differ"):   # an unbounded move fails
        chip_smoke.compare_group_logits("x", moved, one, 2, tie, rerun=on_swapped(logits))
    with pytest.raises(AssertionError, match="did not select them"):
        chip_smoke.compare_group_logits("x", moved, one, 2, tie, rerun=lambda sel: one)


@pytest.mark.parametrize("cli,argv,owner", [(tta_cls, CLS, PromptTTAClassifier),
                                            (tune_cls, ENCODER, EncoderTTAClassifier)], ids=["prompt", "encoder"])
def test_one_process_runs_again_on_forced_selections(tmp_path, cli, argv, owner):
    """The rerun that holds a swapped row: each group's selection is the one
    forced, the row whose selection moved adapts on its new view, the other
    rows' logits stay as they were."""
    want, ent = chip_smoke.one_process(cli, argv + ["--output", str(tmp_path / "one")], owner, "_run_group")
    assert len(ent) == len(want) == 1 and ent[0].shape == (2, 8)
    forced = [aux["selected"].clone() for _, aux in want]
    forced[0][0, -1] = min(set(range(8)) - set(forced[0][0].tolist()))
    got, _ = chip_smoke.one_process(cli, argv + ["--output", str(tmp_path / "forced")], owner, "_run_group",
                                    forced)
    assert all(torch.equal(aux["selected"], sel) for (_, aux), sel in zip(got, forced))
    assert not torch.equal(got[0][0][0], want[0][0][0])
    torch.testing.assert_close(got[0][0][1], want[0][0][1])
    with pytest.raises(AssertionError, match="forced selection"):
        chip_smoke.one_process(cli, argv + ["--output", str(tmp_path / "short")], owner, "_run_group",
                               [forced[0][:, :0]])
