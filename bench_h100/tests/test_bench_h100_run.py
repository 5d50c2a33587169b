"""A whole run of a tiny cell on the CPU, the look for a card skipped: the
result line's keys, and ``correct`` false under each fault the cell can have."""

import json

import pytest
import torch

from bench_h100 import faults, harness
from bench_h100.tests import tiny

KEYS = ("correct", "attempted", "failed", "metrics", "device")


def last_line(result, checks, capsys):
    harness.emit(result, checks)
    out = capsys.readouterr()
    return json.loads(out.out.strip().splitlines()[-1]), out.err.strip().splitlines()


@pytest.mark.parametrize("ensemble", [False, True])
def test_a_sound_run_is_correct_and_its_line_has_the_result_keys(ensemble, capsys):
    line, err = last_line(*tiny.run(ensemble=ensemble), capsys)
    keys = list(line)
    assert tuple(keys[:5]) == KEYS and keys[-1] == "check" and set(keys) <= set(KEYS) | {"breakdown", "check"}
    assert line["correct"] is True, line["check"]
    assert set(line["metrics"]) == {"items_per_s", "item_ms_p90", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    assert [e.split(":")[0] for e in err[-len(tiny.LIMITS):]] == [f"check {k}" for k in tiny.LIMITS]


def test_a_traced_run_reads_its_per_layer_metrics(capsys):
    metrics = [{"name": n, "unit": "x"} for n in ("kernels_per_item", "idle_share", "peak_mem_gib", "mfu",
                                                 "viewgen_ms", "augmix_ms", "attn_roofline")]
    line, _ = last_line(*tiny.run(trace=1, metrics=metrics), capsys)
    assert list(line)[-2:] == ["breakdown", "check"] and line["correct"] is True
    assert {"busy_s", "window_s"} <= set(line["device"])
    # no device kernels on the CPU: the readers of kernel time find nothing and the line leaves them out
    assert "augmix_ms" not in line["metrics"] and "attn_roofline" not in line["metrics"]
    assert line["metrics"]["mfu"]["value"] > 0


@pytest.mark.parametrize("fault, ensemble", [(f, e) for f, (paths, *_) in faults.FAULTS.items()
                                             for e in (False, True) if ("device" if e else "fused") in paths])
def test_a_fault_in_the_timed_path_makes_the_run_incorrect(fault, ensemble):
    with faults.plant(fault):
        result, checks = tiny.run(ensemble=ensemble)
    assert result["correct"] is False, checks


def test_the_control_fails_where_the_program_passes():
    """The reference one precision below the configuration's (views in
    bfloat16, towers in float8, the selection's entropies in bfloat16) in the
    program's place fails the limits that the program keeps, reading far
    above the program wherever the towers' precision shows."""
    from bench_h100.drivers import prompt_tta

    cpu = torch.device("cpu")
    program = prompt_tta.program_readings(tiny.config(), tiny.traffic(), 5, 2, cpu)
    control = prompt_tta.control_readings(tiny.config(), tiny.traffic(), 5, cpu)
    assert all(program[k] <= v for k, v in tiny.LIMITS.items()), program
    assert any(control[k] > v for k, v in tiny.LIMITS.items()), control
    assert all(control[k] > 3 * max(tiny.LIMITS[k], program[k])
               for k in ("views", "text_gap", "feature_gap", "reward_gap", "topk_gap", "grad_dev", "step_gap")), control


# The card's float32 path runs the attention kernels on split TF32 operands, which round otherwise than
# the plain reference; the tiny towers' episodes move the logits little (most reward similarities are
# below 0, so most sampled classes score 0), so that rounding reads large against the move in
# ``answer_gap``: the card's limit there is the tiny cell's sound reading on the card (0.119) with
# room, far below a fault's (an altered answer reads 1.3 and more, a state left unchanged 1).
CARD_LIMITS = dict(tiny.LIMITS, answer_gap=0.3)


@pytest.mark.cuda
@pytest.mark.parametrize("ensemble", [False, True])
def test_a_tiny_run_on_the_card_is_correct(ensemble):
    """The tiny cell through the port's kernels on the card (float32: the
    attention kernels' split-TF32 path and the AugMix kernel) is correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on the card")
    result, checks = tiny.run(ensemble=ensemble, device="cuda", limits=CARD_LIMITS)
    assert result["correct"] is True, checks
    assert result["device"]["platform"] == "gpu"
