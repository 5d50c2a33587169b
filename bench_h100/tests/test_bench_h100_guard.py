"""The guard against the JAX package and a run without a card."""

import os
import subprocess
import sys

import pytest

from bench_h100 import harness


@pytest.mark.parametrize("name, refused", [
    ("rlcf_tpu", True), ("rlcf_tpu.models.clip", True), ("jax", True), ("jax.numpy", True), ("jaxlib", True),
    ("flax.linen", True), ("rlcf_torch", False), ("rlcf_torch.models.clip", False), ("jaxtyping", False),
    ("rlcf_tpux", False), ("bench_h100.reference.clip", False)])
def test_the_guard_compares_whole_top_level_names(name, refused):
    assert (harness.forbidden_modules({name: None}) == [name]) == refused


def test_the_reference_loads_nothing_of_the_program():
    """The plain reference and the arithmetic import neither the program nor JAX."""
    code = ("import sys; import bench_h100.reference.prompt_tta, bench_h100.reference.views, bench_h100.arith, "
            "bench_h100.weights; print(sorted({m.split('.')[0] for m in sys.modules} & {'rlcf_torch', 'rlcf_tpu', "
            "'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_without_a_card_a_run_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "bench_h100/run.py", "--workload", "b16-l14.prompt-g4", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=harness.ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_require_cuda_does_not_fall_back_to_the_cpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        harness.require_cuda(1)
