"""The four sharded CLIs under ``python -m torch.distributed.run`` on the CPU
(gloo; ``--standalone``: the rendezvous takes a free port) against the same
flags in one process: ``tta_cls --tp 2`` and ``tta_retrieval --tp 2`` on 4
ranks (dp 2 x tp 2), ``tune_cls --dp 2`` on 2, ``tta_caption --dp 2 --tp 2``
on 4. Rank 0 alone prints and writes; what it writes equals the one-process
run's files (score matrices within 2e-4 + 2e-4 relative; the run's seconds
aside). The launcher runs in its own session and is killed, with its ranks,
past its deadline."""

import json
import os
import pathlib
import signal
import subprocess
import sys

import numpy as np
import pytest

from rlcf_torch.cli import common, tta_caption, tta_cls, tta_retrieval, tune_cls
from rlcf_torch.parallel.mesh import Mesh

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = ["--device", "cpu", "--precision", "fp32", "--resolution", "64"]
CLS = TINY + ["--test_sets", "synthetic", "--limit", "4", "--arch", "test-small", "--reward_arch", "test-small",
              "--batch_size", "8", "--tta_steps", "2", "--sample_k", "2", "--episode_group", "2"]


def torchrun(tmp_path, nproc: int, module: str, argv, timeout: float = 150.0) -> str:
    """``module`` on ``nproc`` ranks; its stdout (rank 0's)."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT", "XLA_FLAGS"):
        env.pop(k, None)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(nproc),
           "-m", module, *argv]
    proc = subprocess.Popen(cmd, env=env, cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        pytest.fail(f"{module} on {nproc} ranks passed its {timeout} s deadline:\n{err[-3000:]}")
    assert proc.returncode == 0, f"{module} on {nproc} ranks failed:\n{err[-4000:]}"
    return out


def _results(path):
    res = json.loads(pathlib.Path(path).read_text())
    return {k: {m: v for m, v in r.items() if m != "group_seconds"} for k, r in res.items()}


def test_tta_cls_tp_matches_one_process(tmp_path):
    one, four = tmp_path / "one", tmp_path / "four"
    argv = CLS + ["--viewgen", "fused", "--lr", "7e-3", "--ctx_init", "a_photo_of_a"]
    tta_cls.main(argv + ["--output", str(one)])
    out = torchrun(tmp_path, 4, "rlcf_torch.cli.tta_cls", argv + ["--tp", "2", "--output", str(four)])
    assert out.count("mesh: {'dp': 2, 'tp': 2}") == 1 and out.count("Result Summary") == 1   # rank 0 alone prints
    assert _results(four / "results.json") == _results(one / "results.json")
    journal = "progress_synthetic.jsonl"
    assert (four / journal).read_text() == (one / journal).read_text()


def test_tta_cls_tp_refuses_cocoop(monkeypatch):
    """JAX refuses --tp with --cocoop (prompt TTA only); so does the port."""
    monkeypatch.setattr(common, "run_mesh", lambda args, **kw: Mesh(1, 2))
    with pytest.raises(SystemExit, match="not supported with --cocoop"):
        tta_cls.main(CLS + ["--tp", "2", "--cocoop", "--viewgen", "native"])


def test_tune_cls_dp_matches_one_process(tmp_path):
    one, two = tmp_path / "one", tmp_path / "two"
    argv = CLS + ["--lr", "1e-4", "--momentum_update", "1", "--update_freq", "3"]
    tune_cls.main(argv + ["--output", str(one)])
    torchrun(tmp_path, 2, "rlcf_torch.cli.tune_cls", argv + ["--dp", "2", "--output", str(two)])
    assert _results(two / "results.json") == _results(one / "results.json")


@pytest.mark.parametrize("task", ["image2text", "text2image"])
def test_tta_retrieval_tp_matches_one_process(tmp_path, task):
    one, four = tmp_path / "one", tmp_path / "four"
    argv = TINY + ["--synthetic", "--arch", "test-small", "--reward_arch", "test-small", "--tta_steps", "2",
                   "--sample_k", "3", "--group_size", "4", "--retrieval_task", task]
    tta_retrieval.main(argv + ["--output", str(one)])
    torchrun(tmp_path, 4, "rlcf_torch.cli.tta_retrieval", argv + ["--tp", "2", "--output", str(four)])
    name = f"scores_{task}.npy"
    np.testing.assert_allclose(np.load(four / name), np.load(one / name), rtol=2e-4, atol=2e-4)


def test_tta_caption_dp_tp_matches_one_process(tmp_path):
    one, four = tmp_path / "one", tmp_path / "four"
    argv = TINY + ["--synthetic", "--limit", "4", "--tta_steps", "2", "--sample_k", "2", "--episode_group", "4",
                   "--clip_model_type", "test-small", "--reward_arch", "test-small"]
    tta_caption.main(argv + ["--output", str(one)])
    torchrun(tmp_path, 4, "rlcf_torch.cli.tta_caption", argv + ["--dp", "2", "--tp", "2", "--output", str(four)])
    for name in ("results_caption.json", "results_clipscore.json", "caption_trace.txt"):
        assert (four / name).read_text() == (one / name).read_text(), name
