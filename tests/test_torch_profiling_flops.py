"""``rlcf_torch/utils/flops.py`` against ``rlcf_tpu/utils/flops.py`` (the same
FLOP counts for the towers the port runs, and ``bench.py``'s prompt-TTA
accounting) and ``rlcf_torch/utils/profiling.py`` on the CPU (a Chrome trace
written, no device memory without a card; the recorder: tests/test_torch_tracing.py)."""

import json

import pytest
import torch

from rlcf_tpu.models import clip as JC
from rlcf_tpu.utils import flops as JF
from rlcf_torch.models import clip as TC
from rlcf_torch.utils import flops as TF
from rlcf_torch.utils import profiling as TP

ARCHS = ["ViT-B/16", "ViT-L/14", "ViT-L/14@336px", "ViT-B/32"]


@pytest.mark.parametrize("arch", ARCHS)
def test_flops_equal_jax(arch):
    jcfg, tcfg = JC.get_config(arch), TC.get_config(arch)
    assert TF.vit_tower_flops(tcfg, 7) == JF.vit_tower_flops(jcfg, 7)
    assert TF.vit_tower_flops(tcfg, 2, resolution=448) == JF.vit_tower_flops(jcfg, 2, resolution=448)
    assert TF.text_tower_flops(tcfg, 200 * 24) == JF.text_tower_flops(jcfg, 200 * 24)
    assert TF.vit_flops(768, 12, 197, 768, 512) == JF.vit_flops(768, 12, 197, 768, 512)
    assert TF.transformer_decode_flops(12, 768, 67, 40) == JF.transformer_decode_flops(12, 768, 67, 40)


def test_prompt_tta_flops_is_bench_accounting():
    """``bench.py:285-301`` on the flagship: ViT-B/16 over 64 views, ViT-L/14
    over the 6 selected, the text tower over 200 prompts of 24 tokens, 3 steps."""
    p, r = JC.get_config("ViT-B/16"), JC.get_config("ViT-L/14")
    want = (64 * JF.vit_flops(p.vision_width, p.vision_layers, 197, 768, p.embed_dim)
            + 6 * JF.vit_flops(r.vision_width, r.vision_layers, 257, 588, r.embed_dim)
            + (3 * 3 + 1) * JF.text_tower_flops(p, 200 * 24))
    got = TF.prompt_tta_flops_per_image(TC.get_config("ViT-B/16"), TC.get_config("ViT-L/14"), n_views=64,
                                        selection_p=0.1, tta_steps=3, n_classes=200, text_len=24)
    assert got == want


def test_profiling_on_the_cpu(tmp_path):
    assert TP.device_memory_stats() == {}
    with TP.trace(None):
        pass
    with TP.trace(str(tmp_path / "prof")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
