"""The port stands alone: no module of ``rlcf_torch`` (nor ``chip_smoke.py``)
imports JAX, optax, the JAX package or ``transformers``."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "optax", "rlcf_tpu", "transformers")
SOURCES = sorted((ROOT / "rlcf_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    assert not _imported_roots(path) & set(FORBIDDEN), f"{path} imports {_imported_roots(path) & set(FORBIDDEN)}"


def test_cli_import_leaves_jax_unloaded():
    """... and PyYAML, which only ``utils/config.py::load_config`` imports, when it reads a config."""
    code = ("import sys, rlcf_torch.cli.tta_cls, rlcf_torch.cli.tune_cls, rlcf_torch.tasks.classification, "
            "rlcf_torch.core.policy, rlcf_torch.core.episode, rlcf_torch.ops.attention, rlcf_torch.ops.augmix, "
            "rlcf_torch.cli.tta_retrieval, rlcf_torch.tasks.retrieval, rlcf_torch.metrics.retrieval, "
            "rlcf_torch.utils.config, rlcf_torch.cli.tta_caption, rlcf_torch.cli.clipscore_eval, "
            "rlcf_torch.tasks.caption, rlcf_torch.models.opt, rlcf_torch.models.mappers, rlcf_torch.metrics.clipscore, "
            "rlcf_torch.metrics.caption_metrics, rlcf_torch.tokenizer_gpt2, rlcf_torch.models.gpt2, "
            "rlcf_torch.data.sharded_embeddings, rlcf_torch.cli.extract_features, rlcf_torch.cli.train_caption, "
            "rlcf_torch.cli.export_serving, rlcf_torch.utils.export, rlcf_torch.utils.profiling, rlcf_torch.utils.flops, "
            "rlcf_torch.core.runner, rlcf_torch.data.native, rlcf_torch.data.transforms; "
            "bad = [m for m in ('jax', 'optax', 'rlcf_tpu', 'yaml', 'transformers', 'regex') if m in sys.modules]; "
            "assert not bad, bad; print('ok')")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-2000:]


def test_serving_loader_imports_no_model_code():
    """A serving process needs the ``rlcf::`` ops, not the models: importing
    the export module loads, of the port, only the attention ops and their build."""
    code = ("import sys, rlcf_torch.utils.export; "
            "print(sorted(m for m in sys.modules if m.startswith('rlcf_torch')))")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert eval(res.stdout.strip()) == ["rlcf_torch", "rlcf_torch.ops", "rlcf_torch.ops.attention",
                                        "rlcf_torch.ops.cuda_build", "rlcf_torch.utils", "rlcf_torch.utils.export"]
