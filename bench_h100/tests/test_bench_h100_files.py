"""Every file a cell needs is found by its name, and BENCHMARK.json keeps
to the shape its contract gives it."""

import importlib
import json
import os
import re

import pytest

from bench_h100 import harness

with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as fh:
    BENCH = json.load(fh)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_each_cells_files_are_found_by_name(workload):
    cell, config, traffic, limits = harness.find_cell(BENCH, workload)
    assert config["name"] == cell["config"]
    driver = importlib.import_module(f"bench_h100.drivers.{traffic['kind']}")
    assert set(limits) == set(driver.COMPARED)
    for trace in (False, True):
        for m in harness.cell_metrics(BENCH, workload, trace):
            if trace:
                assert importlib.import_module(f"bench_h100.metrics.{m['name']}").read
    assert {m["name"] for m in harness.cell_metrics(BENCH, workload, False)} >= {"items_per_s", "setup_s"}
    assert harness.cell_metrics(BENCH, workload, True)


def test_benchmark_json_keeps_its_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    reported = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in reported and m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert c["file"].startswith(BENCH["paths"][0] + "/") and not c["reduced"]


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_configurations_have_the_published_widths(name):
    """Every tower of a configuration file has the widths and depths the
    program's table of OpenAI CLIP architectures gives it (no cut)."""
    from rlcf_torch.models.clip import CLIP_ARCHS

    config = harness.load_json(harness.ROOT, next(c["file"] for c in BENCH["configs"] if c["name"] == name))
    for tower in [config["policy"]] + config["rewards"]:
        arch = CLIP_ARCHS[tower["arch"]]
        layers = tower["vision_layers"]
        assert (arch.embed_dim, arch.image_resolution, arch.vision_width, arch.vision_patch_size, arch.text_width,
                arch.text_layers, arch.context_length, arch.vocab_size) == (
            tower["embed_dim"], tower["image_resolution"], tower["vision_width"], tower.get("vision_patch_size"),
            tower["text_width"], tower["text_layers"], tower["context_length"], tower["vocab_size"])
        assert arch.vision_layers == (layers if isinstance(layers, int) else tuple(layers))
