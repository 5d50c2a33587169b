"""The smoke script's own bookkeeping, on the CPU: what it counts as device
time in a profile."""

import importlib.util
import pathlib
import types

import torch

_PATH = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
_SPEC = importlib.util.spec_from_file_location("chip_smoke", _PATH)
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)


def test_device_busy_counts_kernels_not_annotation_spans():
    """An annotation on the device timeline (``Optimizer.step#AdamW.step``)
    spans kernels that are counted on their own; device busy leaves it out."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    event = lambda name, device, annotation=False: types.SimpleNamespace(name=name, device_type=device,
                                                                        is_user_annotation=annotation)
    events = [event("gemm", cuda), event("Optimizer.step#AdamW.step", cuda, annotation=True),
              event("aten::add", cpu), event("mha_bwd_mma_long", cuda)]
    prof = types.SimpleNamespace(events=lambda: events)
    assert [e.name for e in chip_smoke.device_events(prof)] == ["gemm", "mha_bwd_mma_long"]


def test_smoke_trees_load_through_the_port(tmp_path):
    """The synthetic Stanford Cars and Bongard-HOI trees that the smoke script
    writes are read by the port's loaders: the cars test split with labels over
    the 196 class names, and eight tasks of 6 + 6 support images and two queries."""
    from rlcf_torch.data.class_names import get_classnames
    from rlcf_torch.data.datasets import BongardHOIDataset, build_dataset

    cars = build_dataset("cars", chip_smoke.write_cars_tree(str(tmp_path / "cars"), 8))
    names = get_classnames("cars")
    assert len(cars) == 8 and len({label for _, label in cars.samples}) == 8
    assert all(0 <= label < len(names) for _, label in cars.samples) and cars[0][0].shape == (240, 360, 3)
    tasks = BongardHOIDataset(chip_smoke.write_bongard_tree(str(tmp_path / "hoi"), chip_smoke.BONGARD_TASKS,
                                                     size=chip_smoke.BONGARD_SIZE))
    assert len(tasks) == chip_smoke.BONGARD_TASKS
    task = tasks[7]
    assert len(task["pos_support"]) == len(task["neg_support"]) == 6 and task["annotation"] == "ride horse_7"
    assert task["pos_query"].mean() > task["neg_query"].mean()


def test_smoke_retrieval_tree_loads_through_the_port(tmp_path):
    """The smoke script's karpathy-format tree is read by the port's
    annotation loader: its images, its captions through the BLIP cleaning
    (as ``retrieval_tree_captions`` gives them) and the ground-truth maps."""
    from rlcf_torch.data.transforms import preprocess
    from rlcf_torch.tasks.retrieval import load_karpathy_annotations

    ann, root = chip_smoke.write_retrieval_tree(str(tmp_path / "coco"), 4, caps_per_image=3, size=(30, 50))
    gallery = load_karpathy_annotations(ann, root)
    assert len(gallery.image_paths) == 4 and gallery.texts == chip_smoke.retrieval_tree_captions(4, 3)
    assert gallery.img2txt[1] == [3, 4, 5] and gallery.txt2img[5] == 1
    assert gallery.image_paths[2].endswith(".png") and preprocess(gallery.image_paths[2], 32).shape == (32, 32, 3)
    assert all(t == t.lower() and not t.endswith(".") for t in gallery.texts)
