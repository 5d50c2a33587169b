"""The smoke script's own bookkeeping, on the CPU: what it counts as device
time in a profile, the trees and vocabulary it writes, its caption phase at a
tiny size."""

import importlib.util
import os
import pathlib
import types

import numpy as np
import torch

from torch_port_fixtures import one_thread  # noqa: F401

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


def test_caption_phase_on_the_cpu(tmp_path, monkeypatch, one_thread):
    """The smoke script's caption phase at a tiny size on the CPU, the card's
    synchronisation and memory counters stubbed: the CLI with its stages
    timed, the early exit's check timed (the beams may end early here: without
    the check the sequences must not change), REFERENCE caption and clipscore_eval on the
    run's captions. The CPU launches no kernel: each path is credited one
    forward launch so that the checks on the counts run."""
    import torch

    from rlcf_torch.ops import attention as A

    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    reset = A.reset_launch_counts

    def credited():
        reset()
        A.LAUNCHES["fwd"] = 1

    monkeypatch.setattr(A, "reset_launch_counts", credited)
    tree = chip_smoke.write_caption_tree(str(tmp_path / "coco"), 3, caps_per_image=2, size=(40, 56))
    vocab = chip_smoke.write_opt_vocab(str(tmp_path / "vocab"), size=600, newline_id=None)
    tiny = ["--llm", "test-tiny-opt", "--prefix_length", "4", "--clip_length", "2", "--clip_model_type", "test-small",
            "--reward_arch", "test-small", "--resolution", "64", "--episode_group", "2", "--device", "cpu"]
    monkeypatch.setattr(chip_smoke, "CAP_GROUP", 2)
    monkeypatch.setattr(chip_smoke, "EXIT_CHECK_ROUNDS", 1)
    path, (tta, images, embs), run_dir = chip_smoke.run_caption_cli(
        "caption", chip_smoke.caption_argv(str(tmp_path / "run"), tree, vocab, "fp32", 3, 2) + tiny, 3, "fp32")
    assert path["groups"] == 2 and len(path["group_seconds"]) == 2 and len(path["captions"]) == 3
    assert len(path["stage_ms"]["generate"]) == 2 * 2 and len(path["stage_ms"]["final beam"]) == 2
    assert all(0 < n <= 50 for n in path["decode_steps"]["generate"])
    assert len(embs) == 1   # the last group: one image
    sync = chip_smoke.exit_check_cost(tta, images, embs)
    assert sync["generate_ms_checked"] > 0 and sync["generate_ms_unchecked"] > 0
    ref_path, ref = chip_smoke.caption_reference(
        chip_smoke.caption_argv(str(tmp_path / "ref"), tree, vocab, "fp32", 2, 2) + tiny,
        [np.random.default_rng(0).normal(size=(64, 64, 3)).astype(np.float32) for _ in range(2)], n_images=2)
    assert ref["step0_captions_equal"] and ref["step0_reward_worst_share_of_tolerance"] <= 1
    clip = chip_smoke.run_clipscore("clipscore", os.path.join(run_dir, "results_clipscore.json"), tree[1],
                                    os.path.join(str(tmp_path / "coco"), "references.json"),
                                    extra=("--arch", "test-small", "--resolution", "64", "--device", "cpu"))
    assert clip["images"] == 3 and np.isfinite(clip["clipscore"]) and np.isfinite(clip["ref_clipscore"])


def test_caption_training_phase_on_the_cpu(tmp_path, monkeypatch, one_thread):
    """The smoke script's caption-training phase at a tiny width on the CPU,
    the card's synchronisation, memory counters and profiler stubbed: the
    extraction to one npz and to shards, both trainers on them (a tiny OPT
    from an HF-format checkpoint whose 600 rows hold the synthetic
    vocabulary's ids), and the GPT-2 predictor. The CPU launches no kernel:
    each path is credited one forward launch so that the checks on the
    counts run."""
    from rlcf_torch.models import opt as O
    from rlcf_torch.ops import attention as A
    from torch_port_fixtures import hf_opt_state_dict

    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(chip_smoke, "profile_episode", lambda fn, what: fn() and {})
    reset = A.reset_launch_counts

    def credited():
        reset()
        A.LAUNCHES["fwd"] = 1

    monkeypatch.setattr(A, "reset_launch_counts", credited)
    monkeypatch.setattr(chip_smoke, "TRAIN_BATCH", 4)
    monkeypatch.setitem(O._OPT_N_HEADS, 32, 2)
    tree = chip_smoke.write_caption_tree(str(tmp_path / "coco"), 3, caps_per_image=3, size=(40, 56))
    vocab = chip_smoke.write_opt_vocab(str(tmp_path / "vocab"), size=600, newline_id=None)
    torch.save({k: torch.from_numpy(v) for k, v in hf_opt_state_dict(proj=False, V=600).items()},
               str(tmp_path / "opt.pt"))
    tiny = ["--arch", "test-small", "--resolution", "64", "--device", "cpu"]
    npz, shards = str(tmp_path / "f.npz"), str(tmp_path / "s.npz")
    ext = [chip_smoke.run_extract("extract", chip_smoke.extract_argv(npz, tree, vocab) + tiny),
           chip_smoke.run_extract("extract sharded", chip_smoke.extract_argv(shards, tree, vocab, 4) + tiny)]
    assert [(e["captions"], e["images"]) for e in ext] == [(9, 3), (9, 5)]   # images 1 and 2 straddle shards
    tiny_llm = ["--llm", "test-tiny-opt", "--opt_checkpoint", str(tmp_path / "opt.pt"), "--device", "cpu"]
    for path, emb, cap_model in (("train capdec", npz, "CapDec"), ("train clipcap", shards, "ClipCap")):
        run = chip_smoke.run_train(path, chip_smoke.train_argv(str(tmp_path / path), emb, cap_model) + tiny_llm, 9)
        assert run["steps"] == 4 and len(run["step_ms"]) == 4 and np.isfinite(run["losses"]).all()
    gpt2 = chip_smoke.run_clipcap_gpt2("clipcap gpt2", tree, chip_smoke.write_gpt2_vocab(str(tmp_path / "g"), 600),
                                       n_images=2, gpt2="test-tiny-gpt2", clip_arch="test-small",
                                       mapper_kw=dict(prefix_length=4, clip_length=2, num_layers=1, n_heads=2),
                                       device="cpu")
    assert 0 < gpt2["greedy"]["decode_steps"] <= 2 * (chip_smoke.GPT2_ENTRY - 1)
    assert 0 < gpt2["beam"]["decode_steps"] <= 2 * (chip_smoke.GPT2_ENTRY - 1)
    assert all(isinstance(c, str) for c in gpt2["beam"]["captions"] + gpt2["greedy"]["captions"])
