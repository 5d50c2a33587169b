"""The smoke script's own bookkeeping, on the CPU: what it counts as device
time in a profile, the trees and vocabulary it writes, its caption phase at a
tiny size."""

import importlib.util
import os
import pathlib
import types

import numpy as np
import pytest
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

    def event(name, device, ns, annotation=False, hidden=False):   # the profiler's raw event's accessors
        return types.SimpleNamespace(name=lambda: name, device_type=lambda: device, duration_ns=lambda: ns,
                                     is_user_annotation=lambda: annotation, is_hidden_event=lambda: hidden)

    events = [event("gemm", cuda, 2500), event("Optimizer.step#AdamW.step", cuda, 9000, annotation=True),
              event("aten::add", cpu, 700), event("mha_bwd_mma_long", cuda, 1500), event("hidden", cuda, 50, hidden=True)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=types.SimpleNamespace(
        events=lambda: events)))
    got = chip_smoke.device_events(prof)
    assert [e.name for e in got] == ["gemm", "mha_bwd_mma_long"] and [e.device_time for e in got] == [2.5, 1.5]


def test_device_events_read_a_real_profile():
    """``device_events`` reads a torch.profiler profile's raw results: on the
    CPU there are no device events, and the CPU's ops are not counted."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(4).add_(1)
    assert chip_smoke.device_events(prof) == [] and len(prof.profiler.kineto_results.events()) > 0


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




@pytest.fixture
def tiny_serving(monkeypatch):
    """The smoke script's serving phase (4i) at a tiny width on the CPU: the
    card's synchronisation and memory counters stubbed, the towers on the
    attention op (whose CPU implementation is the plain version). The CPU
    launches no kernel: each path is credited one forward launch so that the
    checks on the counts run, and the served program's launch check is the card's."""
    from rlcf_torch.models import clip as clip_model
    from rlcf_torch.ops import attention as A

    tiny = ["--arch", "test-small", "--reward_arch", "test-small", "--resolution", "64", "--device", "cpu"]
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(clip_model, "best_attn", lambda *a, **k: "fused")
    reset = A.reset_launch_counts

    def credited():
        reset()
        A.LAUNCHES["fwd"] = 1

    monkeypatch.setattr(A, "reset_launch_counts", credited)
    for name, value in (("GROUP", 2), ("VIEWS", 8), ("RES", 64), ("SERVE_PRECISIONS", ("fp32",)), ("SERVE_TIMED", 1),
                        ("RESUME_LIMITS", (2, 4)), ("TRAIN_IMAGES", 3), ("TRAIN_TREE_SIZE", (40, 56)),
                        ("DECODE_WORKERS", 2)):
        monkeypatch.setattr(chip_smoke, name, value)
    for fn, flags in (("flagship_argv", tiny), ("export_argv", tiny + ["--synthetic_classes", "5"]),
                      ("extract_argv", tiny[:2] + tiny[4:])):
        monkeypatch.setattr(chip_smoke, fn, (lambda f, x: lambda *a, **k: f(*a, **k) + x)(getattr(chip_smoke, fn), flags))
    vocab = chip_smoke.write_opt_vocab
    monkeypatch.setattr(chip_smoke, "write_opt_vocab", lambda root: vocab(root, size=600, newline_id=None))


def test_serving_export_phase_on_the_cpu(tmp_path, tiny_serving, one_thread):
    """The export served in a fresh process against the eager episode (fp32:
    logits within SERVE_TOL, equal selections), the graph's ``rlcf::`` nodes,
    and a serving process that imports no model code."""
    paths, export = chip_smoke.serving_export(str(tmp_path), [f"class_{i}" for i in range(5)], device="cpu")
    fp32 = export["fp32"]
    assert fp32["selected_equal"] and fp32["max_abs_logit_diff"] <= chip_smoke.SERVE_TOL
    assert fp32["rlcf_nodes"] == ["rlcf.fused_attention.default", "rlcf.fused_attention_bwd.default"]
    assert set(fp32["serving_process_port_modules"]) <= chip_smoke.SERVE_MODULES
    assert [p["path"] for p in paths] == ["serve fp32"]


def test_serving_resume_decode_runner_on_the_cpu(tmp_path, tiny_serving, one_thread):
    """The resume against one run, extraction with the native decoder beside
    PIL, the runner on two devices (here both the CPU) and resumed."""
    _, resume = chip_smoke.serving_resume(str(tmp_path))
    assert resume["journal_equal"] and resume["resumed"] == resume["one_run"] and resume["resumed"]["n"] == 4
    decode_paths, decode = chip_smoke.serving_decode(str(tmp_path))
    assert [p["path"] for p in decode_paths] == ["extract pil", "extract native"]
    assert decode["min_image_cosine"] >= chip_smoke.DECODE_MIN_COS
    runner = chip_smoke.serving_runner(str(tmp_path), device="cpu")
    assert runner["card_vs_cpu_max_rel"] == 0 and runner["resumed_vs_one_run_max_rel"] == 0 and runner["trace_bytes"]


def test_serving_resume_twice_in_one_checkout(tmp_path, tiny_serving, one_thread):
    """A second smoke run in the same checkout starts the resume check from
    empty journals: the one run's journal holds one line a group, the
    resumed run runs only the groups left, and the check passes again."""
    for _ in range(2):
        _, resume = chip_smoke.serving_resume(str(tmp_path))
        assert resume["journal_equal"] and resume["logits_equal"] and resume["first_run_lines_kept"]
        assert len(resume["journal"]) == 2 and resume["resumed_groups_run"] == 1
        assert "repeat_equal_to_one_run" not in resume


def test_smoke_runs_the_serving_phase_and_the_a15_refusals_are_gone():
    """``main`` runs phase 4i and phase 5 holds the served programs' launches;
    ``--resume`` and ``--decode native`` are no longer refused."""
    from rlcf_torch.cli import common, tta_cls

    src = _PATH.read_text()
    main = src[src.index("\ndef main():"):]
    assert "serving_and_infrastructure(out_dir)" in main and 'log("SERVING "' in main
    assert 'f"serve {precision}"' in main and "--serving-only" in main
    assert not hasattr(common, "DECODE_WAIT") and "DECODE_WAIT" not in src
    tta_cls.refuse_unported(tta_cls.get_args(["--resume", "--decode", "native"]))   # raises nothing


def test_smoke_runs_the_views_phase_and_no_refusal_names_a16():
    """``main`` runs phase 4k (the device generator's paths, the VIEWS check,
    its timing) and adds its paths to phase 5's; the encoder paths expect no
    AugMix launch; no CLI refusal names A16 any more."""
    import importlib

    src = _PATH.read_text()
    main = src[src.index("\ndef main():"):]
    assert "viewgen_a16(out_dir)" in main and 'log("VIEWGEN "' in main and "paths += views_paths" in main
    run_encoder = src[src.index("\ndef run_encoder("):src.index("\ndef encoder_gradient_check(")]
    assert 'launches["augmix"] or' in run_encoder
    for cli in ("tta_cls", "tune_cls"):
        assert "A16" not in (pathlib.Path(_PATH).parent / "rlcf_torch" / "cli" / f"{cli}.py").read_text()
        importlib.import_module(f"rlcf_torch.cli.{cli}").refuse_unported(
            importlib.import_module(f"rlcf_torch.cli.{cli}").get_args(["--hard_aug", "1"]))   # raises nothing


def test_block_rows_and_path_checks_name_every_launch_counter():
    """The smoke's block variants are exactly ``ops/block_ops.py``'s launch
    counters, ``block_launches`` reports each under its own key, and each
    kernel row of phase 3 times a counted variant: a row's launches are that
    variant's, and a path check can require each kernel by name."""
    from rlcf_torch.ops import block_ops as B

    variants = chip_smoke.BLOCK_FWD + chip_smoke.BLOCK_BWD + chip_smoke.BLOCK_WGRAD
    assert sorted(variants) == sorted(B.LAUNCHES)
    B.reset_launch_counts()
    B.LAUNCHES["ln_bwd"] = 3
    got = chip_smoke.block_launches(B)
    assert got["block_ops"] == 3 and got["block_ln_bwd"] == 3 and all(got[f"block_{k}"] == 0 for k in variants
                                                                      if k != "ln_bwd")
    B.reset_launch_counts()
    src = _PATH.read_text()
    rows = src[src.index("\ndef check_block_ops("):src.index("\ndef augmix_ops(")]
    timed = [v for v in variants if f'("{v}", lambda' in rows]
    assert timed == [v for v in variants if v not in chip_smoke.BLOCK_WGRAD]
