"""The port's experiment recipes, ``scripts/torch/``: one twin for each of
the reference's ``scripts/*.sh``, with the same name, arguments, environment
variables, flags and values. A twin differs from its JAX script in two
things only: ``python -m rlcf_tpu.cli.X`` is ``python -m rlcf_torch.cli.X``,
and its outputs go under ``exp/torch/`` instead of ``exp/``. The three NoCaps
recipes carry one repair besides (``NOCAPS_REPAIR``). Every twin passes
``bash -n``, names nothing of ``rlcf_tpu``, and each command it runs (bash
expands it, a stub ``python`` records it) survives the port's ``--dry_run``,
as do RUNBOOK.md's commands mapped to the port."""

import glob
import importlib
import json
import os
import re
import subprocess
import sys

import pytest

from test_scripts import _runbook_invocations
from torch_port_fixtures import REPO, chip_smoke, recipe_commands

JAX_SCRIPTS = sorted(os.path.basename(p) for p in glob.glob(str(REPO / "scripts" / "*.sh")))
TWINS = sorted(os.path.basename(p) for p in glob.glob(str(REPO / "scripts" / "torch" / "*.sh")))
ARGS = ["ARG1", "ARG2", "ARG3", "ARG4"]   # the positional arguments a recipe takes, as plain words

# The reference's NoCaps recipes write their first argument's message with braces,
# ``${1:?dir with nocaps_val_{417_in,2670_near,1413_out}-domain.json}``: the first ``}``
# ends the expansion, so bash sets ann_root to the argument followed by
# ``-domain.json}`` and every split's annotation path misses. The twins escape the braces.
NOCAPS_REPAIR = ("${1:?dir with nocaps_val_{417_in,2670_near,1413_out}-domain.json}",
                 "${1:?dir with nocaps_val_\\{417_in,2670_near,1413_out\\}-domain.json}")
NOCAPS_RECIPES = ("eval_coco2nocaps.sh", "tta_capdec_c2n.sh", "tta_clipcap_c2n.sh")


def required_args(name):
    """Plain words for the positional arguments the recipe requires
    (``${N:?...}``); the others keep the recipe's defaults."""
    text = (REPO / "scripts" / "torch" / name).read_text()
    return ARGS[:max((int(n) for n in re.findall(r"\$\{(\d):\?", text)), default=0)]


def to_port(text):
    """The port's form of a JAX recipe's text or argument."""
    return text.replace("rlcf_tpu.cli.", "rlcf_torch.cli.").replace("exp/", "exp/torch/")


def test_one_twin_for_each_recipe():
    assert len(JAX_SCRIPTS) == 23
    assert TWINS == JAX_SCRIPTS


@pytest.mark.parametrize("name", TWINS)
def test_twin_is_the_recipe_with_the_ports_module_and_outputs(name):
    jax_text = (REPO / "scripts" / name).read_text()
    twin = (REPO / "scripts" / "torch" / name).read_text()
    want = to_port(jax_text)
    if name in NOCAPS_RECIPES:
        assert NOCAPS_REPAIR[0] in want
        want = want.replace(*NOCAPS_REPAIR)
    assert twin == want
    assert "rlcf_tpu" not in twin and "rlcf_torch.cli." in twin
    assert os.access(REPO / "scripts" / "torch" / name, os.X_OK) == os.access(REPO / "scripts" / name, os.X_OK)


@pytest.mark.parametrize("name", TWINS)
def test_twin_passes_bash_syntax_check(name):
    subprocess.run(["bash", "-n", str(REPO / "scripts" / "torch" / name)], check=True)


@pytest.mark.parametrize("name", TWINS)
def test_twin_runs_the_recipes_commands(name, tmp_path):
    """The commands bash runs: the twin's are the JAX script's in the port's
    form (the NoCaps recipes' annotation paths aside, below)."""
    jax_cmds = recipe_commands(f"scripts/{name}", ARGS, {}, tmp_path)
    twin_cmds = recipe_commands(f"scripts/torch/{name}", ARGS, {}, tmp_path)
    if name in NOCAPS_RECIPES:
        jax_cmds = [[a.replace("ARG1-domain.json}/", "ARG1/") for a in c] for c in jax_cmds]
    assert twin_cmds == [[to_port(a) for a in c] for c in jax_cmds]
    assert all(c[:2] == ["-m", c[1]] and c[1].startswith("rlcf_torch.cli.") or c[0] == "tools/nocaps_domain_report.py"
               for c in twin_cmds)


@pytest.mark.parametrize("name", NOCAPS_RECIPES)
def test_nocaps_recipes_read_their_annotation_root(name, tmp_path):
    """The fault in the reference's NoCaps recipes, and the twins' repair:
    each split's annotations lie under the first argument."""
    jax_paths = [c[c.index("--annotations") + 1] for c in recipe_commands(f"scripts/{name}", ARGS, {}, tmp_path)
                 if "--annotations" in c]
    twin_paths = [c[c.index("--annotations") + 1]
                  for c in recipe_commands(f"scripts/torch/{name}", ARGS, {}, tmp_path) if "--annotations" in c]
    splits = ["val_417_in-domain", "val_2670_near-domain", "val_1413_out-domain"]
    assert jax_paths == [f"ARG1-domain.json}}/nocaps_{s}.json" for s in splits]
    assert twin_paths == [f"ARG1/nocaps_{s}.json" for s in splits]


@pytest.mark.parametrize("name", TWINS)
def test_twin_commands_dry_run(name, tmp_path, monkeypatch, capsys):
    """Each port command of the twin survives ``--dry_run`` to DRY RUN OK:
    the whole flag resolution, no model or data touched."""
    monkeypatch.chdir(tmp_path)
    cmds = [c for c in recipe_commands(f"scripts/torch/{name}", required_args(name), {}, tmp_path) if c[0] == "-m"]
    assert cmds
    for cmd in cmds:
        assert importlib.import_module(cmd[1]).main(cmd[2:] + ["--dry_run"]) is None
        assert "DRY RUN OK" in capsys.readouterr().out


@pytest.mark.parametrize("module,argv", _runbook_invocations(),
                         ids=[m.rsplit(".", 1)[-1] for m, _ in _runbook_invocations()])
def test_runbook_commands_dry_run_on_the_port(module, argv, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    port = importlib.import_module(module.replace("rlcf_tpu.cli.", "rlcf_torch.cli."))
    assert port.main(list(argv) + ["--dry_run"]) is None
    assert "DRY RUN OK" in capsys.readouterr().out


def test_smoke_shim_runs_commands_as_python_does(tmp_path):
    """``chip_smoke.py``'s ``python`` for phase 4l (``RECIPE_SHIM``), first on
    a recipe's PATH: a port module by ``-m`` and a repo tool by its path run
    as python would run them, the exit code passes through, and each process
    writes its exit code and kernel counters (0 here: a dry run launches
    nothing) to a file of its own."""
    bin_dir, counts, run = tmp_path / "bin", tmp_path / "counts", tmp_path / "run"
    for d in (bin_dir, counts, run):
        d.mkdir()
    (bin_dir / "python").write_text(chip_smoke.RECIPE_SHIM.replace("PYTHON", sys.executable, 1))
    (bin_dir / "python").chmod(0o755)
    os.symlink(REPO / "tools", run / "tools")
    (run / "in.json").write_text(json.dumps({"clipscore": 0.5, "n_images": 2}))
    env = dict(os.environ, PATH=f"{bin_dir}{os.pathsep}{os.environ['PATH']}", RECIPE_COUNTS=str(counts),
               PYTHONPATH=str(REPO))
    sh = lambda cmd: subprocess.run(["bash", "-c", cmd], cwd=run, env=env, capture_output=True, text=True)
    dry = sh("python -m rlcf_torch.cli.zero_shot /data --test_sets A --dry_run")
    assert dry.returncode == 0 and "DRY RUN OK" in dry.stdout
    report = sh("python tools/nocaps_domain_report.py in.json --out out.json")
    assert report.returncode == 0 and json.loads((run / "out.json").read_text())["overall"]["n_images"] == 2
    assert sh("python tools/nocaps_domain_report.py --no_such_flag").returncode == 2
    recs = [json.loads(p.read_text()) for p in sorted(counts.iterdir())]
    assert [r["rc"] for r in recs] == [0, 0, 2]
    assert recs[0]["argv"][:2] == ["-m", "rlcf_torch.cli.zero_shot"]
    assert recs[0]["launches"] == {"fwd": 0, "bwd": 0, "augmix": 0}
    assert "launches" not in recs[1] and recs[1]["argv"][0] == "tools/nocaps_domain_report.py"
