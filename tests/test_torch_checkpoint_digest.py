"""The checkpoint digest gate of ``--verify_checkpoint``, in the port against
the JAX package: both packages' digest tables point, by monkeypatch, at the
digests of small OpenAI-format checkpoints of ``test-tiny-vit`` under
``tmp_path`` (the stock releases are not here, and the gate needs no
download). Both classify each file the same way; both ``load_policy``s
refuse the stock file of another arch with the same message, note an
unknown digest on stderr and load it, load a matching file silently, and
skip the check under ``--verify_checkpoint 0``. One divergence is kept on
purpose: a ``--clip_checkpoint`` that does not exist raises in the port,
where JAX initialises the tower randomly.
"""

import argparse
import dataclasses
import hashlib
import os

import numpy as np
import pytest
import torch

import rlcf_tpu.cli.common as JCLI
import rlcf_tpu.models.convert as JV
import rlcf_torch.cli.common as TCLI
import rlcf_torch.models.convert as TV
from rlcf_torch.models import clip as TC
from torch_port_fixtures import openai_state_dict


@pytest.fixture
def stock(tmp_path, monkeypatch):
    """Three checkpoint files: the "stock" ViT-B/16 and ViT-L/14 releases
    (both tables patched to their digests) and a file of neither digest."""
    cfg = TC.get_config("test-tiny-vit")
    paths = {}
    for seed, name in enumerate(("b16", "l14", "tuned")):
        paths[name] = str(tmp_path / f"{name}.pt")
        torch.save(openai_state_dict(cfg, seed=seed), paths[name])
    digest = lambda p: hashlib.sha256(open(p, "rb").read()).hexdigest()
    table = {"ViT-B/16": digest(paths["b16"]), "ViT-L/14": digest(paths["l14"])}
    monkeypatch.setattr(JV, "CLIP_CHECKPOINT_SHA256", dict(table))
    monkeypatch.setattr(TV, "CLIP_CHECKPOINT_SHA256", dict(table))
    return paths, table


def _args(path, arch="ViT-B/16", verify=1):
    return argparse.Namespace(arch=arch, clip_checkpoint=path, precision="fp32", seed=0, download=0,
                              verify_checkpoint=verify)


@pytest.mark.parametrize("name,arch,want", [
    ("b16", "ViT-B/16", ("ok", None)),
    ("l14", "ViT-L/14", ("ok", None)),
    ("l14", "ViT-B/16", ("wrong-arch", "ViT-L/14")),
    ("b16", "ViT-L/14", ("wrong-arch", "ViT-B/16")),
    ("tuned", "ViT-B/16", ("unknown", None)),
    ("tuned", "RN50", ("unknown", None)),
])
def test_both_packages_classify_a_file_alike(stock, name, arch, want):
    paths, table = stock
    got = TV.check_checkpoint_digest(paths[name], arch)
    assert got == JV.check_checkpoint_digest(paths[name], arch)
    status, detail = want
    assert got[0] == status
    if status == "wrong-arch":
        assert got[1] == detail
    else:
        assert got[1] == hashlib.sha256(open(paths[name], "rb").read()).hexdigest()


def test_the_real_table_is_the_jax_packages():
    """Nine stock releases, the same digests as the JAX package's constants."""
    assert TV.CLIP_CHECKPOINT_SHA256 == JV.CLIP_CHECKPOINT_SHA256 and len(TV.CLIP_CHECKPOINT_SHA256) == 9


def test_sidecar_is_keyed_by_size_and_mtime(tmp_path):
    """The digest is kept in ``<path>.sha256`` in the JAX package's format:
    either package reads the other's, and a file whose mtime moved is hashed
    again."""
    path = tmp_path / "ckpt.pt"
    path.write_bytes(b"x" * 3000)
    want = hashlib.sha256(b"x" * 3000).hexdigest()
    assert TV._sha256_file(str(path)) == want
    sidecar = tmp_path / "ckpt.pt.sha256"
    assert sidecar.exists()
    text = sidecar.read_text().replace(want, "f" * 64)   # a cached digest is trusted while the key holds
    sidecar.write_text(text)
    assert TV._sha256_file(str(path)) == JV._sha256_file(str(path)) == "f" * 64
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    assert TV._sha256_file(str(path)) == want
    assert JV._sha256_file(str(path)) == want   # the port's new sidecar, read by the JAX package


def test_load_policy_refuses_the_stock_file_of_another_arch(stock):
    paths, _ = stock
    with pytest.raises(RuntimeError) as jax_exc:
        JCLI.load_policy(_args(paths["l14"]))
    with pytest.raises(RuntimeError) as port_exc:
        TCLI.load_policy(_args(paths["l14"]), "cpu")
    assert str(port_exc.value) == str(jax_exc.value)
    assert "is the stock OpenAI ViT-L/14 checkpoint, not ViT-B/16" in str(port_exc.value)


def _same_tower(port, jax_side):
    (tp, tcfg), (jp, jcfg) = port, jax_side
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    np.testing.assert_array_equal(tp["logit_scale"].numpy(), np.asarray(jp["logit_scale"]))


def test_load_policy_notes_an_unknown_digest_and_loads(stock, capsys):
    paths, _ = stock
    jax_side = JCLI.load_policy(_args(paths["tuned"]))
    jax_err = capsys.readouterr().err
    port = TCLI.load_policy(_args(paths["tuned"]), "cpu")
    port_err = capsys.readouterr().err
    note = [line for line in port_err.splitlines() if line.startswith("NOTE:")]
    assert note and note == [line for line in jax_err.splitlines() if line.startswith("NOTE:")]
    assert "is not a stock OpenAI release" in note[0] and "fine-tuned/converted ViT-B/16" in note[0]
    _same_tower(port, jax_side)


def test_load_policy_loads_a_matching_file_silently(stock, capsys, monkeypatch):
    """A match reaches the loader, with no note."""
    paths, _ = stock
    loaded = []
    real = TV.load_clip_checkpoint
    monkeypatch.setattr(TV, "load_clip_checkpoint", lambda p, **kw: loaded.append(p) or real(p, **kw))
    port = TCLI.load_policy(_args(paths["b16"]), "cpu")
    jax_side = JCLI.load_policy(_args(paths["b16"]))
    assert loaded == [paths["b16"]]
    assert "NOTE:" not in capsys.readouterr().err
    _same_tower(port, jax_side)


def test_verify_checkpoint_0_skips_the_gate(stock, capsys):
    paths, _ = stock
    port = TCLI.load_policy(_args(paths["l14"], verify=0), "cpu")
    jax_side = JCLI.load_policy(_args(paths["l14"], verify=0))
    assert "NOTE:" not in capsys.readouterr().err
    _same_tower(port, jax_side)
    assert not os.path.exists(paths["l14"] + ".sha256")   # nothing was hashed


def test_a_missing_checkpoint_raises_in_the_port(tmp_path):
    """The divergence kept on purpose: JAX initialises randomly here."""
    with pytest.raises(FileNotFoundError):
        TCLI.load_policy(_args(str(tmp_path / "missing.pt")), "cpu")
