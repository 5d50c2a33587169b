"""Faults planted in the timed path, each of which has to make a run's
``correct`` false: the CPU tests plant them in the tiny cell, and
``calibrate.py --fault`` in a cell at its own size on the card."""

from __future__ import annotations

import contextlib
import importlib


def unchanged_step(adamw_step):
    def fault(params, grads, state, count, *args, **kwargs):
        return [p.clone() for p in params], state
    return fault


def one_unadapted(adamw_step):
    """The group's last image keeps its initial context: its episode's steps
    return its state unchanged."""
    def fault(params, grads, state, count, *args, **kwargs):
        out, state = adamw_step(params, grads, state, count, *args, **kwargs)
        out = [o.clone() for o in out]
        out[0][-1] = params[0][-1]
        return out, state
    return fault


def half_the_views(step_loss):
    def fault(logits, reward_sim, *args):
        half = logits.shape[-2] // 2
        return step_loss(logits[..., :half, :], reward_sim[..., :half, :], *args)
    return fault


def altered_token(fused_views):
    def fault(*args, **kwargs):
        out = fused_views(*args, **kwargs)
        first = out[0] if isinstance(out, tuple) else out
        first.view(-1)[123] ^= 1
        return out
    return fault


def altered_view(make_view_generator):
    def make(*args, **kwargs):
        gen = make_view_generator(*args, **kwargs)

        def fault(*a):
            views = gen(*a)
            views[0, 3, 5, 7, 1] += 0.05
            return views
        return fault
    return make


def altered_answer(episodes_fn):
    def fault(self, *args):
        final, losses = episodes_fn(self, *args)
        final = final.clone()
        final[-1] = final[-1].flip(-1)
        return final, losses
    return fault


# name: (the cells that can have it, by path: "fused" the AugMix kernel's, "device" the generator's;
# where it is planted, as (module, attribute) pairs; the fault made from the original)
FAULTS = {
    "unchanged_step": (("fused", "device"), [("rlcf_torch.tasks.classification", "adamw_step")], unchanged_step),
    "one_unadapted": (("fused", "device"), [("rlcf_torch.tasks.classification", "adamw_step")], one_unadapted),
    "half_the_views": (("fused", "device"), [("rlcf_torch.core.episode", "step_loss"),
                                             ("rlcf_torch.tasks.classification", "step_loss")], half_the_views),
    "altered_token": (("fused",), [("rlcf_torch.ops.augmix", "fused_views")], altered_token),
    "altered_view": (("device",), [("rlcf_torch.data.augment", "make_view_generator")], altered_view),
    "altered_answer": (("fused", "device"), [("rlcf_torch.tasks.classification", "PromptTTAClassifier.episodes_fn")],
                       altered_answer),
}


@contextlib.contextmanager
def plant(name: str):
    """While open, the fault ``name`` replaces what it breaks."""
    _, sites, make = FAULTS[name]
    undo, made = [], None
    for module, attr in sites:
        owner = importlib.import_module(module)
        if "." in attr:
            cls, attr = attr.split(".")
            owner = getattr(owner, cls)
        original = getattr(owner, attr)
        made = made or make(original)
        undo.append((owner, attr, original))
        setattr(owner, attr, made)
    try:
        yield
    finally:
        for owner, attr, original in reversed(undo):
            setattr(owner, attr, original)
