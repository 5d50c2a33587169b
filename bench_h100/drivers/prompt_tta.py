"""The traffic kind ``prompt_tta``: RLCF prompt TTA of a test set,
a group of images at a time, as ``rlcf_torch/cli/tta_cls.py``'s ``flush``
runs it.

Set-up parses the recipe's arguments (the configuration's ``argv`` and the
traffic's) with the CLI's own parser and builds the classifier with the
CLI's ``build``; the checkpoints it loads are the benchmark's weights, made on
the card from the seed (``weights.py``) and handed to the program's loader
of OpenAI checkpoints. It then sets up the class set, picks the view
generator by the CLI's ``--viewgen auto`` rule, makes a pool of synthetic u8
sources and runs warm-up groups of the timed shapes. The window is a closed
loop: the next group starts when the last group's logits reach the host, the
same group body the CLI times (without its JPEG decode: the sources are made
at set-up). Each group takes the CLI's seed, ``seed * 100003 + counter``.

Correctness: a sample of the window's groups, drawn from the seed, keeps
what the program produced (its views, view features, kept views, reward
similarities, each episode step's context, gradient and sampled classes, and
the final logits), observed by wrapping the classifier's methods; once the
window has closed and the program is freed, the plain reference
(``reference/``) works each sampled group out again (``compare``).
"""

from __future__ import annotations

import contextlib
import json
import math
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from .. import arith, harness
from ..reference import clip as ref_clip
from ..reference import views as ref_views
from ..reference.prompt_tta import PromptTTAReference
from ..weights import make_state_dict

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
# the numbers ``compare`` works out that a cell's limits hold
COMPARED = ("views", "text_gap", "feature_gap", "select_gap", "reward_gap", "topk_gap", "grad_dev", "step_gap",
            "answer_gap")
# the checkpoint names under which the program's loader finds the benchmark's towers (0: the policy)
CHECKPOINT = "bench_h100:tower:"
# the traffic's episode parameters and the CLI options that must say the same
AGREE = {"n_views": "batch_size", "resolution": "resolution", "selection_p": "selection_p", "sample_k": "sample_k",
         "tta_steps": "tta_steps", "lr": "lr", "weight_decay": "weight_decay", "ctx_init": "ctx_init",
         "n_ctx": "n_ctx"}
# the CLI options whose values the plain reference implements: RLCF's loss on CLIPScore minus its mean,
# AugMix views without hard augmentation, confidence-weighted ensembles, no prompt checkpoint
IMPLEMENTED = {"loss": "rlcf", "augmix": 1, "hard_aug": 0, "reward_process": 1, "process_batch": 0,
               "reward_amplify": 0, "weighted_scores": 1, "min_entropy_reg": 0, "load": None, "cocoop": False,
               "tp": 1}


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def towers(config):
    """The configuration's towers: the policy, then the reward members."""
    return [config["policy"]] + config["rewards"]


def tower_seed(seed: int, i: int) -> int:
    """The seed of tower ``i`` (0: the policy; reward member i - 1 takes
    ``seed + i``)."""
    return seed + i


def make_pool(seed: int, n: int, size: int) -> np.ndarray:
    """``n`` synthetic u8 sources ``[n, size, size, 3]`` from the seed: smooth
    colour fields (16x16 random colours upsampled bilinearly) with pixel
    noise, so that every AugMix op has edges, gradients and a histogram to
    work on."""
    rng = np.random.default_rng([seed % 2**63, 1])
    low = torch.from_numpy(rng.uniform(0, 255, (n, 3, 16, 16)).astype(np.float32))
    up = torch.nn.functional.interpolate(low, size=(size, size), mode="bilinear", align_corners=False)
    noise = torch.from_numpy(rng.normal(0.0, 12.0, (n, 3, size, size)).astype(np.float32))
    return np.ascontiguousarray(torch.clamp(torch.round(up + noise), 0, 255).to(torch.uint8).permute(0, 2, 3, 1)
                                .numpy())


def load_tower(tower, seed: int, dtype, device):
    """(params, config) of a tower as the program's loader of OpenAI
    checkpoints gives them, from the benchmark's state dict; no parameter
    keeps the buffer the weights were made in alive."""
    from rlcf_torch.models.convert import convert_clip_state_dict

    sd = make_state_dict(tower, seed, dtype=dtype, device=device)
    buf = sd["visual.class_embedding" if "visual.class_embedding" in sd else "visual.conv1.weight"].untyped_storage()
    params, inferred = convert_clip_state_dict(sd, dtype=dtype, device=device)
    layers = tower["vision_layers"]
    want = (layers if isinstance(layers, int) else tuple(layers), tower["vision_width"], tower["text_width"],
            tower["embed_dim"], tower["image_resolution"])
    if (inferred.vision_layers, inferred.vision_width, inferred.text_width, inferred.embed_dim,
            inferred.image_resolution) != want:
        raise RuntimeError(f"{tower['arch']}: the state dict reads as {inferred}, not the configuration's {want}")

    def own(t):
        return t.clone() if t.untyped_storage().data_ptr() == buf.data_ptr() else t

    return torch.utils._pytree.tree_map(own, params), inferred


@contextlib.contextmanager
def bench_checkpoints(config, seed: int):
    """While open, the program's loader of OpenAI checkpoints reads
    ``CHECKPOINT<i>`` as the benchmark's tower ``i``, made from the seed."""
    from rlcf_torch.models import convert

    real, all_towers = convert.load_clip_checkpoint, towers(config)

    def load(path, dtype=torch.float32, device="cpu"):
        if not str(path).startswith(CHECKPOINT):
            return real(path, dtype=dtype, device=device)
        i = int(str(path)[len(CHECKPOINT):])
        return load_tower(all_towers[i], tower_seed(seed, i), dtype, device)

    convert.load_clip_checkpoint = load
    try:
        yield
    finally:
        convert.load_clip_checkpoint = real


def program_args(config, traffic, seed: int, device):
    """The CLI's arguments of the cell, parsed by ``tta_cls.get_args``: the
    configuration's ``argv`` and the traffic's (the recipe's flags), the
    precision, the seed, the device and the benchmark's checkpoints. Refuses
    a cell whose arguments say otherwise than what the reference computes."""
    from rlcf_torch.cli import common, tta_cls

    n = len(config["rewards"])
    rewards = (["--reward_checkpoint", CHECKPOINT + "1"] if n == 1 else
               ["--reward_checkpoints", *(f"{CHECKPOINT}{i}" for i in range(1, n + 1))])
    args = tta_cls.get_args([*config["argv"], *traffic["argv"], "--precision", config["precision"], "--seed", str(seed),
                             "--device", device.type, "--verify_checkpoint", "0", "--clip_checkpoint", CHECKPOINT + "0",
                             *rewards])
    ep = traffic["episode"]
    wrong = {k: (ep[k], getattr(args, a)) for k, a in AGREE.items() if ep[k] != getattr(args, a)}
    wrong.update({k: (v, getattr(args, k)) for k, v in IMPLEMENTED.items() if getattr(args, k) != v})
    if traffic["group"] != args.episode_group:
        wrong["group"] = (traffic["group"], args.episode_group)
    if bool(args.multiple_reward_models) != (n > 1) or (n > 1 and n != len(common.ENSEMBLE_ARCHS)):
        wrong["rewards"] = (n, args.multiple_reward_models)
    if wrong:
        raise SystemExit(f"the cell's arguments and its traffic file disagree (file, argv): {wrong}")
    return args


def viewgen_of(args, patch) -> str:
    """The CLI's ``--viewgen auto`` choice on the card, for a policy of patch
    size ``patch`` (None: a ResNet): the fused kernel in the CLI's token mode
    (prompt TTA, not CoCoOp, with a ViT policy whose patch size tiles the
    views and a single reward), else the device generator."""
    from rlcf_torch.cli.tta_cls import auto_viewgen

    token_ok = (not args.cocoop and bool(patch) and args.resolution % patch == 0 and not args.multiple_reward_models)
    return auto_viewgen(True, token_ok, bool(args.hard_aug))


class Program:
    """The system under test, built for one configuration, traffic and seed."""

    def __init__(self, config, traffic, seed: int, device):
        from rlcf_torch.cli import tta_cls
        from rlcf_torch.data.augment import make_view_generator

        self.args = args = program_args(config, traffic, seed, device)
        with bench_checkpoints(config, seed):
            clf, cfg, self.device = tta_cls.build(args)
        self.clf = clf
        clf.setup(traffic["classes"])
        self.class_feats = clf.weights()[4]   # the initial prompt's class features, which the selection uses
        self.viewgen = viewgen_of(args, cfg.vision_patch_size if cfg.is_vit else None)
        if self.viewgen == "fused":
            self.sources = clf.adapt_sources_fn(n_views=args.batch_size, src_size=traffic["source_size"],
                                                resolution=args.resolution, augmix=bool(args.augmix))
        else:
            self.gen = make_view_generator(n_views=args.batch_size, resolution=args.resolution,
                                           augmix=bool(args.augmix), hard_aug=bool(args.hard_aug))
        self.spans = None         # a list that takes (name, start ns, end ns) of each span, where recorded
        self.view_events = None   # a list that takes the CUDA events around each call of the view generator
        self.kept = None          # where a sampled group's outputs go
        self._observe(clf, "prepare_tokens" if self.viewgen == "fused" else "prepare", "prepare",
                      lambda kept, args, out: kept.__setitem__("prepare", (args, out)))
        self._observe(clf, "episodes", "episodes")
        self._observe(clf, "step_grad_fn", None, lambda kept, args, out: kept.setdefault("steps", []).append(
            (args[1].detach().float().clone(), out[1].detach().float().clone())))
        self._observe(clf.reward, "score_samples", None,
                      lambda kept, args, out: kept.setdefault("idx", []).append(args[1].clone()))

    def span(self, name):
        if self.spans is None:
            return contextlib.nullcontext()
        return self._span(name)

    @contextlib.contextmanager
    def _span(self, name):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.perf_counter_ns()))

    def _observe(self, owner, method: str, span, keep=None):
        """Observe ``owner.<method>``: a span around each call and, in a sampled
        group, ``keep(kept, args, out)``."""
        inner = getattr(owner, method)

        def observed(*args):
            with self.span(span) if span else contextlib.nullcontext():
                out = inner(*args)
            if self.kept is not None and keep is not None:
                keep(self.kept, args, out)
            return out

        setattr(owner, method, observed)

    def group(self, imgs: np.ndarray, seed: int, kept=None):
        """One group, as the CLI's ``flush`` runs it: u8 sources ``[N, S, S, 3]``
        -> logits ``[N, C]`` on the host. ``kept``: a dict that takes what the
        program produced in this group."""
        self.kept = kept
        if self.viewgen == "fused":
            with self.span("adapt"):
                logits, _, _ = self.sources(torch.from_numpy(imgs.transpose(0, 3, 1, 2)), seed)
        else:
            with self.span("views"):
                events = self.view_events is not None and self.device.type == "cuda"
                if events:
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    start.record()
                views = self.gen(torch.from_numpy(imgs).to(self.device),
                                 torch.Generator(device=self.device).manual_seed(seed))
                if events:
                    end.record()
                    self.view_events.append((start, end))
            if kept is not None:
                kept["views"] = views
            with self.span("adapt"):
                logits, _ = self.clf.adapt(views)
        with self.span("readback"):
            out = logits.float().cpu().numpy()
        if kept is not None:
            kept["logits"] = out
        self.kept = None
        return out


def program_outputs(kept, viewgen: str):
    """The sampled group's outputs in one layout: views (u8 tokens
    ``[N, B, T, p*p*3]`` or float NHWC views), the policy's normalized
    features of every view ``[N, B, E]``, kept views ``[N, S]``, reward
    similarities ``[M, N, S, C]``, each episode step's ``(context, gradient,
    sampled classes)`` and the final logits ``[N, C]``."""
    inputs, (feats, sel, r_sim) = kept["prepare"]
    views = inputs[0] if viewgen == "fused" else kept["views"]
    r_sim = r_sim.float()
    r_sim = r_sim[None] if r_sim.dim() == 3 else r_sim.transpose(0, 1)
    steps = [(ctx, grad, idx) for (ctx, grad), idx in zip(kept.get("steps", []), kept.get("idx", []))]
    return {"views": views, "feats": feats.float(), "sel": sel, "r_sim": r_sim, "steps": steps,
            "logits": torch.as_tensor(kept["logits"]).float()}


class Stream:
    """The cell's groups in order: group ``g`` takes the pool's sources
    ``(g * N + i) % pool`` and the CLI's seed ``seed * 100003 + g``; of the
    groups after warm-up a uniform sample drawn from the seed (a reservoir)
    keeps its outputs for the check."""

    def __init__(self, traffic, seed: int):
        self.pool = make_pool(seed, traffic["pool"], traffic["source_size"])
        self.N, self.seed, self.warmup, self.g = traffic["group"], seed, traffic["warmup_groups"], 0
        self.rng, self.kept = np.random.default_rng([seed % 2**63, 2]), [None] * traffic["check_groups"]

    def next(self):
        """(index, sources, seed) of the next group."""
        g, self.g = self.g, self.g + 1
        return g, self.pool[[(g * self.N + i) % len(self.pool) for i in range(self.N)]], self.seed * 100003 + g

    def slot(self, g: int):
        """The sample's slot that group ``g`` takes, or None."""
        i, k = g - self.warmup, len(self.kept)
        if i < k:
            return i if i >= 0 else None
        j = int(self.rng.integers(0, i + 1))
        return j if j < k else None

    def run(self, program) -> float:
        """Run the next group through ``program``; its host seconds."""
        g, imgs, gseed = self.next()
        slot = self.slot(g)
        box = {} if slot is not None else None
        t = time.perf_counter()
        with program.span("group"):
            program.group(imgs, gseed, box)
        dt = time.perf_counter() - t
        if slot is not None:
            self.kept[slot] = (imgs, gseed, program_outputs(box, program.viewgen))
        return dt

    def sample(self):
        return [k for k in self.kept if k is not None]


# ---------------------------------------------------------------------------
# Correctness: the reference works each sampled group out again
# ---------------------------------------------------------------------------


def reference_towers(config, seed: int, device):
    """The reference's towers: the same weights, made again from the seed."""
    dtype = DTYPES[config["precision"]]
    return [(make_state_dict(t, tower_seed(seed, i), dtype=dtype, device=device), t)
            for i, t in enumerate(towers(config))]


def reference_views(imgs, seed: int, ep, viewgen: str, device, lowp: bool = False):
    """(views as the program emits them, normalized NCHW views ``[N, B, 3, R, R]``)."""
    R = ep["resolution"]
    if viewgen == "fused":
        planar = torch.from_numpy(imgs.transpose(0, 3, 1, 2).copy()).to(device)
        u8 = ref_views.augmix_tokens(planar, seed, ep["n_views"], R, lowp=lowp)
        mean = torch.tensor(ref_views.CLIP_MEAN, device=device)[:, None, None]
        std = torch.tensor(ref_views.CLIP_STD, device=device)[:, None, None]
        return u8, (u8.float() / 255.0 - mean) / std
    views = ref_views.generator_views(torch.from_numpy(imgs).to(device), seed, ep["n_views"], R, lowp=lowp)
    return views, views.permute(0, 1, 4, 2, 3)


def control_outputs(control: PromptTTAReference, imgs, seed: int, ep, viewgen: str, p_policy: int, device):
    """The reference in the program's place one precision below the
    configuration's: the views in bfloat16 (float32 in the program), the
    towers in float8 (bfloat16), the selection's entropies in bfloat16
    (float32), the prompt's context and AdamW's state in float8 (bfloat16)."""
    views, nchw = reference_views(imgs, seed, ep, viewgen, device, lowp=True)
    N, B = nchw.shape[:2]
    feats = control.policy_features(nchw.flatten(0, 1)).reshape(N, B, -1)
    sel = control.select(control.entropies(feats, lowp=True))
    sims = control.reward_sims(torch.stack([nchw[n, sel[n]] for n in range(N)]).flatten(0, 1))
    sims = sims.reshape(sims.shape[0], N, sel.shape[1], -1)
    steps = []
    final, _, _ = control.episodes(feats, sel, sims, record=steps, lowp_state=True)
    if viewgen == "fused":
        views = ref_views.patchify(views, p_policy)
    return {"views": views, "feats": feats, "sel": sel, "r_sim": sims, "steps": steps, "logits": final}


def centre(x):
    return x - x.mean(dim=-1, keepdim=True)


def compare(ref: PromptTTAReference, class_feats, groups, ep, viewgen: str, p_policy: int, device):
    """The numbers compared, worked out over the sampled ``groups`` (each
    ``(imgs, seed, outputs)``, outputs as ``program_outputs`` gives them) and
    the side's initial class features ``class_feats [C, E]``:

    - ``views``: u8 values of the fused path's tokens unequal to the
      reference's, or the generator's largest absolute difference;
    - ``text_gap``: the largest distance between a class's normalized
      features of the initial prompt and the reference's;
    - ``feature_gap``: the largest distance between a view's normalized
      policy features and the reference's;
    - ``select_gap``: the most, in nats, by which a view the program kept has
      a higher entropy than the last view it should keep, the entropies
      worked out in float32 from the program's own features and class
      features (0 where it keeps those views; a near-tie swap reads its margin);
    - ``reward_gap``: the largest absolute difference of a reward
      similarity, the reference scoring the views the program kept;

    Each episode step, the reference following the program from its own
    state (the context the step starts from, its kept views' features and
    reward similarities, the classes it sampled):

    - ``topk_gap``: the most, in logits, by which a class the program sampled
      lies below the ``sample_k``-th best of the reference's logits at the
      program's context (0 where it samples the best);
    - ``grad_dev``: the most, over episodes and steps, of one minus the cosine
      between the program's gradient in the context and the reference's (0
      where both are 0: no sampled class has a positive reward);
    - ``step_gap``: the largest distance, over episodes and steps, between
      the context the program starts a step from and the reference's (the
      initial prompt's words, or AdamW's step from the program's last context
      on the program's gradients), in units of one step's size
      ``lr * sqrt(context size)``;
    - ``answer_gap``: the largest distance over the episodes of the
      program's final logits from the reference's on the context AdamW's last
      step gives, over the root mean square of how far the reference's moved
      from the initial prompt's (all centred over the classes, on the
      program's features of view 0).

    Also, not compared, of the reference adapting by itself from the views
    the program kept: ``move_dev``, the median over the episodes of one minus
    the cosine between how far adaptation moved the program's final logits
    and how far it moved the reference's (both centred over the classes, both
    from the initial prompt's logits on the program's features of view 0);
    ``logits_gap``, the worst episode's distance from the reference's final
    logits over the root mean square move; and
    ``sign_flips``, the share of context entries whose first gradient has
    the other sign in the reference; ``topk_flips``, the share of kept views
    whose first sampled classes the reference, on its own features, samples
    otherwise; ``reward_positive_share``, the share of reward similarities
    above 0."""
    inf = dict.fromkeys(COMPARED, float("inf"))
    views_d, feature_gap, select_gap, reward_gap, topk_gap, grad_dev, step_gap = (0.0,) * 7
    class_feats = class_feats.to(device).float()
    text_gap = float((class_feats - ref.tf0).norm(dim=-1).max()) if class_feats.shape == ref.tf0.shape else float("inf")
    devs, gaps, moves, pos, flips, kflips, answer_errs, answer_moves = [], [], [], [], [], [], [], []
    K, unit = ep["sample_k"], None
    for imgs, seed, out in groups:
        ref_u, nchw = reference_views(imgs, seed, ep, viewgen, device)
        if viewgen == "fused":
            views_d += float((ref_views.patchify(ref_u, p_policy) != out["views"].to(device)).sum())
        else:
            views_d = max(views_d, float((ref_u - out["views"].to(device).float()).abs().max()))
        N, B = nchw.shape[:2]
        feats = ref.policy_features(nchw.flatten(0, 1)).reshape(N, B, -1)
        prog_feats = out["feats"].to(device)
        sel = out["sel"].to(device).long()
        n_keep = ref.n_keep(B)
        if prog_feats.shape != feats.shape or sel.shape != (N, n_keep) or not ((sel >= 0) & (sel < B)).all() or any(
                len(set(s.tolist())) != n_keep for s in sel) or len(out["steps"]) != ep["tta_steps"]:
            return inf
        feature_gap = max(feature_gap, float((prog_feats - feats).norm(dim=-1).max()))
        own = ref.entropies(prog_feats, class_feats)
        threshold = torch.sort(own, dim=-1).values[:, n_keep - 1:n_keep]
        select_gap = max(select_gap, float((torch.gather(own, 1, sel) - threshold).clamp(min=0).max()))
        sims = ref.reward_sims(torch.stack([nchw[n, sel[n]] for n in range(N)]).flatten(0, 1))
        sims = sims.reshape(sims.shape[0], N, n_keep, -1)
        pos.append(float((sims > 0).float().mean()))
        r_prog = out["r_sim"].to(device).float()
        if r_prog.shape != sims.shape:
            return inf
        reward_gap = max(reward_gap, float((r_prog - sims).abs().max()))
        final, initial, tf = ref.episodes(feats, sel, sims)
        logits = out["logits"].to(device).float()
        gaps += centre(logits - final).norm(dim=-1).tolist()
        moves += centre(final - initial).norm(dim=-1).tolist()
        f0 = prog_feats[:, 0]
        start = ref.scale * f0 @ ref.tf0.T
        devs += (1 - F.cosine_similarity(centre(logits - start), centre(ref.scale * torch.einsum(
            "ne,nce->nc", f0, tf) - start), dim=-1)).tolist()
        # the episode steps, the reference following the program's own state
        sel_feats = torch.gather(prog_feats, 1, sel[..., None].expand(-1, -1, prog_feats.shape[-1]))
        ctx_ref, state = ref.ctx0[None].expand(N, -1, -1), None
        unit = ep["lr"] * math.sqrt(ref.ctx0.numel())
        for k, (ctx, grad, idx) in enumerate(out["steps"]):
            ctx, grad, idx = ctx.to(device).float(), grad.to(device).float(), idx.to(device).long()
            if ctx.shape != ctx_ref.shape or grad.shape != ctx.shape or idx.shape != (N, n_keep, K):
                return inf
            step_gap = max(step_gap, float((ctx - ctx_ref).flatten(1).norm(dim=-1).max()) / unit)
            g_ref, lg, _ = ref.step_grad(ctx, sel_feats, r_prog, idx)
            a, b = grad.flatten(1), g_ref.flatten(1)
            dev = torch.where((a.norm(dim=-1) == 0) & (b.norm(dim=-1) == 0), 0.0, 1 - F.cosine_similarity(a, b, dim=-1))
            grad_dev = max(grad_dev, float(dev.max()))
            kth = torch.sort(lg, dim=-1, descending=True).values[..., K - 1:K]
            topk_gap = max(topk_gap, float((kth - torch.gather(lg, -1, idx)).clamp(min=0).max()))
            if k == 0:
                flips.append(float((torch.sign(grad) != torch.sign(g_ref)).float().mean()))
                own_sel = torch.gather(feats, 1, sel[..., None].expand(-1, -1, feats.shape[-1]))
                own_idx = ref.top_k(ref.scale * own_sel @ ref.tf0.T)
                kflips.append(float((torch.sort(own_idx, -1).values != torch.sort(idx, -1).values).any(-1).float()
                                    .mean()))
            ctx_ref, state = ref.adamw(ctx, grad, state, k + 1)
        with torch.no_grad():
            last = ref.scale * torch.einsum("ne,nce->nc", f0, ref.text_features(ctx_ref))
        answer_errs += centre(logits - last).norm(dim=-1).tolist()
        answer_moves += centre(last - start).norm(dim=-1).tolist()
    rms = lambda x: max(float(np.sqrt(np.mean(np.square(x)))), 1e-30)
    answer_gap = max(answer_errs) / rms(answer_moves)
    return {"views": views_d, "text_gap": text_gap, "feature_gap": feature_gap, "select_gap": select_gap,
            "reward_gap": reward_gap, "move_dev": float(np.median(devs)), "topk_gap": topk_gap, "grad_dev": grad_dev,
            "step_gap": step_gap, "answer_gap": answer_gap, "logits_gap": max(gaps) / rms(moves),
            "sign_flips": float(np.mean(flips)), "topk_flips": float(np.mean(kflips)),
            "reward_positive_share": float(np.mean(pos))}


def build_reference(config, traffic, seed: int, device, prec: str = "fp32"):
    """The plain reference of one seed, float32 products without TF32 (or the
    control's float8 products)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return PromptTTAReference(reference_towers(config, seed, device), traffic, ref_clip.Prec(prec),
                              DTYPES[config["precision"]])


def judge(numbers: dict, limits: dict) -> dict:
    """Each number beside its limit."""
    return {k: {"value": numbers[k], "limit": limits[k]} for k in limits}


def check(config, traffic, seed: int, class_feats, viewgen: str, groups, device) -> dict:
    """The compared numbers of ``groups`` against the reference of ``seed``."""
    ref = build_reference(config, traffic, seed, device)
    patch = config["policy"].get("vision_patch_size") or 0
    return compare(ref, class_feats, groups, traffic["episode"], viewgen, patch, device)


# ---------------------------------------------------------------------------
# A run
# ---------------------------------------------------------------------------


def flops_per_item(config, traffic) -> float:
    """The benchmark's FLOP count of one image (``arith``), each class's
    prompt counted to its EOT token."""
    from ..reference.prompt_tta import class_prompts
    from ..reference.tokenizer import tokenize

    ep = traffic["episode"]
    lengths = (tokenize(class_prompts(traffic["classes"], ep["ctx_init"])).argmax(axis=-1) + 1).tolist()
    return arith.prompt_tta_flops_per_item(config["policy"], config["rewards"], ep, lengths, ep["resolution"])


def attention_shapes():
    """The program's counts of attention launches by (direction, B, T, heads, dtype)."""
    from rlcf_torch.ops import attention

    return dict(attention.LAUNCH_SHAPES)


def traced_stretches(program, stream, n: int, device, log):
    """The ``--trace 1`` run's two stretches of ``n`` groups each: the first
    untraced, timed by the host's clock with CUDA events around the view
    generator; the second under the profiler, the device's activity alone
    (the host's spans are the harness's own, put on the trace's clock by the
    synchronizations that open and close it). Returns (the facts the
    per-layer readers take, the trace, the host seconds of every group)."""
    from torch.profiler import ProfilerActivity, profile

    from ..trace import read as read_trace

    cuda = device.type == "cuda"
    lat = []
    program.view_events = []
    t0 = time.perf_counter()
    for _ in range(n):
        lat.append(stream.run(program))
    untraced_s = time.perf_counter() - t0
    view_ms = [s.elapsed_time(e) for s, e in program.view_events]
    program.view_events = None

    shapes0 = attention_shapes()
    program.spans = []
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        t_open = time.perf_counter_ns()
        sync(device)
        for _ in range(n):
            lat.append(stream.run(program))
        t_close = time.perf_counter_ns()
        sync(device)
    shapes1 = attention_shapes()
    t_read = time.perf_counter()
    trace = read_trace(prof, (t_open, t_close), program.spans)
    del prof
    program.spans = None
    log("trace read", t_read)
    N = stream.N
    facts = {"items": N * n, "groups": n, "untraced_s": untraced_s, "untraced_items": N * n,
             "group_ms": 1e3 * untraced_s / n, "view_ms": view_ms,
             "attention": {k: shapes1[k] - shapes0.get(k, 0) for k in shapes1 if shapes1[k] > shapes0.get(k, 0)},
             "window_s": trace.window_s,
             "traced_seeds": [stream.seed * 100003 + g for g in range(stream.g - n, stream.g)]}
    print(f"phase untraced stretch: {untraced_s:.3f} s, {N * n / untraced_s:.4f} items/s; traced stretch: "
          f"{trace.window_s:.3f} s, {N * n / trace.window_s:.4f} items/s (the difference is the tracing's cost); "
          f"clock anchors {trace.anchor_note}", file=sys.stderr, flush=True)
    return facts, trace, lat


def run(ctx, device=None) -> dict:
    """One run of a cell; ``ctx`` holds ``args``, ``config``, ``traffic``,
    ``limits``, ``metrics`` (the cell's metrics for this run), ``readers``
    (each per-layer metric's ``read``) and ``t_start``. ``device`` is the
    card; the CPU only where a test drives a run at a small size. Returns the
    result and the checks."""
    args, config, traffic = ctx["args"], ctx["config"], ctx["traffic"]
    device = torch.device(device or "cuda")
    cuda = device.type == "cuda"
    ep = traffic["episode"]
    seed = args.seed
    N = traffic["group"]

    program = Program(config, traffic, seed, device)
    stream = Stream(traffic, seed)
    t_warm = time.perf_counter()
    for _ in range(traffic["warmup_groups"]):
        stream.run(program)
    sync(device)
    setup_s = time.perf_counter() - ctx["t_start"]
    log = lambda what, t: print(f"phase {what}: {time.perf_counter() - t:.3f} s", file=sys.stderr, flush=True)
    log("warm-up groups", t_warm)
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    flops = flops_per_item(config, traffic)
    host = harness.HostState()
    trace = None
    if args.trace:
        facts, trace, lat = traced_stretches(program, stream, traffic["trace_groups"], device, log)
        window_s = facts["untraced_s"] + trace.window_s
    else:
        lat = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < args.seconds:
            lat.append(stream.run(program))
        window_s = time.perf_counter() - t0
        facts = {}
    q = np.percentile(np.array(lat) * 1e3, [0, 10, 50, 90, 100]).round(1).tolist()
    print(f"phase window: {window_s:.3f} s, {len(lat)} groups, group ms min/p10/p50/p90/max {q}", file=sys.stderr,
          flush=True)
    print("host " + json.dumps(host.delta()), file=sys.stderr, flush=True)
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    items = N * len(lat)
    viewgen, class_feats = program.viewgen, program.class_feats
    facts.update(flops_per_item=flops, peak_bytes=window_peak, group=N, ep=ep, source_size=traffic["source_size"],
                 precision=config["precision"], device=device)
    del program
    if cuda:
        torch.cuda.empty_cache()

    t_metrics = time.perf_counter()
    metrics = {}
    if trace is None:
        ms = [t * 1e3 for t in lat for _ in range(N)]
        values = {"items_per_s": items / window_s, "item_ms_p90": float(np.percentile(ms, 90)), "setup_s": setup_s}
        for m in ctx["metrics"]:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for m in ctx["metrics"]:
            value = ctx["readers"][m["name"]](trace, facts)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    log("metrics", t_metrics)
    t_ref = time.perf_counter()
    numbers = check(config, traffic, seed, class_feats, viewgen, stream.sample(), device)
    checks = judge(numbers, ctx["limits"])
    log("reference and comparison", t_ref)
    print("numbers " + json.dumps(numbers), file=sys.stderr)
    result = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": items, "failed": 0, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(device) if cuda else "cpu", "count": 1,
                         "memory_peak_bytes": max(window_peak, setup_peak)}}
    if trace is not None:
        result["device"].update(busy_s=trace.busy_s(), window_s=trace.window_s)
        result["breakdown"] = {
            "device_ops": [[n[:120], s] for n, s in trace.time_by_kernel().most_common(10)],
            "idle_gaps": [[n, s] for n, s in trace.gaps_by_span().most_common(10)]}
    return result, checks


# ---------------------------------------------------------------------------
# Readings that set the limits (calibrate.py)
# ---------------------------------------------------------------------------


def program_readings(config, traffic, seed: int, n_groups: int, device) -> dict:
    """The compared numbers of a short run of the program on ``seed``: the
    run's warm-up, then ``n_groups`` groups at the cell's load, sampled as a
    run samples its window's."""
    program = Program(config, traffic, seed, device)
    stream = Stream(traffic, seed)
    for _ in range(traffic["warmup_groups"] + n_groups):
        stream.run(program)
    viewgen, class_feats = program.viewgen, program.class_feats
    del program
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return check(config, traffic, seed, class_feats, viewgen, stream.sample(), device)


def control_readings(config, traffic, seed: int, device) -> dict:
    """The compared numbers of the control on ``seed``: the reference one
    precision below the configuration's in the program's place, on the
    groups a run's sample would hold."""
    ep, p = traffic["episode"], config["policy"].get("vision_patch_size") or 0
    viewgen = viewgen_of(program_args(config, traffic, seed, device), p)
    control = build_reference(config, traffic, seed, device, prec="fp8")
    stream = Stream(traffic, seed)
    for _ in range(traffic["warmup_groups"]):
        stream.next()
    groups = []
    for _ in range(traffic["check_groups"]):
        _, imgs, gseed = stream.next()
        groups.append((imgs, gseed, control_outputs(control, imgs, gseed, ep, viewgen, p, device)))
    class_feats = control.tf0
    del control
    return check(config, traffic, seed, class_feats, viewgen, groups, device)
