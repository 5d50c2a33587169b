"""Ranks of the port's sharded tests: ``launch`` runs one job of ``JOBS`` in
N processes over gloo on the CPU and returns rank 0's result.

The test process writes the job's inputs (torch weights, numpy arrays) to a
directory; each rank reads them, joins the process group through a
``file://`` rendezvous there (never a fixed port), runs the job on the
port's mesh and rank 0 writes what it returns. This module imports no JAX:
it is also the ranks' entry point (``python torch_parallel_workers.py JOB
DIR``). Every collective waits at most 60 s, and the ranks are killed when
the launch's deadline passes.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
COLLECTIVE_TIMEOUT_S = 60


def launch(tmp_path, world: int, job: str, payload: dict, timeout: float = 150.0):
    """Run ``JOBS[job](payload)`` on ``world`` ranks; rank 0's result."""
    d = pathlib.Path(tmp_path) / f"{job}_{world}_{time.monotonic_ns()}"
    d.mkdir(parents=True)
    torch.save(payload, d / "payload.pt")
    procs, logs = [], []
    for r in range(world):
        env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "MASTER_PORT", "XLA_FLAGS")}
        env.update(RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                   OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
        log = open(d / f"rank{r}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen([sys.executable, __file__, job, str(d)], env=env, stdout=log,
                                      stderr=subprocess.STDOUT, cwd=str(d)))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        tail = "\n".join(f"--- rank {r} (rc {procs[r].returncode}) ---\n" + (d / f"rank{r}.log").read_text()[-3000:]
                         for r in failed)
        raise AssertionError(f"{job} on {world} ranks failed or passed its {timeout} s deadline:\n{tail}")
    return torch.load(d / "result.pt", weights_only=False)


# ---------------------------------------------------------------------------
# jobs: each takes the payload and returns what rank 0 writes
# ---------------------------------------------------------------------------


def job_mesh(p):
    """make_mesh's layouts and errors, round_to_dp, dp_slice / dp_gather,
    gather_replicated's forward and backward, all_reduce_grads, replicate,
    over the world's ranks."""
    from rlcf_torch.parallel import mesh as M
    from rlcf_torch.parallel.collectives import all_reduce_grads, gather_objects, gather_replicated

    world = M.world_size()
    out = {"errors": {}}
    for name, kw in p["requests"].items():
        try:
            mesh = M.make_mesh(**kw)
            out[name] = {"shape": mesh.shape, "coords": gather_objects([(mesh.dp_rank, mesh.tp_rank)], None
                                                                      if world == 1 else torch.distributed.group.WORLD)}
        except ValueError as e:
            out["errors"][name] = str(e)
    mesh = M.make_mesh(tp=2)
    out["round"] = {n: M.round_to_dp(n, mesh) for n in range(1, 8)}
    x = torch.arange(24.0).reshape(8, 3)
    mine = M.dp_slice(mesh, x)
    out["dp_slice"] = gather_objects([mine], torch.distributed.group.WORLD)
    out["dp_gather"] = M.dp_gather(mesh, mine * 2)
    out["dp_untiled"] = M.dp_gather(mesh, M.dp_slice(mesh, x[:3]), 3)
    # a replicated loss of gathered rows: the gradient of each rank's rows is the whole loss's, no sum
    rows = (torch.arange(6.0).reshape(2, 3) + 10 * mesh.tp_rank).requires_grad_(True)
    full = gather_replicated(rows, mesh.tp_group)
    loss = (full * torch.arange(12.0).reshape(4, 3)).sum()
    loss.backward()
    out["gathered"], out["row_grad"] = full.detach(), gather_objects([rows.grad], mesh.tp_group)
    g = [torch.full((2,), float(mesh.tp_rank + 1)), torch.ones(3, dtype=torch.float64) * mesh.tp_rank]
    out["reduced"] = [t.clone() for t in all_reduce_grads(g, mesh.tp_group)]
    tree = {"a": torch.full((2,), float(M.rank()))}
    out["replicated"] = gather_objects([M.replicate(mesh, tree)["a"].clone()], torch.distributed.group.WORLD)
    return out


def job_tp_text(p):
    """The prompt classifier under tp: its text features on the whole class
    axis, and one step's losses and context gradient as ``episodes_fn``
    takes them (``step_grad_fn``), then the gradient without the psum over
    tp (each rank's classes' share)."""
    from rlcf_torch.core.episode import EpisodeConfig
    from rlcf_torch.core.reward import ClipReward, RewardConfig
    from rlcf_torch.parallel import mesh as M
    from rlcf_torch.tasks import classification as Cl

    mesh = M.make_mesh(tp=p["tp"])
    params, cfg = p["params"], p["cfg"]
    reward = ClipReward(params, cfg, RewardConfig(sample_k=p["sample_k"]))
    clf = Cl.PromptTTAClassifier(params, cfg, reward, EpisodeConfig(sample_k=p["sample_k"]), ctx_init="a photo of a",
                                 mesh=mesh).setup(p["names"])
    cparams, _, ctx0, pt_args, _, _ = clf.weights()
    args = (cparams, ctx0[None], pt_args, torch.as_tensor(p["sel_feats"]), torch.as_tensor(p["reward_sim"]))
    feats = clf.text_features_fn(cparams, ctx0[None], pt_args)[0]
    loss, grad = clf.step_grad_fn(*args)
    Cl.all_reduce_grads = lambda grads, group: grads
    _, grad_local = clf.step_grad_fn(*args)
    return {"feats": feats.detach(), "n_local_classes": pt_args["fixed_embed"].shape[0], "loss": loss,
            "grad": grad[0], "grad_local": grad_local[0]}


def job_fused_views(p):
    """``fused_views_sharded``: every rank's views gathered in image order."""
    from rlcf_torch.ops.augmix import fused_views_sharded
    from rlcf_torch.parallel import mesh as M

    mesh = M.make_mesh(n_devices=M.world_size(), dp=M.world_size())
    images = torch.as_tensor(p["images"])
    toks = fused_views_sharded(images, torch.Generator().manual_seed(p["seed"]), mesh, **p["kw"])
    return {"views": M.dp_gather(mesh, toks[0]), "reward": M.dp_gather(mesh, toks[1])}


def job_tune_cls_views(p):
    """``tune_cls`` on dp ranks (the CLI joins this process group): each
    rank's views and the group logits its ``EncoderTTAClassifier.adapt``
    saw and returned, every rank's views gathered to rank 0."""
    import torch.distributed as dist

    from rlcf_torch.cli import tune_cls
    from rlcf_torch.tasks.classification import EncoderTTAClassifier

    seen = []
    adapt = EncoderTTAClassifier.adapt

    def recording(self, views, **kw):
        logits, aux = adapt(self, views, **kw)
        seen.append((views.clone(), logits.detach().clone()))
        return logits, aux

    EncoderTTAClassifier.adapt = recording
    try:
        tune_cls.main(p["argv"])
    finally:
        EncoderTTAClassifier.adapt = adapt
    views = [None] * dist.get_world_size()
    dist.all_gather_object(views, [v for v, _ in seen])
    return {"views": views, "logits": [lg for _, lg in seen]}


def _prompt_classifier(p, mesh, ensemble: bool = False):
    from rlcf_torch.core.episode import EpisodeConfig
    from rlcf_torch.core.reward import ClipReward, ClipRewardEnsemble, RewardConfig
    from rlcf_torch.tasks.classification import PromptTTAClassifier

    rcfg = RewardConfig(sample_k=p["sample_k"])
    reward = ClipReward(p["rparams"], p["cfg"], rcfg)
    if ensemble:   # the reward and the policy's tower as two members
        reward = ClipRewardEnsemble([reward, ClipReward(p["params"], p["cfg"], rcfg)], rcfg)
    return PromptTTAClassifier(p["params"], p["cfg"], reward, EpisodeConfig(**p["ek"]), ctx_init="a photo of a",
                               mesh=mesh).setup(p["names"])


def job_prompt(p):
    """PromptTTAClassifier on a (dp, tp) mesh: tokens, NHWC views, the fused
    sources' path, a group that does not tile dp, and NHWC views with a
    reward ensemble (whose members' class features stay whole)."""
    from rlcf_torch.parallel import mesh as M

    mesh = M.make_mesh(tp=p["tp"])
    clf = _prompt_classifier(p, mesh)
    out = {"mesh": mesh.shape, "n_local_classes": clf._pt_args()["fixed_embed"].shape[0],
           "n_local_reward_feats": clf.reward.class_features.shape[0]}
    for name, fn in (("tokens", lambda: clf.adapt_tokens(p["tokens"])),
                     ("nhwc", lambda: clf.adapt(p["views"])),
                     ("untiled", lambda: clf.adapt_tokens(p["tokens"][:3]))):
        logits, aux = fn()
        out[name] = {"logits": logits, "losses": aux["losses"], "selected": aux["selected"]}
    run = clf.adapt_sources_fn(n_views=p["n_views"], src_size=p["src"], resolution=p["res"])
    logits, losses, _ = run(p["sources"], 5)
    out["sources"] = {"logits": logits, "losses": losses}
    ens = _prompt_classifier(p, mesh, ensemble=True)
    logits, aux = ens.adapt(p["views"])
    out["ensemble"] = {"logits": logits, "losses": aux["losses"], "selected": aux["selected"]}
    out["ensemble_reward_sim"] = tuple(ens.prepare(M.dp_slice(mesh, torch.as_tensor(p["views"])))[2].shape)
    return out


def job_encoder(p):
    """EncoderTTAClassifier on dp ranks, with the momentum fold."""
    from rlcf_torch.core.episode import EpisodeConfig
    from rlcf_torch.core.reward import ClipReward, RewardConfig
    from rlcf_torch.parallel import mesh as M
    from rlcf_torch.tasks.classification import EncoderTTAClassifier

    mesh = M.make_mesh(n_devices=M.world_size(), dp=M.world_size())
    reward = ClipReward(p["rparams"], p["cfg"], RewardConfig(sample_k=2))
    clf = EncoderTTAClassifier(p["params"], p["cfg"], reward, EpisodeConfig(**p["ek"]), mesh=mesh,
                               **p["kw"]).setup(p["names"])
    out = []
    for views in p["groups"]:
        logits, aux = clf.adapt(views)
        out.append({"logits": logits, "selected": aux["selected"], "losses": aux["losses"]})
    return {"groups": out, "reset": clf.momentum_state.reset_params, "counter": clf.momentum_state.counter}


def job_retrieval(p):
    """RetrievalTTA on a (dp, tp) mesh, both directions; the galleries
    precomputed over dp; the policy gradient of one step under tp."""
    from rlcf_torch.core.episode import EpisodeConfig
    from rlcf_torch.core.reward import ClipReward, RewardConfig
    from rlcf_torch.parallel import mesh as M
    from rlcf_torch.tasks.retrieval import RetrievalTTA, encode_image_gallery, encode_text_gallery

    mesh = M.make_mesh(tp=p["tp"])
    cfg, params = p["cfg"], p["params"]
    out = {"text_gallery": encode_text_gallery(params, cfg, p["gallery_texts"], batch_size=5, mesh=mesh)[0],
           "image_gallery": encode_image_gallery(params, cfg, p["image_batches"], mesh=mesh)}
    for direction in ("i2t", "t2i"):
        reward = ClipReward(p["rparams"], cfg, RewardConfig(sample_k=2))
        tta = RetrievalTTA(params, cfg, reward, EpisodeConfig(**p["ek"]), direction=direction, mesh=mesh,
                           **p["kw"])
        if direction == "i2t":
            tta.set_text_gallery(p["texts"])
            queries = p["images"]
        else:
            tta.set_image_gallery([p["images"]], [p["images"]])
            queries = p["tokens"]
        out[direction] = {"scores": tta.adapt_queries(queries), "local_gallery": tta.gallery_feats.shape[0]}
        out[direction]["grad"] = policy_grad(tta, queries, M.dp_slice(mesh, torch.as_tensor(queries)))
        out[direction]["grad"] = M.dp_gather(mesh, out[direction]["grad"])
    return out


def policy_grad(tta, queries, mine):
    """The policy tower's gradient [N, P] of a loss over the whole gallery's
    score rows, for each of the queries ``mine`` (leaves flattened in order)."""
    from rlcf_torch.core import policy as Po

    start, cache, views, per_episode = tta.episode_inputs(mine)
    n = views.shape[0]
    lead = (lambda v: v.detach().clone()) if per_episode else (lambda v: v.detach()[None].expand(n, *v.shape).clone())
    t = Po.tree_map(lambda v: lead(v).requires_grad_(True), start)
    logits = tta.policy_logits(t, cache, torch.zeros((n, 1), dtype=torch.long))
    torch.log_softmax(logits.float(), dim=-1)[..., 0].sum().backward()
    return torch.cat([v.grad.reshape(n, -1) for v in Po.tree_leaves(t) if v.grad is not None], dim=1)


def job_opt(p):
    """The tp OPT forward, beam and nucleus decode, plain and int8."""
    from rlcf_torch.models import opt as O
    from rlcf_torch.parallel import mesh as M
    from rlcf_torch.parallel.tp_opt import tp_opt_params

    mesh = M.make_mesh(n_devices=M.world_size(), dp=1, tp=M.world_size())
    out = {}
    for name, (params, cfg) in p["models"].items():
        sharded = tp_opt_params(mesh, params, cfg)
        prefix = torch.as_tensor(p["prefix"][name])
        out[name] = {
            "local_q": (sharded["blocks"]["q_w"]["q8"] if isinstance(sharded["blocks"]["q_w"], dict)
                        else sharded["blocks"]["q_w"]).shape,
            "forward": O.forward(sharded, cfg, tokens=torch.as_tensor(p["tokens"][name]), prefix_embeds=prefix),
            "beam": O.beam_generate(sharded, cfg, prefix, num_beams=3, max_new_tokens=6, num_return=3),
            "nucleus": O.nucleus_generate(sharded, cfg, prefix, torch.Generator().manual_seed(3), num_captions=2,
                                          max_new_tokens=5),
        }
    return out


def job_caption(p):
    """CaptionTTA on a (dp, tp) mesh, beam and nucleus, with momentum."""
    from rlcf_torch.core.reward import ClipReward, RewardConfig
    from rlcf_torch.parallel import mesh as M
    from rlcf_torch.tasks.caption import CaptionTTA

    mesh = M.make_mesh(n_devices=M.world_size(), dp=p["dp"], tp=p["tp"])
    out = {}
    for name, kw in p["runs"].items():
        reward = ClipReward(p["rparams"], p["rcfg"], RewardConfig(sample_k=2, process_batch=True))
        tta = CaptionTTA(p["params"], p["ccfg"], reward, p["tok"], mesh=mesh, **kw)
        trace = []
        caps = [tta.adapt_batch(p["images"], p["embs"], trace=trace) for _ in range(2)]
        out[name] = {"captions": caps, "trace": trace}
        if tta.momentum_update:
            out[name]["reset"] = tta.momentum_state.reset_params
    return out


def force_early_eos(mark: float = 50.0):
    """A decode hook for the EOS test: the sequences of an image whose
    embedding starts above ``mark`` take EOS as their second token (the
    image's prefix carries the mark to the decoder). Returns a list that
    gets the non-pad length of every nucleus sequence drawn, per call."""
    from rlcf_torch.models import opt as O
    from rlcf_torch.tasks.caption import CaptionTTA

    prefixes, prefill, decode, nucleus = CaptionTTA._prefixes, O._prefill, O._decode_step, O.nucleus_generate
    hot, lengths = {}, []

    def marked_prefixes(self, mappers, clip_embs):
        out = prefixes(self, mappers, clip_embs).clone()
        out[clip_embs[:, 0] > mark, 0, 0] = 2 * mark
        return out

    def flagging_prefill(params, cfg, prefix_embeds):
        hot["images"] = prefix_embeds[:, 0, 0] > mark
        return prefill(params, cfg, prefix_embeds)

    def eos_decode(params, cfg, token, prefix_cache, gen_cache, t, expand):
        logits = decode(params, cfg, token, prefix_cache, gen_cache, t, expand).clone()
        logits[hot["images"].repeat_interleave(expand), cfg.eos_newline_id] = 1e4
        return logits

    def recording_nucleus(params, cfg, *a, **k):
        seqs = nucleus(params, cfg, *a, **k)
        lengths.append((seqs != cfg.pad_token_id).sum(-1).reshape(-1).tolist())
        return seqs

    CaptionTTA._prefixes, O._prefill, O._decode_step = marked_prefixes, flagging_prefill, eos_decode
    O.nucleus_generate = recording_nucleus
    return lengths


def job_caption_eos(p):
    """Nucleus caption TTA at dp = world where one rank's slice finishes
    first (``force_early_eos``), two groups of ``tta_steps`` draws from one
    generator each, and the same run in one process on rank 0."""
    from rlcf_torch.core.reward import ClipReward, RewardConfig
    from rlcf_torch.parallel import mesh as M
    from rlcf_torch.tasks.caption import CaptionTTA

    lengths = force_early_eos()
    out = {}
    for name, mesh in (("sharded", M.make_mesh(n_devices=M.world_size(), dp=M.world_size())), ("one", None)):
        if name == "one" and M.rank() != 0:
            break
        del lengths[:]
        reward = ClipReward(p["rparams"], p["rcfg"], RewardConfig(sample_k=2, process_batch=True))
        tta = CaptionTTA(p["params"], p["ccfg"], reward, p["tok"], mesh=mesh, **p["kw"])
        trace = []
        caps = [tta.adapt_batch(p["images"], p["embs"], trace=trace) for _ in range(2)]
        out[name] = {"captions": caps, "trace": trace, "lengths": list(lengths)}
    return out


JOBS = {name[4:]: fn for name, fn in list(globals().items()) if name.startswith("job_")}


def main():
    job, d = sys.argv[1], pathlib.Path(sys.argv[2])
    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT))
    from rlcf_torch.parallel.mesh import init_distributed, rank

    init_distributed("cpu", init_method=f"file://{d / 'rendezvous'}", timeout_s=COLLECTIVE_TIMEOUT_S)
    result = JOBS[job](torch.load(d / "payload.pt", weights_only=False))
    if rank() == 0:
        torch.save(result, d / "result.pt")
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
