#!/usr/bin/env python3
"""Peak device memory of a retrieval TTA group against its size, on one
NVIDIA GPU: the numbers behind ``RetrievalTTA.PER_EPISODE_FACTOR`` and
``HBM_USABLE_SHARE`` (``rlcf_torch/tasks/retrieval.py``).

    python3 tools/retrieval_group_memory.py [--precision bf16|fp32]

Builds the engine of each direction as ``chip_smoke.py`` does at the COCO
Karpathy test split's size (ViT-B/16 policy, ViT-L/14 reward, random weights
from seeds, ``tta_coco_ret.sh``'s episode) and runs one group of each size
in ``--i2t`` and ``--t2i``, from small to past the card's memory. For each it
prints one ``GROUP`` line: whether it ran, its seconds, its peak memory
allocated and reserved (over the memory allocated before it, and as a share
of ``total_memory``), the allocated peak per episode over the trainable
bytes, and the cap ``hbm_group_cap`` gives. The first group that runs out of
memory ends its direction.
"""

import argparse
import concurrent.futures
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as C  # noqa: E402
from rlcf_torch.ops import attention as A  # noqa: E402


def measure(tta, make_queries, sizes):
    total = torch.cuda.get_device_properties(0).total_memory
    for n in sizes:
        queries = make_queries(n)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        try:
            tta.adapt_queries(queries)
            torch.cuda.synchronize()
            ran = True
        except torch.OutOfMemoryError:
            ran = False
        secs = time.perf_counter() - t0
        alloc, res = torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()
        print("GROUP " + json.dumps({
            "direction": tta.direction, "group": n, "ran": ran, "seconds": secs, "base_bytes": base,
            "peak_allocated_bytes": alloc, "peak_reserved_bytes": res, "peak_allocated_share": alloc / total,
            "peak_reserved_share": res / total, "trainable_bytes": tta.trainable_bytes(),
            "allocated_per_episode_factor": (alloc - base) / (n * tta.trainable_bytes()),
            "hbm_group_cap": tta.hbm_group_cap()}), flush=True)
        del queries
        if not ran:
            return


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--precision", choices=("bf16", "fp32"), default="bf16")
    parser.add_argument("--i2t", type=int, nargs="+", default=[1, 2, 8, 32, 64, 76, 82, 86, 91])
    parser.add_argument("--t2i", type=int, nargs="+", default=[1, 2, 8, 64, 128, 170, 190, 208])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("retrieval_group_memory: no CUDA device", file=sys.stderr)
        return 2
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        for f in [pool.submit(b, force=True) for b in (A.build_mma, A.build_bwd_mma, A.build_tf32, A.build_bwd_tf32)]:
            f.result()
    from rlcf_torch.cli import common, tta_retrieval
    from rlcf_torch.core.episode import EpisodeConfig
    from rlcf_torch.tasks.retrieval import RetrievalTTA
    from rlcf_torch.tokenizer import tokenize

    smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip()
    print(smi, flush=True)
    out_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build", "retrieval_memory")
    margs = tta_retrieval.get_args(C.retrieval_argv(out_dir, "both", args.precision))
    dev = torch.device("cuda")
    params, cfg = common.load_policy(margs, dev)
    reward = common.build_reward(margs, dev)
    ecfg = EpisodeConfig(tta_steps=C.RET_STEPS, lr=float(C.RET_LR), sample_k=C.RET_SAMPLE_K, adam_eps=1e-6)
    captions = C.coco_captions()
    i2t = RetrievalTTA(params, cfg, reward, ecfg, direction="i2t")
    i2t.set_text_gallery(captions)
    gen = torch.Generator(device="cuda")
    measure(i2t, lambda n: torch.randn(n, C.RES, C.RES, 3, device="cuda", generator=gen.manual_seed(2)),
            args.i2t)
    del i2t
    torch.cuda.empty_cache()
    t2i = RetrievalTTA(params, cfg, reward, ecfg, direction="t2i")
    t2i.set_image_gallery(C.coco_image_batches(), C.coco_image_batches())
    measure(t2i, lambda n: tokenize(captions[:n], truncate=True), args.t2i)
    return 0


if __name__ == "__main__":
    sys.exit(main())
