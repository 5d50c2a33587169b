#!/usr/bin/env python3
"""The flagship's eager episode group with the attention kernels behind the
``torch.library`` custom ops (this tree) against another checkout of the port
(one that launches them through a ``torch.autograd.Function``), timed in
turns on one NVIDIA GPU.

    mkdir -p build/parent && git archive <rev> | tar -x -C build/parent
    python3 tools/custom_op_overhead.py build/parent

Each side runs in a process of its own from its own checkout (its kernels
built there), in the order other, tree, tree, other. A side builds the
flagship's classifier as ``chip_smoke.py`` does (ViT-B/16 policy, ViT-L/14
reward, random weights from seed 0, ImageNet-A's 200 classes, 64 views,
group 4, 3 steps, bf16), builds one group's tokens with the AugMix kernel,
and times ``adapt_tokens`` on them: ms a group over ``GROUPS`` groups after
a warm-up, each ended by a copy of the logits to the host; then the host's
microseconds a call of ``fused_attention`` on a small input (B=8, T=16, H=8)
over ``CALLS`` calls, where the host's work is the whole cost. Prints one
``OP_OVERHEAD`` line a run and the card's name and power limit.
"""

import json
import os
import subprocess
import sys

GROUPS, CALLS = 10, 2000

SIDE = r"""
import json, sys, time, concurrent.futures
import numpy as np, torch
sys.path.insert(0, ".")
import chip_smoke as C
from rlcf_torch.cli import tta_cls
from rlcf_torch.data.class_names import get_classnames
from rlcf_torch.data.datasets import SyntheticDataset
from rlcf_torch.ops import attention as A
from rlcf_torch.ops import augmix as X
from rlcf_torch.ops.augmix import fused_views

groups, calls = int(sys.argv[1]), int(sys.argv[2])
with concurrent.futures.ThreadPoolExecutor(3) as pool:
    list(pool.map(lambda f: f(), (A.build_mma, A.build_bwd_mma, X.build)))
clf, _, _ = tta_cls.build(tta_cls.get_args(C.flagship_argv("build/op_overhead")))
clf.setup(get_classnames("A"))
imgs = np.stack([SyntheticDataset(n=C.GROUP, n_classes=200)[i][0] for i in range(C.GROUP)])
planar = torch.from_numpy(imgs.transpose(0, 3, 1, 2).copy()).cuda()
toks = fused_views(planar, torch.Generator(device="cuda").manual_seed(0), n_views=C.VIEWS, resolution=C.RES,
                   src_size=C.SRC_SIZE, p_policy=16, p_reward=14)
for _ in range(3):
    clf.adapt_tokens(*toks)[0].float().cpu()
ms = []
for _ in range(groups):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clf.adapt_tokens(*toks)[0].float().cpu()
    ms.append(1e3 * (time.perf_counter() - t0))
qkv = torch.randn(8, 16, 3 * 8 * 64, device="cuda", dtype=torch.bfloat16)
for _ in range(20):
    A.fused_attention(qkv, None, 8, 0.125)
torch.cuda.synchronize()
t0 = time.perf_counter()
for _ in range(calls):
    A.fused_attention(qkv, None, 8, 0.125)
host_us = 1e6 * (time.perf_counter() - t0) / calls
torch.cuda.synchronize()
print("RESULT " + json.dumps({"group_ms_median": float(np.median(ms)), "group_ms": ms, "host_us_per_call": host_us,
                              "op": hasattr(torch.ops, "rlcf") and hasattr(torch.ops.rlcf, "fused_attention")}))
"""


def run_side(root):
    res = subprocess.run([sys.executable, "-c", SIDE, str(GROUPS), str(CALLS)], cwd=root, capture_output=True,
                         text=True, timeout=1200)
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("RESULT ")]
    if res.returncode != 0 or not lines:
        raise RuntimeError(f"the side in {root} failed:\n{res.stderr[-4000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def main():
    tree = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    other = os.path.abspath(sys.argv[1])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    for side, root in (("other", other), ("tree", tree), ("tree", tree), ("other", other)):
        print("OP_OVERHEAD " + json.dumps({"side": side, **run_side(root)}), flush=True)


if __name__ == "__main__":
    main()
