"""Class-axis (tp) sharding of the prompt-TTA text tower: the counterpart of
``rlcf_tpu/parallel/tp_prompt.py``.

The long axis of RLCF classification is the class-prompt batch (1000
ImageNet prompts, encoded again at every TTA step). Each tp rank splices the
trainable context into its class shard's prompts and runs the text tower on
them, on the hand-written kernels; the normalized fp32 features are
gathered to the whole class axis (``gather_replicated``) for selection,
top-k and the rewards. The context is replicated, so each rank's gradient of
it is its shard's share: the psum over tp (``all_reduce_grads``) makes it
the whole gradient, as JAX's ``shard_map`` does. The classifier runs these
steps (``tasks/classification.py``: ``PromptTTAClassifier.text_features_fn``
and ``step_grad_fn``); this module holds the shard of the template.
"""

from __future__ import annotations

import dataclasses

from ..core import prompt as Pr
from .mesh import class_sharded


def shard_prompt_state(mesh, pt: Pr.PromptState) -> Pr.PromptState:
    """The prompt template with this tp rank's classes: ``fixed_embed``,
    ``ctx_map`` and ``eot_idx`` sliced along the class axis; the context and
    the token ids stay whole."""
    return dataclasses.replace(pt, fixed_embed=class_sharded(mesh, pt.fixed_embed),
                               ctx_map=class_sharded(mesh, pt.ctx_map), eot_idx=class_sharded(mesh, pt.eot_idx))
