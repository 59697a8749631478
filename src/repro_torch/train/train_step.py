"""The train step, driven by an ``ExecutionPlan`` (counterpart of
``src/repro/train/train_step.py``).

Mixed precision as in the reference: the model is differentiated with
respect to the compute-dtype copies of the parameters
(``cast_params_once``); with ``grad_accum > 1`` each microbatch's grads are
weighted by its valid-token count and summed in the compute dtype; the
sum is divided by the total count, upcast to fp32 once, outside the
microbatch loop, and one AdamW update runs on the fp32 masters.

On a mesh the step runs hybrid ZeRO (``plan.zero``, ``core/zero.py``):
each rank holds its shards of the fp32 masters and of both moments.  Once
a step each shard is cast to the compute dtype and all-gathered (the
reference's ``cast_params_once`` before its gather).  Each rank's grads
are its tokens' share of the global loss's grads; after the microbatch
loop, leaf by leaf (so that at most one full fp32 leaf lives at a time),
they are upcast, reduce-scattered over the leaf's group and all-reduced
over the complement axes, which sums them over the world into this
rank's shard: the reference's single reduction point.  A replicated leaf
is all-reduced over the world.  AdamW then runs on the shards with the
global grad norm.  Token weights use the global counts, which
``forward_loss`` reduces.  Remat applies inside each microbatch's
forward, and each microbatch's activations die with its iteration.  Tied
embeddings get the sum of the embedding grad and the LM-head grad,
because both uses read the one table.
"""
from __future__ import annotations

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.models.model import cast_params_once, forward_loss
from repro_torch.train.optimizer import adamw_update


def make_train_step(plan):
    """``step_fn(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  ``batch`` leaves are tensors on the plan's device, with a
    leading microbatch axis when ``plan.grad_accum > 1``.  The params and
    optimizer state are updated in place; the metrics are device scalars
    (``lr`` a float), so the step never waits for the host."""
    cfg, rt, opt_cfg, accum = plan.cfg, plan.rt, plan.opt, plan.grad_accum
    layout = plan.zero

    def gather_half(params):
        """The compute-dtype copy of the whole model from this rank's
        shards: each cast, then gathered."""
        leaves, spec = tree_flatten(cast_params_once(params, cfg))
        return tree_unflatten([layout.gather(i, x) for i, x in
                               enumerate(leaves)], spec)

    def grad_of(p_half, mb):
        leaves, spec = tree_flatten(p_half)
        leaves = [x.detach().requires_grad_() for x in leaves]
        loss, metrics = forward_loss(tree_unflatten(leaves, spec), mb, rt,
                                     cfg)
        grads = torch.autograd.grad(loss, leaves)
        return {k: v.detach() for k, v in metrics.items()}, list(grads)

    def step_fn(params, opt_state, batch):
        with torch.no_grad():
            p_half = gather_half(params)
        if accum == 1:
            metrics, grads = grad_of(p_half, batch)
        else:
            grads, ms = None, []
            for i in range(accum):
                m, g = grad_of(p_half, {k: v[i] for k, v in batch.items()})
                # Token-weighted accumulation: each microbatch's grad is
                # of its mean loss, so scale it by its valid-token count.
                n = m["n_tokens"].to(cfg.compute_dtype)
                for x in g:
                    x.mul_(n)
                if grads is None:
                    grads = g
                else:
                    torch._foreach_add_(grads, g)
                del g
                ms.append(m)
            n_total = torch.stack([m["n_tokens"] for m in ms]).sum()
            for x in grads:
                x.div_(n_total.to(x.dtype))
            w = [m["n_tokens"] / n_total for m in ms]
            metrics = {k: (n_total if k == "n_tokens"
                           else sum(m[k] * wi for m, wi in zip(ms, w)))
                       for k in ms[0]}
        del p_half
        spec = tree_flatten(params)[1]
        for i in range(len(grads)):
            # The one reduction point: each rank holds its tokens' share
            # of the global grad; the sum over the world is the whole
            # grad, of which this rank keeps its shard.
            g, grads[i] = grads[i], None
            grads[i] = layout.reduce(i, g.float())
            del g
        gnorm = layout.grad_norm(grads) if rt.mesh is not None else None
        grads = tree_unflatten(grads, spec)
        with torch.no_grad():
            params, opt_state, om = adamw_update(
                params, grads, opt_state, opt_cfg, decay=layout.decay,
                gnorm=gnorm)
        metrics.update(om)
        return params, opt_state, metrics

    return step_fn
