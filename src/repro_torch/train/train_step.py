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
a step each shard is cast to the compute dtype, and the model is
differentiated with respect to these compute-dtype shards (the
reference's ``cast_params_once`` before its gather).  Each leaf is
gathered where a layer uses it (``GatherAtUse``), in the compute dtype,
and freed when the layer's forward ends; the recompute of remat gathers
again.  The tied table is gathered once a forward, for the embedding and
the LM head.  Each rank's grads are its tokens' share of the global
loss's grads; the sum over the world, which this rank keeps its shard of,
is the reference's single reduction point: a reduce-scatter over the
leaf's group, then an all-reduce over the complement axes, in the
compute dtype (``ZeroLayout.reduce``; a replicated leaf is all-reduced
over the world).  With one microbatch each leaf's grad is reduced as it
comes out of the backward.  With ``grad_accum > 1`` the whole
compute-dtype grads are summed over the microbatches, as the reference's
scan carries them, and each leaf is reduced once after the loop.  The
reduced shards stay in the compute dtype; the global grad norm upcasts
them a leaf at a time and AdamW a group at a time.
Token weights use the global counts, which ``forward_loss`` reduces.
Remat applies inside each microbatch's forward, and each microbatch's
activations die with its iteration.

One device keeps the whole tree: its step casts it, differentiates with
respect to the cast leaves and upcasts the grads, with no gather.
"""
from __future__ import annotations

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.core.zero import GatherAtUse
from repro_torch.models.model import cast_params_once, forward_loss
from repro_torch.train.optimizer import adamw_update


def make_grad_fn(plan):
    """``grads_of(params, batch) -> (metrics, grads)``: the step's grads
    of the global mean loss in the params' leaf order; on a mesh each is
    this rank's shard of the sum over the world, in the compute dtype
    (the norm and AdamW upcast a leaf or a group at a time), on one device
    the whole grad in fp32.  The metrics are the step's."""
    cfg, rt, accum = plan.cfg, plan.rt, plan.grad_accum
    layout = plan.zero

    def grad_of(p_half, mb):
        leaves, spec = tree_flatten(p_half)
        leaves = [x.detach().requires_grad_() for x in leaves]
        loss, metrics = forward_loss(tree_unflatten(leaves, spec), mb, rt,
                                     cfg)
        grads = torch.autograd.grad(loss, leaves)
        return {k: v.detach() for k, v in metrics.items()}, list(grads)

    def one_device(params, batch):
        """The whole tree's grads in the compute dtype, summed
        token-weighted over the microbatches, then upcast."""
        with torch.no_grad():
            p_half = cast_params_once(params, cfg)
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
            metrics = _weighted(ms, n_total)
        del p_half
        for i in range(len(grads)):
            # Leaf by leaf, so at most one fp32 grad is new at a time.
            g, grads[i] = grads[i], None
            grads[i] = g.float()
            del g
        return metrics, grads

    def on_mesh(params, batch):
        """The per-layer step: gathers at use, grads reduced into this
        rank's shards in the compute dtype."""
        with torch.no_grad():
            shards, _ = tree_flatten(cast_params_once(params, cfg))
        leaves = [x.detach().requires_grad_() for x in shards]
        tree = tree_unflatten(leaves, tree_flatten(params)[1])
        grads = [None] * len(leaves)
        if accum == 1:
            def sink(i, g):
                grads[i] = layout.reduce(i, g.contiguous())

            loss, metrics = forward_loss(tree, batch, rt, cfg,
                                         GatherAtUse(layout, leaves, sink))
            loss.backward()
            return {k: v.detach() for k, v in metrics.items()}, grads
        summed, weight, ms = [None] * len(leaves), [None], []

        def add(i, g):
            # Token-weighted accumulation, as on one device.
            g = g * weight[0]
            if summed[i] is None:
                summed[i] = g
            else:
                summed[i].add_(g)

        for i in range(accum):
            loss, m = forward_loss(tree, {k: v[i] for k, v in batch.items()},
                                   rt, cfg, GatherAtUse(layout, leaves, add))
            weight[0] = m["n_tokens"].to(cfg.compute_dtype)
            loss.backward()
            del loss
            ms.append({k: v.detach() for k, v in m.items()})
        n_total = torch.stack([m["n_tokens"] for m in ms]).sum()
        for i in range(len(summed)):
            # The one reduction point of the step, leaf by leaf.
            g, summed[i] = summed[i].div_(n_total.to(summed[i].dtype)), None
            grads[i] = layout.reduce(i, g)
            del g
        return _weighted(ms, n_total), grads

    return one_device if rt.mesh is None else on_mesh


def make_train_step(plan):
    """``step_fn(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  ``batch`` leaves are tensors on the plan's device, with a
    leading microbatch axis when ``plan.grad_accum > 1``.  The params and
    optimizer state are updated in place; the metrics are device scalars
    (``lr`` a float), so the step never waits for the host."""
    rt, opt_cfg, layout = plan.rt, plan.opt, plan.zero
    grads_of = make_grad_fn(plan)

    def step_fn(params, opt_state, batch):
        metrics, grads = grads_of(params, batch)
        gnorm = layout.grad_norm(grads) if rt.mesh is not None else None
        grads = tree_unflatten(grads, tree_flatten(params)[1])
        with torch.no_grad():
            params, opt_state, om = adamw_update(
                params, grads, opt_state, opt_cfg, decay=layout.decay,
                gnorm=gnorm)
        metrics.update(om)
        return params, opt_state, metrics

    return step_fn


def _weighted(ms: list, n_total) -> dict:
    """The microbatches' metrics, each weighted by its share of the
    valid tokens; ``n_tokens`` summed."""
    w = [m["n_tokens"] / n_total for m in ms]
    return {k: (n_total if k == "n_tokens"
                else sum(m[k] * wi for m, wi in zip(ms, w)))
            for k in ms[0]}
