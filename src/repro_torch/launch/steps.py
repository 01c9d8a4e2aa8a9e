"""Step factories for training and serving (counterpart of
``repro.launch.steps``).

``make_train_step`` takes the gradient of ``bundle.loss_fn`` by autograd
over the parameters' leaves (``nn.param.flatten`` order) and applies the
optimizer (``optim.adam.AdamW`` or ``SGDM``, whose state holds lists of
tensors in that order). The serving steps run without autograd
(``torch.no_grad``). The reference's ``**kw`` (its sharding axis names)
has no counterpart without a mesh.
"""
from __future__ import annotations

import torch

from repro_torch.models.registry import ModelBundle
from repro_torch.nn.param import flatten, unflatten


def _loss_and_grads(bundle: ModelBundle, params, leaves, batch):
    """(loss, metrics, gradients of the loss over ``leaves``, in their
    dtype)."""
    live = [t.detach().requires_grad_() for t in leaves]
    loss, metrics = bundle.loss_fn(unflatten(params, live), batch)
    grads = torch.autograd.grad(loss, live)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def make_train_step(bundle: ModelBundle, optimizer):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``params`` is the model's tree, ``opt_state`` the optimizer's state of
    its flattened leaves. When cfg.grad_accum > 1 the batch is split into
    ``n_micro`` micro-batches along dim 0 (grad_accum, lowered until it
    divides the batch), each one's gradient taken apart and summed in fp32
    (bf16 when ``cfg.adam_dtype == "bfloat16"``), then the sum and the
    losses divided by ``n_micro``: activation memory / n_micro, as the
    reference's ``lax.scan``. Metrics: the loss function's (``loss``,
    ``ce``, ``aux``) for one micro-batch, else ``loss``; and the
    optimizer's (``lr``, ``grad_norm``)."""
    cfg = bundle.cfg
    accum = max(1, cfg.grad_accum)

    def step(params, opt_state, batch):
        leaves = flatten(params)
        b = next(iter(batch.values())).shape[0]
        n_micro = accum
        while b % n_micro:
            n_micro -= 1
        if n_micro <= 1:
            _, metrics, grads = _loss_and_grads(bundle, params, leaves,
                                                batch)
        else:
            acc_dt = (torch.bfloat16 if cfg.adam_dtype == "bfloat16"
                      else torch.float32)
            grads = [torch.zeros(t.shape, dtype=acc_dt, device=t.device)
                     for t in leaves]
            loss_sum = 0.0
            for i in range(n_micro):
                mb = {k: v.reshape((n_micro, b // n_micro) + v.shape[1:])[i]
                      if v.dim() >= 1 and v.shape[0] == b else v
                      for k, v in batch.items()}
                loss, _, g = _loss_and_grads(bundle, params, leaves, mb)
                for acc, gi in zip(grads, g):
                    acc.add_(gi)
                del g
                loss_sum = loss_sum + loss
            for g in grads:   # in place: the same bits as g / n_micro
                g.div_(n_micro)
            metrics = {"loss": loss_sum / n_micro}
        new_leaves, new_state, opt_metrics = optimizer.update(
            grads, opt_state, leaves)
        return (unflatten(params, new_leaves), new_state,
                {**metrics, **opt_metrics})

    return step


def make_prefill_step(bundle: ModelBundle):
    @torch.no_grad()
    def step(params, batch):
        return bundle.prefill_fn(params, batch)
    return step


def make_decode_step(bundle: ModelBundle):
    @torch.no_grad()
    def step(params, cache, batch):
        return bundle.decode_fn(params, cache, batch)
    return step
