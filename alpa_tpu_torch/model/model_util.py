"""Train state, optimizers and losses.

Counterpart of ``alpa_tpu/model/model_util.py``.  The JAX package builds on
flax's ``TrainState`` and optax; the port keeps their math in plain
PyTorch.  Parameters are a flat ``{name: tensor}`` dict (the keys of
``named_parameters``), and a ``GradientTransformation`` is an optax-style
``(init, update)`` pair over such dicts.

Updates are functional, as in JAX: ``apply_gradients`` returns a new state
and leaves the old one as it was, unless the state was donated to a
``parallelize``d step.  Then params and optimizer moments are updated in
place, and the step marks the old state deleted (the counterpart of JAX
reusing a donated buffer).  ``DynamicScaleState`` (fp16 loss scaling) is
not ported: it is off the bf16 path.
"""
import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree
from torch.utils import checkpoint as torch_checkpoint

Params = Dict[str, torch.Tensor]


class GradientTransformation(NamedTuple):
    """optax's pair.  ``update(updates, state, params, inplace)`` returns
    ``(updates, state)``; with ``inplace`` it may overwrite the tensors of
    ``state`` (never ``updates`` or ``params``)."""
    init: Callable[[Params], Any]
    update: Callable[..., Any]


def _write(old: torch.Tensor, new: torch.Tensor, inplace: bool):
    return old.copy_(new) if inplace else new


def chain(*txs: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(tx.init(params) for tx in txs)

    def update(updates, state, params=None, inplace=False):
        new_state = []
        for tx, s in zip(txs, state):
            updates, s = tx.update(updates, s, params, inplace)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """Scale updates by max_norm / ||g|| where the global norm exceeds
    max_norm (optax's arithmetic, without a host sync)."""

    def update(updates, state, params=None, inplace=False):
        del params, inplace
        g_norm = torch.stack([(g.float() ** 2).sum()
                              for g in updates.values()]).sum().sqrt()
        trigger = g_norm < max_norm
        return {k: torch.where(trigger, g, (g / g_norm.to(g.dtype)) * max_norm)
                for k, g in updates.items()}, state

    return GradientTransformation(lambda params: (), update)


def scale_by_adam(b1=0.9, b2=0.999, eps=1e-8,
                  eps_root=0.0) -> GradientTransformation:
    def init(params):
        return {"count": 0,
                "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(updates, state, params=None, inplace=False):
        del params
        count = state["count"] + 1
        bc1, bc2 = 1 - b1 ** count, 1 - b2 ** count
        mu, nu, out = {}, {}, {}
        with torch.no_grad():
            for k, g in updates.items():
                m = _write(state["mu"][k], (1 - b1) * g + b1 * state["mu"][k],
                           inplace)
                v = _write(state["nu"][k],
                           (1 - b2) * (g * g) + b2 * state["nu"][k], inplace)
                mu[k], nu[k] = m, v
                out[k] = (m / bc1) / ((v / bc2 + eps_root).sqrt() + eps)
        return out, {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    def update(updates, state, params=None, inplace=False):
        del inplace
        return {k: u + weight_decay * params[k]
                for k, u in updates.items()}, state

    return GradientTransformation(lambda params: (), update)


def scale_by_learning_rate(learning_rate: float) -> GradientTransformation:
    def update(updates, state, params=None, inplace=False):
        del params, inplace
        return {k: -learning_rate * u for k, u in updates.items()}, state

    return GradientTransformation(lambda params: (), update)


def trace(decay: float) -> GradientTransformation:
    """``optax.trace`` (momentum, not Nesterov): t = g + decay * t."""

    def init(params):
        return {"trace": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(updates, state, params=None, inplace=False):
        del params
        with torch.no_grad():
            new = {k: _write(state["trace"][k], g + decay * state["trace"][k],
                             inplace) for k, g in updates.items()}
        return dict(new), {"trace": new}

    return GradientTransformation(init, update)


def sgd(learning_rate, momentum: Optional[float] = None
        ) -> GradientTransformation:
    """``optax.sgd``."""
    if momentum is None:
        return scale_by_learning_rate(learning_rate)
    return chain(trace(momentum), scale_by_learning_rate(learning_rate))


def adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8) -> GradientTransformation:
    """``optax.adam``."""
    return chain(scale_by_adam(b1, b2, eps),
                 scale_by_learning_rate(learning_rate))


def adamw(learning_rate, b1=0.9, b2=0.999, eps=1e-8,
          weight_decay=1e-4) -> GradientTransformation:
    """``optax.adamw`` (decay applied to every parameter)."""
    return chain(scale_by_adam(b1, b2, eps),
                 add_decayed_weights(weight_decay),
                 scale_by_learning_rate(learning_rate))


def create_adamw(learning_rate=1e-3, weight_decay=0.01, b1=0.9, b2=0.999,
                 grad_clip: Optional[float] = 1.0) -> GradientTransformation:
    chain_ = []
    if grad_clip:
        chain_.append(clip_by_global_norm(grad_clip))
    chain_.append(adamw(learning_rate, b1=b1, b2=b2,
                        weight_decay=weight_decay))
    return chain(*chain_)


def make_apply_fn(model: torch.nn.Module) -> Callable:
    """``apply_fn(params, *args, **kwargs)``: ``model`` run with ``params``
    (a ``{name: tensor}`` dict) in place of its own parameters, the
    counterpart of flax's ``model.apply``."""

    def apply_fn(params, *args, **kwargs):
        return torch.func.functional_call(model, params, args, kwargs)

    return apply_fn


@dataclasses.dataclass(frozen=True)
class TrainState:
    """flax's ``TrainState``: step, apply_fn, params, tx, opt_state."""
    step: int
    apply_fn: Callable = dataclasses.field(compare=False)
    params: Params
    tx: GradientTransformation = dataclasses.field(compare=False)
    opt_state: Any
    # set by a parallelized step on the state it was donated
    _donated = False

    @classmethod
    def create(cls, *, apply_fn, params: Params, tx: GradientTransformation):
        params = {k: p.detach() for k, p in params.items()}
        return cls(step=0, apply_fn=apply_fn, params=params, tx=tx,
                   opt_state=tx.init(params))

    def apply_gradients(self, *, grads: Params) -> "TrainState":
        inplace = self._donated
        updates, opt_state = self.tx.update(grads, self.opt_state,
                                            self.params, inplace)
        with torch.no_grad():
            if inplace:
                for k, p in self.params.items():
                    p.add_(updates[k])
                params = self.params
            else:
                params = {k: p + updates[k] for k, p in self.params.items()}
        return dataclasses.replace(self, step=self.step + 1, params=params,
                                   opt_state=opt_state)


pytree.register_pytree_node(
    TrainState,
    lambda s: ([s.step, s.params, s.opt_state], (s.apply_fn, s.tx)),
    lambda leaves, ctx: TrainState(step=leaves[0], apply_fn=ctx[0],
                                   params=leaves[1], tx=ctx[1],
                                   opt_state=leaves[2]),
    serialized_type_name="alpa_tpu_torch.model.model_util.TrainState",
    # leaf paths such as ``[0].params['wte.weight']``, which the planner
    # reads to tell parameters from optimizer state
    flatten_with_keys_fn=lambda s: (
        [(pytree.GetAttrKey(k), getattr(s, k))
         for k in ("step", "params", "opt_state")], (s.apply_fn, s.tx)))


def gpt_lm_loss(apply_fn, params, batch, chunked=False):
    """LM loss of a GPT-family model with tied embeddings: dense fp32 CE,
    or the chunked lm-head + CE that never holds the full logits."""
    if chunked:
        hidden = apply_fn(params, batch["input_ids"], return_hidden=True)
        return chunked_cross_entropy_loss(hidden, params["wte.weight"],
                                          batch["labels"])
    logits = apply_fn(params, batch["input_ids"])
    return cross_entropy_loss(logits.float(), batch["labels"])


def cross_entropy_loss(logits, labels, label_mask=None):
    """Mean token cross-entropy (logsumexp - gold logit) with optional
    mask."""
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long(),
                           reduction="none").view(labels.shape)
    if label_mask is not None:
        return (loss * label_mask).sum() / label_mask.sum().clamp_min(1)
    return loss.mean()


def _chunk_losses(x, embedding, y):
    logits = (x @ embedding.T).float()
    gold = logits.gather(-1, y[:, None])[:, 0]
    return torch.logsumexp(logits, dim=-1) - gold


def chunked_cross_entropy_loss(hidden, embedding, labels, chunk_size=512):
    """Fused lm-head + mean cross-entropy without the full logits tensor.

    ``hidden``: (B, S, H) final hidden states; ``embedding``: (V, H) tied
    lm-head weights; ``labels``: (B, S) int.  Token rows go in
    ``chunk_size`` chunks, each recomputed in the backward pass, so peak
    logits memory is O(chunk * V).  The lm-head product runs in the
    embedding's dtype, the logsumexp in fp32.  The JAX version pads the
    last chunk and masks it; a shorter last chunk gives the same mean."""
    h = hidden.shape[-1]
    x = hidden.reshape(-1, h).to(embedding.dtype)
    y = labels.reshape(-1).long()
    losses = [torch_checkpoint.checkpoint(_chunk_losses, x[i:i + chunk_size],
                                          embedding, y[i:i + chunk_size],
                                          use_reentrant=False)
              for i in range(0, x.shape[0], chunk_size)]
    return torch.cat(losses).mean()
