"""Test utilities: numeric comparison and the MLP fixture.

Counterpart of ``alpa_tpu/testing.py``: ``assert_allclose`` over pytrees,
``MLPModel`` with ``manual_pipeline_layer``, the MLP train state and batch,
and its train step, serial or parallelized.  The JAX package draws the
MLP's weights and batch from ``jax.random``; the port takes them as numpy
arrays (``params`` in the flax tree's layout, converted by
``model.convert.mlp_params_from_flax``), so that both packages can run the
same numbers.  Without them the weights and batch come from a seeded
``torch.Generator``.  The optimizer is the JAX fixture's, ``sgd`` with
learning rate 1e-2 and momentum 0.9, unless ``tx`` names another.
"""
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

import alpa_tpu_torch
from alpa_tpu_torch.device_mesh import DistributedArray
from alpa_tpu_torch.model.convert import mlp_params_from_flax
from alpa_tpu_torch.model.model_util import TrainState, make_apply_fn, sgd
from alpa_tpu_torch.pipeline_parallel.primitive_def import \
    mark_pipeline_boundary


def assert_allclose(x: Any, y: Any, rtol=1e-4, atol=1e-4):
    """Recursive comparison of dicts, sequences, tensors and numbers."""
    if isinstance(x, dict):
        assert isinstance(y, dict) and set(x) == set(y), (set(x), set(y))
        for k in x:
            assert_allclose(x[k], y[k], rtol, atol)
    elif isinstance(x, (tuple, list)):
        assert isinstance(y, (tuple, list)) and len(x) == len(y)
        for a, b in zip(x, y):
            assert_allclose(a, b, rtol, atol)
    elif x is None:
        assert y is None
    else:
        np.testing.assert_allclose(_numpy(x), _numpy(y), rtol, atol)


def _numpy(x):
    if isinstance(x, DistributedArray):
        x = x.gather("cpu")
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def gather_tree(tree):
    """``tree`` with each ``DistributedArray`` leaf gathered to a full
    tensor on the CPU, and every tensor leaf moved there."""
    from torch.utils import _pytree as pytree

    def full(x):
        if isinstance(x, DistributedArray):
            return x.gather("cpu")
        return x.detach().cpu() if isinstance(x, torch.Tensor) else x

    return pytree.tree_map(full, tree)


class MLPModel(nn.Module):
    """The MLP fixture: ``num_layers`` Linear layers with relu between them
    and, with ``manual_pipeline_layer``, a pipeline boundary before the
    middle one."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int = 2, manual_pipeline_layer: bool = False,
                 device=None):
        super().__init__()
        self.num_layers = num_layers
        self.manual_pipeline_layer = manual_pipeline_layer
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            nn.Linear(dims[i], dims[i + 1], device=device)
            for i in range(num_layers))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            if self.manual_pipeline_layer and i == self.num_layers // 2:
                mark_pipeline_boundary()
            x = layer(x)
            if i != self.num_layers - 1:
                x = torch.relu(x)
        return x


def create_mlp_train_state_and_batch(batch_size=64,
                                     input_dim=32,
                                     hidden_dim=32,
                                     output_dim=32,
                                     num_layers=2,
                                     manual_pipeline_layer=False,
                                     params=None,
                                     x: Optional[np.ndarray] = None,
                                     y: Optional[np.ndarray] = None,
                                     tx=None,
                                     device="cpu",
                                     seed=0):
    """(TrainState, {"x", "y"}) of the MLP.  ``params`` is the flax tree of
    the JAX fixture's weights (numpy arrays); ``x`` and ``y`` its batch."""
    model = MLPModel(input_dim, hidden_dim, output_dim, num_layers,
                     manual_pipeline_layer, device="meta")
    gen = torch.Generator().manual_seed(seed)
    if params is None:
        weights = {k: torch.randn(p.shape, generator=gen) * 0.1
                   for k, p in model.named_parameters()}
    else:
        weights = mlp_params_from_flax(params)
    model = model.to_empty(device=device)
    model.load_state_dict(weights)
    if x is None:
        x = torch.randn(batch_size, input_dim, generator=gen).numpy()
        y = torch.randn(batch_size, output_dim, generator=gen).numpy()
    batch = {"x": torch.tensor(np.asarray(x, np.float32), device=device),
             "y": torch.tensor(np.asarray(y, np.float32), device=device)}
    state = TrainState.create(apply_fn=make_apply_fn(model),
                              params=dict(model.named_parameters()),
                              tx=tx or sgd(1e-2, momentum=0.9))
    return state, batch


def get_mlp_train_step(parallel_method=None, use_value_and_grad=False):
    """The MLP's train step: parallelized with ``parallel_method``, else the
    plain (serial) function."""

    def train_step(state, batch):

        def loss_func(params):
            out = state.apply_fn(params, batch["x"])
            return torch.mean((out - batch["y"]) ** 2)

        if parallel_method is not None and not use_value_and_grad:
            grads = alpa_tpu_torch.grad(loss_func)(state.params)
            val = torch.zeros((), device=batch["x"].device)
        else:
            val, grads = alpa_tpu_torch.value_and_grad(loss_func)(
                state.params)
        new_state = state.apply_gradients(grads=grads)
        return new_state, val

    if parallel_method is not None:
        return alpa_tpu_torch.parallelize(train_step, method=parallel_method)
    return train_step
