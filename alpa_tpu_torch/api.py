"""Top-level user API: ``init``, ``shutdown``, ``@parallelize``, ``grad``.

Counterpart of ``alpa_tpu/api.py``.  The decorator keeps the JAX
package's argument semantics: ``static_argnums``/``donate_argnums``
("auto" for both), ``batch_argnums``, and executables cached per
(argument tree, shapes and dtypes, static values).  A Python number is
keyed as a 0-d tensor of its kind (int64, float32, bool), as JAX keys it as
a weakly typed scalar, so a step that returns its counter as a tensor
reuses the executable the Python counter made.  ``ShardParallel`` runs the
function eagerly; ``PipeshardParallel`` traces it once per executable.

``grad``/``value_and_grad`` apply the layer option that the pipeshard
compiler installs while it traces, and wrap ``(value, grads)`` in the
gradient marker; outside a pipeshard trace both are no-ops.

Donation: for an eager method a donated ``TrainState`` is flagged while the
step runs, so its ``apply_gradients`` updates params and optimizer moments
in place; a tracing method gets the donated leaves and frees them itself.
After the call every donated argument (and tensor leaf) that the call did not
hand back is marked deleted, and passing it again raises, the counterpart
of JAX's "Array has been deleted".  With ``donate_argnums="auto"`` the
TrainState-like arguments are donated.
"""
import functools
import itertools
import weakref
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch
from torch.utils import _pytree as pytree

from alpa_tpu_torch.device_mesh import (init_global_cluster,
                                        shutdown_global_cluster)
from alpa_tpu_torch.parallel_method import ParallelMethod, ShardParallel
from alpa_tpu_torch.pipeline_parallel.layer_construction import (
    current_layer_option, layer_level_transform)
from alpa_tpu_torch.pipeline_parallel.primitive_def import mark_gradient


def init(cluster: str = "local",
         devices: Optional[Sequence] = None,
         num_nodes: Optional[int] = None,
         num_devices_per_node: Optional[int] = None):
    """Initialize the device cluster: this process's CUDA devices, or the
    devices named (``devices=["cpu"]`` runs on the CPU).  Raises without
    CUDA unless devices are named."""
    init_global_cluster(cluster, devices, num_nodes, num_devices_per_node)


def shutdown():
    """Release cluster state."""
    shutdown_global_cluster()


_ARRAYS = (torch.Tensor, np.ndarray, float, int, complex, bool)


def _is_static_arg(arg) -> bool:
    return not any(isinstance(x, _ARRAYS) for x in pytree.tree_leaves(arg))


def _is_state_like(arg) -> bool:
    """TrainState(-like) arguments, the only "auto" donation targets."""
    return hasattr(arg, "apply_gradients") and hasattr(arg, "params")


_SCALAR_DTYPES = ((bool, torch.bool), (int, torch.int64),
                  (float, torch.float32))


def _abstractify(x):
    """The cache key of one leaf: shape and dtype; a Python number as a 0-d
    tensor of its kind."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype)
    if isinstance(x, np.ndarray):
        return (x.shape, torch.from_numpy(np.empty(0, x.dtype)).dtype)
    for kind, dtype in _SCALAR_DTYPES:
        if isinstance(x, kind):
            return ((), dtype)
    return ((), type(x))


# arguments donated to an earlier call and not handed back, by id; weak, so
# a dropped object leaves the registry
_deleted = weakref.WeakValueDictionary()


def _donatable(x) -> bool:
    return isinstance(x, torch.Tensor) or _is_state_like(x)


def _check_live(args):
    for x in itertools.chain(args, pytree.tree_leaves(args)):
        if _donatable(x) and _deleted.get(id(x)) is x:
            raise RuntimeError(
                f"this {type(x).__name__} was donated to a parallelized call "
                "and has been deleted; pass the value that call returned")


def _mark_deleted(donated_args, flat_out):
    kept = {id(x) for x in flat_out}
    for arg in donated_args:
        for x in [arg] + pytree.tree_leaves(arg):
            if _donatable(x) and id(x) not in kept:
                _deleted[id(x)] = x


_live_parallelized: "weakref.WeakSet" = weakref.WeakSet()


def clear_executable_cache():
    """Drop every executable cached by @parallelize functions."""
    for pf in list(_live_parallelized):
        pf._executable_cache.clear()
        pf._last_executable = None


class ParallelizedFunc:
    """The callable returned by ``@parallelize``."""

    def __init__(self,
                 fun: Callable,
                 method: Optional[ParallelMethod],
                 static_argnums: Union[str, Sequence[int]] = "auto",
                 donate_argnums: Union[str, Sequence[int]] = "auto",
                 batch_argnums: Sequence[int] = (1,)):
        functools.update_wrapper(self, fun)
        self.fun = fun
        self.method = method or ShardParallel()
        self.static_argnums = static_argnums
        self.donate_argnums = donate_argnums
        self.batch_argnums = tuple(batch_argnums)
        self._executable_cache = {}
        self._last_executable = None
        _live_parallelized.add(self)

    def _decode_args(self, args):
        """Split static and dynamic args, flatten, build the cache key."""
        if self.static_argnums == "auto":
            static_idx = tuple(
                i for i, a in enumerate(args) if _is_static_arg(a))
        else:
            static_idx = tuple(self.static_argnums)
        dyn_idx = tuple(i for i in range(len(args)) if i not in static_idx)
        static_vals = tuple(args[i] for i in static_idx)
        flat_args, in_tree = pytree.tree_flatten(
            tuple(args[i] for i in dyn_idx))
        # the original argument index of each leaf
        leaf_arg = tuple(itertools.chain.from_iterable(
            [i] * len(pytree.tree_leaves(args[i])) for i in dyn_idx))
        avals = tuple(_abstractify(x) for x in flat_args)
        batch_invars = tuple(i in self.batch_argnums for i in leaf_arg)
        if self.donate_argnums == "auto":
            donated = tuple(i for i in dyn_idx
                            if i not in self.batch_argnums and
                            _is_state_like(args[i]))
        else:
            donated = tuple(self.donate_argnums)
        donated_invars = tuple(i in donated for i in leaf_arg)
        return (static_idx, static_vals, flat_args, in_tree, avals,
                batch_invars, donated, donated_invars)

    def _get(self, args):
        _check_live(args)
        (static_idx, static_vals, flat_args, in_tree, avals, batch_invars,
         donated, donated_invars) = self._decode_args(args)
        key = (in_tree, avals, static_idx, static_vals, batch_invars, donated)
        try:
            cached = self._executable_cache.get(key)
        except TypeError:  # unhashable static arg
            key, cached = None, None
        if cached is None:
            cached = self._make_executable(
                len(args), static_idx, static_vals, in_tree, donated,
                avals, batch_invars, donated_invars)
            if key is not None:
                self._executable_cache[key] = cached
        self._last_executable = cached[0]
        return cached, flat_args, donated

    def _make_executable(self, n_args, static_idx, static_vals, in_tree,
                         donated, avals, batch_invars, donated_invars):
        """(executable, flat_fun); ``flat_fun.out_tree`` is the output tree,
        set when it runs."""
        fun = self.fun
        in_place = self.method.donates_in_place

        def flat_fun(*flat):
            dyn = iter(pytree.tree_unflatten(list(flat), in_tree))
            static = iter(static_vals)
            full = [next(static) if i in static_idx else next(dyn)
                    for i in range(n_args)]
            if in_place:
                for i in donated:
                    if _is_state_like(full[i]):
                        # lets apply_gradients update in place
                        object.__setattr__(full[i], "_donated", True)
            flat_out, flat_fun.out_tree = pytree.tree_flatten(fun(*full))
            return flat_out

        executable = self.method.compile_executable(
            flat_fun, avals=avals, batch_invars=batch_invars,
            donated_invars=donated_invars)
        return executable, flat_fun

    def get_executable(self, *args):
        (executable, _), flat_args, _ = self._get(args)
        return executable, flat_args

    def __call__(self, *args):
        (executable, flat_fun), flat_args, donated = self._get(args)
        flat_out = executable.launch_on_driver(*flat_args)
        _mark_deleted([args[i] for i in donated], flat_out)
        return pytree.tree_unflatten(flat_out, flat_fun.out_tree)

    def get_last_executable(self):
        return self._last_executable


def parallelize(fun: Optional[Callable] = None,
                *,
                method: Optional[ParallelMethod] = None,
                static_argnums: Union[str, Sequence[int]] = "auto",
                donate_argnums: Union[str, Sequence[int]] = "auto",
                batch_argnums: Sequence[int] = (1,)):
    """Parallelize a single-device PyTorch function.  The default method,
    ``ShardParallel()``, runs on the global mesh: the CUDA device, raising
    without CUDA unless ``init`` named other devices."""

    def decorate(f):
        return ParallelizedFunc(f, method, static_argnums, donate_argnums,
                                batch_argnums)

    if fun is None:
        return decorate
    return decorate(fun)


def _maybe_layer_transform(fun):
    """``fun`` under the layer option the pipeshard compiler installed while
    it traces; ``fun`` itself otherwise."""
    opt = current_layer_option()
    return fun if opt is None else layer_level_transform(fun, opt)


def value_and_grad(fun, argnums: int = 0, has_aux: bool = False):
    """``jax.value_and_grad`` for PyTorch: the value of ``fun`` and the
    gradient of its (first, with ``has_aux``) output with respect to the
    tensor leaves of argument ``argnums``, in that argument's structure.
    A leaf the output does not depend on gets a zero gradient."""

    @functools.wraps(fun)
    def wrapped(*args, **kwargs):
        leaves, spec = pytree.tree_flatten(args[argnums])
        run = _maybe_layer_transform(fun)
        with torch.enable_grad():
            diff = [x.detach().requires_grad_() for x in leaves]
            call = list(args)
            call[argnums] = pytree.tree_unflatten(diff, spec)
            val = run(*call, **kwargs)
            grads = torch.autograd.grad(val[0] if has_aux else val, diff,
                                        allow_unused=True,
                                        materialize_grads=True)
        val = pytree.tree_map(
            lambda t: t.detach() if isinstance(t, torch.Tensor) else t, val)
        return mark_gradient((val, pytree.tree_unflatten(list(grads), spec)))

    return wrapped


def grad(fun, argnums: int = 0, has_aux: bool = False):
    """``jax.grad`` for PyTorch (see ``value_and_grad``)."""
    vg = value_and_grad(fun, argnums, has_aux)

    @functools.wraps(fun)
    def wrapped(*args, **kwargs):
        val, grads = vg(*args, **kwargs)
        return (grads, val[1]) if has_aux else grads

    return wrapped
