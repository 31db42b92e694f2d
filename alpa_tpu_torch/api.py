"""Top-level user API: ``init``, ``shutdown``, ``@parallelize``, ``grad``.

Counterpart of ``alpa_tpu/api.py``.  The decorator keeps the JAX
package's argument semantics: ``static_argnums``/``donate_argnums``
("auto" for both), ``batch_argnums``, and executables cached per
(argument tree, shapes and dtypes, static values).  A Python number is
keyed as a 0-d tensor of its kind (int64, float32, bool), as JAX keys it as
a weakly typed scalar, so a step that returns its counter as a tensor
reuses the executable the Python counter made.  ``ShardParallel()`` runs
the function eagerly on one device; with gradient accumulation or a
sharding option, on more than one device, and under ``PipeshardParallel``,
it is traced once per executable.  Over more than one device the state
comes back sharded (``DistributedArray`` leaves) and is passed back as it
is; ``get_last_executable()`` exposes the plan (``plan``, ``in_specs``,
``out_specs``) and the collectives per step (``get_collective_counts()``).

``grad``/``value_and_grad`` apply the layer option that the pipeshard
compiler installs while it traces, and wrap ``(value, grads)`` in the
gradient marker; outside a pipeshard or shard-parallel trace both are
no-ops.

Donation: with ``donate_argnums="auto"`` a leaf of a TrainState-like
argument is donated where an output leaf not yet claimed has its shape and
dtype (``_infer_donation``, JAX's rule: the outputs' shapes come from one
run of the function on fake tensors, the counterpart of
``jax.eval_shape``).  For an eager method a state whose tensor leaves are
all donated is flagged while the step runs, so its ``apply_gradients``
updates params and optimizer moments in place; a tracing method gets the
donated leaves and reuses or frees their storage itself.  After the call
every donated tensor leaf that the call did not hand back, and the argument
holding it, is marked deleted, and passing it again raises, the counterpart
of JAX's "Array has been deleted".
"""
import functools
import itertools
import logging
import logging
import time
import weakref
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils import _pytree as pytree

from alpa_tpu_torch.device_mesh import (DistributedArray,
                                        init_global_cluster,
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


_ARRAYS = (torch.Tensor, DistributedArray, np.ndarray, float, int, complex,
           bool)


logger = logging.getLogger(__name__)


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
    if isinstance(x, (torch.Tensor, DistributedArray)):
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
    return isinstance(x, (torch.Tensor, DistributedArray)) or \
        _is_state_like(x)


def _check_live(args):
    for x in itertools.chain(args, pytree.tree_leaves(args)):
        if _donatable(x) and _deleted.get(id(x)) is x:
            raise RuntimeError(
                f"this {type(x).__name__} was donated to a parallelized call "
                "and has been deleted; pass the value that call returned")


def _mark_deleted(args, leaf_arg, flat_args, donated_invars, flat_out):
    """Mark each donated tensor leaf that ``flat_out`` does not hold, and
    each argument with a donated leaf that it does not hold, deleted."""
    kept = {id(x) for x in flat_out}
    holders = set()
    for x, i, d in zip(flat_args, leaf_arg, donated_invars):
        if d:
            holders.add(i)
            if isinstance(x, (torch.Tensor, DistributedArray)) and \
                    id(x) not in kept:
                _deleted[id(x)] = x
    for i in holders:
        if _donatable(args[i]) and id(args[i]) not in kept:
            _deleted[id(args[i])] = args[i]


def _fake_leaves(flat_args):
    """Fake tensors in place of the tensor and array leaves (on the device
    of the first tensor leaf, where the executable would put host arrays);
    Python numbers stay as they are."""
    device = next((x.device for x in flat_args
                   if isinstance(x, torch.Tensor)), None) or next(
        (x.shards[0].device for x in flat_args
         if isinstance(x, DistributedArray)), torch.device("cpu"))
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    out = []
    for x in flat_args:
        if isinstance(x, (torch.Tensor, np.ndarray, DistributedArray)):
            shape, dtype = _abstractify(x)
            with mode:
                x = torch.empty(shape, dtype=dtype, device=device)
        out.append(x)
    return mode, out


def _infer_donation(flat_fun, flat_args, avals, batch_invars, state_invars):
    """``donate_argnums="auto"``: donate a leaf of a TrainState-like
    argument where an output leaf not yet claimed has the same shape and
    dtype (state flowing to new state), in the order of the flat leaves:
    the counterpart of ``alpa_tpu/api.py``'s ``_infer_donation``.  Other
    arguments are never auto-donated: a step returning ``(loss, grads)``
    matches every parameter, and donating parameters the caller still
    holds deletes live tensors.  The output shapes come from one run of
    ``flat_fun`` on fake tensors."""
    if not any(state_invars):
        return (False,) * len(avals)
    mode, fake = _fake_leaves(flat_args)
    with mode:
        out = flat_fun(*fake)
    pool = {}
    for o in out:
        key = _abstractify(o)
        pool[key] = pool.get(key, 0) + 1
    donated = []
    for aval, is_batch, is_state in zip(avals, batch_invars, state_invars):
        if is_state and not is_batch and pool.get(aval, 0) > 0:
            pool[aval] -= 1
            donated.append(True)
        else:
            donated.append(False)
    return tuple(donated)


def _leaf_paths(dyn_args) -> tuple:
    """The ``keystr`` path of each flat leaf of the dynamic arguments, e.g.
    ``[0].params['wte.weight']``; "" for each leaf when a node type of
    the tree has no key support (the planner then classifies no leaf as a
    parameter or optimizer state)."""
    try:
        leaves, _ = pytree.tree_flatten_with_path(dyn_args)
    except ValueError:
        return ("",) * len(pytree.tree_leaves(dyn_args))
    return tuple(pytree.keystr(path) for path, _ in leaves)


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
        state_invars = tuple(_is_state_like(args[i]) for i in leaf_arg)
        return (static_idx, static_vals, flat_args, in_tree, leaf_arg, avals,
                batch_invars, state_invars)

    def _get(self, args):
        _check_live(args)
        (static_idx, static_vals, flat_args, in_tree, leaf_arg, avals,
         batch_invars, state_invars) = self._decode_args(args)
        key = (in_tree, avals, static_idx, static_vals, batch_invars)
        try:
            cached = self._executable_cache.get(key)
        except TypeError:  # unhashable static arg
            key, cached = None, None
        if cached is None:
            in_paths = _leaf_paths(tuple(
                a for i, a in enumerate(args) if i not in static_idx))
            cached = self._make_executable(
                len(args), static_idx, static_vals, in_tree, in_paths,
                leaf_arg, flat_args, avals, batch_invars, state_invars)
            if key is not None:
                self._executable_cache[key] = cached
        self._last_executable = cached[0]
        return cached, flat_args, leaf_arg

    def _make_executable(self, n_args, static_idx, static_vals, in_tree,
                         in_paths, leaf_arg, flat_args, avals, batch_invars,
                         state_invars):
        """(executable, flat_fun, donated_invars); ``flat_fun.out_tree`` is
        the output tree, set when it runs; ``flat_fun.in_tree`` and
        ``flat_fun.in_paths`` are the arguments' tree and leaf paths, which
        a planning method reads."""
        fun = self.fun
        # the state arguments updated in place: set once donation is known
        in_place_states = []

        def flat_fun(*flat):
            dyn = iter(pytree.tree_unflatten(list(flat), in_tree))
            static = iter(static_vals)
            full = [next(static) if i in static_idx else next(dyn)
                    for i in range(n_args)]
            for i in in_place_states:
                # lets apply_gradients update in place
                object.__setattr__(full[i], "_donated", True)
            flat_out, flat_fun.out_tree = pytree.tree_flatten(fun(*full))
            return flat_out

        flat_fun.in_tree, flat_fun.in_paths = in_tree, in_paths
        tic = time.perf_counter()
        if self.donate_argnums == "auto":
            donated_invars = _infer_donation(flat_fun, flat_args, avals,
                                             batch_invars, state_invars)
        else:
            donated_invars = tuple(i in self.donate_argnums
                                   for i in leaf_arg)
        if self.method.donates_in_place:
            # a state is updated in place when all its tensors are donated
            tensor_leaves = {}
            for x, i, d, s in zip(flat_args, leaf_arg, donated_invars,
                                  state_invars):
                if s and isinstance(x, torch.Tensor):
                    tensor_leaves.setdefault(i, []).append(d)
            in_place_states.extend(i for i, ds in tensor_leaves.items()
                                   if all(ds))
        donation_seconds = time.perf_counter() - tic
        executable = self.method.compile_executable(
            flat_fun, avals=avals, batch_invars=batch_invars,
            donated_invars=donated_invars)
        # the seconds of auto donation's run on fake tensors
        executable.donation_seconds = donation_seconds
        self._save_parallel_plan(executable, avals, in_paths, batch_invars,
                                 donated_invars)
        return executable, flat_fun, donated_invars

    def _save_parallel_plan(self, executable, avals, in_paths, batch_invars,
                            donated_invars):
        """Keep the compile's replayable ``ParallelPlan`` in the compile
        cache (namespace ``parallel_plan``; ``alpa_tpu/api.py:232``), for
        ``plan_to_method``.  Archival only: a failure never breaks the
        compile."""
        from alpa_tpu_torch.compile_cache import (cache_enabled,
                                                  get_compile_cache)
        if not cache_enabled():
            return
        try:
            from alpa_tpu_torch.parallel_plan import executable_to_plan
            plan = executable_to_plan(
                executable, num_micro_batches=getattr(
                    self.method, "num_micro_batches", None))
            cache = get_compile_cache()
            method_desc = "{}({})".format(
                type(self.method).__name__,
                ",".join(f"{k}={v!r}" for k, v in
                         sorted(vars(self.method).items())))
            key = cache.make_key("parallel_plan", [
                "parallelize", getattr(self.fun, "__module__", "?"),
                getattr(self.fun, "__qualname__", repr(self.fun)),
                repr([(tuple(shape), str(dtype)) for shape, dtype in avals]),
                repr(tuple(in_paths)), repr(tuple(batch_invars)),
                repr(tuple(donated_invars)), method_desc])
            cache.put("parallel_plan", key, plan)
            executable.parallel_plan = plan
        except Exception:  # pylint: disable=broad-except
            logger.debug("parallel_plan save failed", exc_info=True)

    def get_executable(self, *args):
        (executable, _, _), flat_args, _ = self._get(args)
        return executable, flat_args

    def get_donated_invars(self, *args):
        """Which flat leaves of ``args`` a call donates."""
        (_, _, donated_invars), _, _ = self._get(args)
        return donated_invars

    def __call__(self, *args):
        (executable, flat_fun, donated_invars), flat_args, leaf_arg = \
            self._get(args)
        flat_out = executable.launch_on_driver(*flat_args)
        _mark_deleted(args, leaf_arg, flat_args, donated_invars, flat_out)
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


def value_and_grad(fun, argnums: Union[int, Sequence[int]] = 0,
                   has_aux: bool = False):
    """``jax.value_and_grad`` for PyTorch: the value of ``fun`` and the
    gradient of its (first, with ``has_aux``) output with respect to the
    tensor leaves of argument ``argnums``, in that argument's structure; for
    a tuple ``argnums``, a tuple of such gradients, one per argument.  A
    leaf the output does not depend on gets a zero gradient."""
    nums = (argnums,) if isinstance(argnums, int) else tuple(argnums)

    @functools.wraps(fun)
    def wrapped(*args, **kwargs):
        flat = [pytree.tree_flatten(args[i]) for i in nums]
        run = _maybe_layer_transform(fun)
        with torch.enable_grad():
            diff = [[x.detach().requires_grad_() for x in leaves]
                    for leaves, _ in flat]
            call = list(args)
            for i, d, (_, spec) in zip(nums, diff, flat):
                call[i] = pytree.tree_unflatten(d, spec)
            val = run(*call, **kwargs)
            grads = torch.autograd.grad(
                val[0] if has_aux else val,
                list(itertools.chain.from_iterable(diff)),
                allow_unused=True, materialize_grads=True)
        val = pytree.tree_map(
            lambda t: t.detach() if isinstance(t, torch.Tensor) else t, val)
        trees, pos = [], 0
        for d, (_, spec) in zip(diff, flat):
            trees.append(pytree.tree_unflatten(list(grads[pos:pos + len(d)]),
                                               spec))
            pos += len(d)
        return mark_gradient(
            (val, trees[0] if isinstance(argnums, int) else tuple(trees)))

    return wrapped


def grad(fun, argnums: Union[int, Sequence[int]] = 0, has_aux: bool = False):
    """``jax.grad`` for PyTorch (see ``value_and_grad``)."""
    vg = value_and_grad(fun, argnums, has_aux)

    @functools.wraps(fun)
    def wrapped(*args, **kwargs):
        val, grads = vg(*args, **kwargs)
        return (grads, val[1]) if has_aux else grads

    return wrapped
