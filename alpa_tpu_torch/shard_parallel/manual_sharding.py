"""Manual shardings of inputs and outputs.

Counterpart of ``alpa_tpu/shard_parallel/manual_sharding.py``:
``ManualShardingOption`` carries the user's specs, which override the
planner's choice for the arguments they name.  A spec is a ``Spec``
(``sharding_spec.py``: per dim, the tuple of mesh axes) or None (the
planner decides); ``in_axis_resources`` is a pytree prefix of the
arguments, as JAX's ``flatten_axes`` takes it.
"""
import dataclasses
from typing import Any, List, Optional, Tuple

from torch.utils import _pytree as pytree


@dataclasses.dataclass
class ManualShardingOption:
    """User in/out specs (pytree prefixes allowed); ``mesh_axis_names``
    names the logical mesh dims (``alpa_tpu/shard_parallel/
    manual_sharding.py:19``)."""
    mesh_axis_names: Optional[Tuple[str, ...]] = None
    in_axis_resources: Any = None
    out_axis_resources: Any = None


def _is_spec(x) -> bool:
    return x is None or (isinstance(x, tuple) and
                         all(isinstance(a, tuple) for a in x))


def flat_specs_from_tree(tree_specs, in_tree, num_leaves: int
                         ) -> Optional[List]:
    """A pytree prefix of specs, broadcast over the argument tree
    ``in_tree`` to one entry per flat leaf (JAX's ``flatten_axes``)."""
    if tree_specs is None:
        return None
    args = pytree.tree_unflatten([object() for _ in range(num_leaves)],
                                 in_tree)
    flat_spec, spec_tree = pytree.tree_flatten(tree_specs, is_leaf=_is_spec)
    out: List = []
    for spec, sub in zip(flat_spec, spec_tree.flatten_up_to(args)):
        out.extend([spec] * len(pytree.tree_leaves(sub)))
    return out


def apply_manual_shardings(flat_specs, manual_specs_flat):
    """The planner's specs with the user's where given."""
    return [auto if spec is None else spec
            for auto, spec in zip(flat_specs, manual_specs_flat)]
