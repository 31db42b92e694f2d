"""The port's pipeline schedules and stage assignment against the JAX
package's: the same arguments give the same task lists, the same uniform
layer-to-stage grouping and the same stage-to-mesh placement, exactly."""
import pytest

from alpa_tpu.pipeline_parallel import schedules as jax_schedules
from alpa_tpu.pipeline_parallel.stage_construction import \
    uniform_layer_to_stage as jax_uniform_layer_to_stage
from alpa_tpu_torch.pipeline_parallel import schedules
from alpa_tpu_torch.pipeline_parallel.stage_construction import \
    uniform_layer_to_stage

NAMES = ("gpipe", "1f1b", "1f1b_overlap_friendly", "inference")


def _pair(name, num_meshes, num_batch):
    num_stages = num_meshes if name == "inference" else 2 * num_meshes
    kw = dict(num_stages=num_stages, num_meshes=num_meshes,
              num_batch=num_batch)
    return (schedules.create_pipeline_schedule(name, **kw),
            jax_schedules.create_pipeline_schedule(name, **kw))


@pytest.mark.parametrize("num_batch", [1, 2, 4, 5])
@pytest.mark.parametrize("num_meshes", [1, 2, 3, 4])
@pytest.mark.parametrize("name", NAMES)
def test_schedule_tasks_equal_jax(name, num_meshes, num_batch):
    ours, theirs = _pair(name, num_meshes, num_batch)
    assert type(ours).__name__ == type(theirs).__name__
    assert ours.schedules == theirs.schedules
    assert ours.num_clock == theirs.num_clock
    assert ours.pprint_schedule() == theirs.pprint_schedule()


@pytest.mark.parametrize("name", NAMES)
def test_stage_mesh_mapping_equals_jax(name):
    for num_meshes in (1, 2, 3, 4):
        ours, theirs = _pair(name, num_meshes, 2)
        for stage in range(3 * num_meshes):
            assert (ours.stage_mesh_mapping(stage) ==
                    theirs.stage_mesh_mapping(stage)), (num_meshes, stage)
        for mesh in range(num_meshes):
            assert (ours.mesh_stage_mapping(mesh) ==
                    theirs.mesh_stage_mapping(mesh))


@pytest.mark.parametrize("num_stages", [1, 2, 3, 4, 5, 8])
def test_uniform_layer_to_stage_equals_jax(num_stages):
    for num_layers in range(num_stages, 25):
        assert (uniform_layer_to_stage(num_layers, num_stages) ==
                jax_uniform_layer_to_stage(num_layers, num_stages))


def test_unknown_schedule_raises_as_jax():
    with pytest.raises(ValueError, match="unknown pipeline schedule"):
        schedules.create_pipeline_schedule("zero_bubble", num_stages=2,
                                           num_meshes=1, num_batch=1)


@pytest.mark.parametrize("grid, shapes", [
    ((1, 4), [(1, 1)] * 4),
    ((1, 4), [(1, 2), (1, 1), (1, 1)]),
    ((2, 4), [(1, 4), (1, 2), (1, 2)]),
    ((4, 2), [(2, 2), (1, 1), (1, 1), (1, 2)]),
])
def test_sliced_submeshes_equal_jax(grid, shapes):
    """``get_sliced_virtual_submeshes`` packs the same devices into each
    submesh as the JAX package (device i of the grid stands for itself),
    and ``slice_1d`` takes the same rows and columns."""
    import numpy as np
    import torch

    from alpa_tpu.device_mesh import VirtualPhysicalMesh as JaxMesh
    from alpa_tpu.pipeline_parallel.stage_construction import \
        get_sliced_virtual_submeshes as jax_sliced
    from alpa_tpu_torch.device_mesh import VirtualPhysicalMesh
    from alpa_tpu_torch.pipeline_parallel.stage_construction import \
        get_sliced_virtual_submeshes

    ids = np.arange(grid[0] * grid[1]).reshape(grid)
    ours = VirtualPhysicalMesh([[f"cpu:{i}" for i in row] for row in ids])
    theirs = JaxMesh(*grid, devices=ids)

    def index_grid(mesh):
        return [[torch.device(d).index for d in row] for row in mesh.devices]

    for a, b in zip(get_sliced_virtual_submeshes(ours, shapes),
                    jax_sliced(theirs, shapes)):
        assert index_grid(a) == np.asarray(b.devices).tolist()
    for dim in (0, 1):
        rows = [[i] for i in range(grid[dim])]
        for a, b in zip(ours.slice_1d(dim, rows), theirs.slice_1d(dim, rows)):
            assert index_grid(a) == np.asarray(b.devices).tolist()
