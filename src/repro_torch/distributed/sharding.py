"""The data mesh of the multi-device GNN trainer (counterpart of the
``make_data_mesh`` and ``require_data_axis`` helpers of
``repro.distributed.sharding``), and its single-tensor all-gather.

The reference lays the trainer's p device slots over a 1-D ``("data",)``
``jax.sharding.Mesh`` of one process's devices. Here every slot is a
process (a rank of ``torch.distributed``) driving its own device, and the
mesh is a 1-D ``DeviceMesh`` over the default process group. The LM
sharding rules of the reference's module are not ported (ROADMAP.md queue
A, item A.14).
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_data_mesh(num_devices: int, device_type: str = "cuda"
                   ) -> DeviceMesh:
    """A 1-D ``("data",)`` mesh over the ``num_devices`` ranks of the
    default process group, one rank a device slot. Raises, saying how to
    launch the ranks, when there is no initialized group of that size."""
    if num_devices < 1:
        raise ValueError(f"num_devices must be >= 1, got {num_devices}")
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            f"data-parallel mesh needs {num_devices} ranks but no default "
            f"process group is initialized; launch one process per device "
            f"with repro_torch.distributed.launch.spawn_data_parallel, or "
            f"call torch.distributed.init_process_group(backend, "
            f"init_method, rank=r, world_size={num_devices}) in each")
    world = dist.get_world_size()
    if world != num_devices:
        raise ValueError(
            f"data-parallel mesh needs {num_devices} ranks but the default "
            f"process group has {world}; launch {num_devices} processes "
            f"or ask for a mesh of {world}")
    return init_device_mesh(device_type, (num_devices,),
                            mesh_dim_names=("data",))


def require_data_axis(mesh: DeviceMesh, num_devices: int) -> None:
    """Validate a user-supplied mesh against the trainer's device count:
    the mesh must carry a ``"data"`` axis whose extent equals
    ``num_devices`` (one rank per LoadBalancer device slot)."""
    names = tuple(mesh.mesh_dim_names or ())
    if "data" not in names:
        raise ValueError(
            f"trainer mesh must have a 'data' axis; got axes {names}")
    extent = mesh.size(names.index("data"))
    if extent != num_devices:
        raise ValueError(
            f"num_devices={num_devices} does not match the mesh's 'data' "
            f"axis extent {extent}: the sharded step runs batch slot d on "
            f"the axis's rank d, so the counts must agree (resize the mesh "
            f"or pass num_devices={extent})")


def all_gather_flat(out, inp, group=None) -> None:
    """One single-tensor all-gather: the 1-D ``out`` of p x ``inp.numel()``
    elements receives every rank's ``inp`` in rank order. PyTorch names it
    ``all_gather_single`` since 2.13, which deprecates its older name
    ``all_gather_into_tensor``; the installed one is called."""
    fn = getattr(dist, "all_gather_single", None)
    if fn is None:
        fn = dist.all_gather_into_tensor
    fn(out, inp, group=group)
