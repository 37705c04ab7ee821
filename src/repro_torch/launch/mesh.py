"""Production mesh construction.

Counterpart of ``repro.launch.mesh``.  The meshes are built inside
functions, never at import, over whatever process group is initialised:
the dry-run's fake group of 256 or 512 ranks, or a real one.  The
single-pod mesh is 16 x 16 = 256 ranks (``("data", "model")``); multi-pod
adds a leading ``pod`` axis (2 pods = 512 ranks), the axis whose traffic
Vermilion's optical interconnect carries.

The device type is ``"cuda"`` even over a fake group: on a ``"cpu"`` mesh
DTensor replaces every all-to-all by an all-gather and a chunk, which would
count collectives under the wrong kind.
"""
from __future__ import annotations

__all__ = ["production_axes", "make_production_mesh", "make_host_mesh",
           "make_mesh"]


def production_axes(multi_pod: bool = False) -> dict[str, int]:
    """{axis name: size} of the production mesh, in mesh order."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_mesh(axes: dict[str, int], device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``axes`` ({name: size}, in mesh order) over the
    initialised process group, whose world size must be their product."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(axes.values()),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    return make_mesh(production_axes(multi_pod), device_type)


def make_host_mesh(data: int = 1, model: int = 1, device_type: str = "cuda"):
    """Small ``("data", "model")`` mesh over a group of ``data * model``
    ranks: tests and examples."""
    return make_mesh({"data": data, "model": model}, device_type)
