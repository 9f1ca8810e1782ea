"""Production mesh construction (``repro/launch/mesh.py``).

A function, not a module-level constant, so importing this module never
touches the process group. Both build a ``DeviceMesh`` over the default
process group with an explicit device type and return it as a
:class:`~repro_torch.parallel.axes.NamedMesh` (``mesh.shape`` is the
reference's ``{name: size}``). ``"cuda"`` is the default; the tests pass
``"cpu"`` (gloo ranks) and the dry run a fake process group.
"""

from __future__ import annotations

from ..parallel.axes import NamedMesh

__all__ = ["make_production_mesh", "make_mesh"]


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> NamedMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
              device_type: str = "cuda") -> NamedMesh:
    """Arbitrary meshes (e.g. (2, 4) on 8 gloo ranks), over ranks
    0..prod(shape)-1 of the default process group."""
    from torch.distributed.device_mesh import init_device_mesh

    return NamedMesh(init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes)))
