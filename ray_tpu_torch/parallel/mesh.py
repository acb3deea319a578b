"""Device meshes: the port of ``ray_tpu/parallel/mesh.py``.

Axes used across the port, as in the reference:

  data   -- pure data parallelism
  fsdp   -- sharded data parallelism (params sharded over it)
  tensor -- tensor (Megatron-style) parallelism within a layer
  pipe   -- pipeline stages
  seq    -- sequence/context parallelism (ring attention, Ulysses)
  expert -- expert parallelism (MoE; ordered after the above)

What a mesh is in the port:

- ``make_mesh(axes, devices=None)`` keeps the reference's axis order
  (``AXIS_ORDER``), its ``-1`` wildcard and its error texts; the texts
  name the devices found, their platform and the chip spec
  (``observability.chipspec``). The result is the port's own ``Mesh``:
  ``axis_names``, ``shape`` (axis -> size), ``devices`` (an object array
  of ``torch.device`` in the mesh's shape) and ``size``.
- In one process a mesh's ranks are **virtual ranks on one
  ``torch.device``**: build it with an explicit ``devices=`` list of n
  entries of the same device, as ``RingGroup(n, device)`` holds n ranks.
  The caller asks for n ranks; no card count stands in for them. The
  functions that run over an axis of such a mesh take rank-major tensors
  (``x[r]`` is rank r's shard, as ``util/collective/ring.py`` lays them
  out).
- With no ``devices=`` the inventory is the process's ``torch.cuda``
  devices; a mesh it cannot fill raises, as the reference's does. A mesh
  over several distinct devices in one process is refused where it is
  used (``Mesh.device``): that layout comes with the mesh across
  processes.
- ``util.collective.get_group_mesh(name, axis)`` on a ``cuda`` group
  gives a 1-D ``Mesh`` over the group's ranks, one process and one card
  per rank (``Mesh.group`` is the group, ``Mesh.rank`` this process's
  rank), as the reference's ``xla`` group gives one over its devices.
- GSPMD partitioning changes no value, so a sharding over a virtual mesh
  is a record (``parallel.sharding``): the tensors lie whole on the
  mesh's device and a train step over the mesh computes the one-device
  step over the whole batch. The one exception is
  ``build_train_step(mesh=..., weight_update="sharded")`` on a mesh whose
  only axis above 1 is ``data``: that runs the rewrite the reference's
  docstring names (reduce-scatter, a 1/n update, allgather) as
  ``parallel.zero`` over a ``RingGroup`` of that size (kernels C2, C3).

The reference joins ``jax.distributed`` before listing devices under a
multi-host launch. The port joins ``torch.distributed`` (gloo) when the
launcher's variables say there is a group to join (``MASTER_ADDR`` and
``WORLD_SIZE`` above 1), and does nothing otherwise.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

AXIS_ORDER = ("data", "fsdp", "pipe", "seq", "tensor")

_distributed_join_attempted = False


def _multiprocess_env() -> bool:
    return bool(os.environ.get("MASTER_ADDR")) and \
        int(os.environ.get("WORLD_SIZE", "1") or 1) > 1


def _maybe_join_distributed() -> None:
    """Join the launcher's ``torch.distributed`` group once, and only
    when the environment names one; a failed join leaves local-only
    discovery, and ``make_mesh``'s inventory text reports the process
    topology."""
    global _distributed_join_attempted
    if _distributed_join_attempted:
        return
    _distributed_join_attempted = True
    if not _multiprocess_env():
        return
    import torch.distributed as dist

    if not dist.is_available() or dist.is_initialized():
        return
    try:
        dist.init_process_group("gloo", init_method="env://")
    except (RuntimeError, ValueError):
        pass


def discover_devices() -> List[torch.device]:
    """The process's CUDA devices (after the ``torch.distributed`` join
    that a multi-process launch asks for); empty on a host without one."""
    _maybe_join_distributed()
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _kind(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def device_inventory(devices: Optional[Sequence] = None
                     ) -> Dict[str, object]:
    """Count, platforms, device kinds and the chip spec's peaks of
    ``devices`` (default: ``discover_devices()``). Mixed kinds give the
    unknown spec, with no peaks."""
    from ray_tpu_torch.observability import chipspec

    devices = [torch.device(d) for d in (
        devices if devices is not None else discover_devices())]
    platforms = sorted({d.type for d in devices})
    kinds = sorted({_kind(d) for d in devices})
    spec = chipspec.lookup(kinds[0]) if len(kinds) == 1 else \
        chipspec.UNKNOWN
    return {
        "devices": len(devices),
        "platforms": platforms,
        "device_kinds": kinds,
        "spec": spec.spec,
        "measurement": spec.measurement,
        "peak_flops": spec.peak_flops,
        "peak_hbm_bytes_per_s": spec.peak_hbm_bytes_per_s,
    }


class Mesh:
    """Named axes over an array of devices. ``group`` (a ``cuda``
    collective group, one rank per process) is set for the meshes of
    ``get_group_mesh``; otherwise the ranks are virtual."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 group=None):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.size = int(devices.size)
        self.group = group
        self._rings: Dict[str, object] = {}

    def ring_group(self, axis: str):
        """The ``RingGroup`` of ``axis``'s virtual ranks on the mesh's
        device (made once per mesh and axis): what the ring kernels run
        over on this axis."""
        from ray_tpu_torch.util.collective import RingGroup

        group = self._rings.get(axis)
        if group is None:
            group = self._rings[axis] = RingGroup(
                mesh_axis_size(self, axis), self.device)
        return group

    @property
    def rank(self) -> Optional[int]:
        return None if self.group is None else self.group.rank

    @property
    def device(self) -> torch.device:
        """The one device the mesh's virtual ranks (or this process's
        rank) lie on."""
        if self.group is not None:
            return self.group.device
        distinct = {str(d) for d in self.devices.flat}
        if len(distinct) != 1:
            raise NotImplementedError(
                f"a mesh over {len(distinct)} devices in one process "
                f"({sorted(distinct)}): the port runs a mesh's ranks as "
                "virtual ranks on one device; several devices come with "
                "the mesh across processes")
        return self.devices.flat[0]

    def __repr__(self) -> str:
        if self.group is not None:
            form = f"rank {self.rank} of {type(self.group).__name__}"
        else:
            form = "on " + ", ".join(sorted({str(d)
                                             for d in self.devices.flat}))
        return f"Mesh({self.shape}, {form})"


def _device_array(devices: Sequence[torch.device], shape) -> np.ndarray:
    arr = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        arr[i] = d
    return arr.reshape(shape)


def _process_topology() -> str:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return f"; process {dist.get_rank()} of {dist.get_world_size()}"
    return "; process 0 of 1"


def make_mesh(axes: Dict[str, int],
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a Mesh from {axis: size}; one axis may be -1 (absorbs the
    rest). Axis order follows AXIS_ORDER, then the other axes in the
    order given. ``devices``: n entries for n ranks (the same device n
    times for virtual ranks); default ``discover_devices()``."""
    devices = [torch.device(d) for d in (
        devices if devices is not None else discover_devices())]
    n = len(devices)

    def _inventory() -> str:
        inv = device_inventory(devices)
        listing = ", ".join(str(d) for d in devices[:8])
        if n > 8:
            listing += f", ... ({n - 8} more)"
        kinds = "/".join(inv["device_kinds"]) or "none"
        return (f"discovered {n} device(s) on platform "
                f"{'/'.join(inv['platforms']) or 'none'} "
                f"(chip {kinds}, spec {inv['spec']}): [{listing}]"
                f"{_process_topology()}")

    if n == 0:
        raise ValueError(f"mesh {dict(axes)} needs devices but 0 are "
                         f"available; {_inventory()}")
    sizes = dict(axes)
    wild = [k for k, v in sizes.items() if v == -1]
    if len(wild) > 1:
        raise ValueError("only one axis may be -1")
    fixed = int(np.prod([v for v in sizes.values() if v != -1]))
    if wild:
        if n % fixed != 0:
            raise ValueError(
                f"cannot infer axis {wild[0]!r}: {n} devices not "
                f"divisible by the fixed-axis product {fixed} "
                f"(requested {axes}); {_inventory()}")
        sizes[wild[0]] = n // fixed
    total = int(np.prod(list(sizes.values())))
    if total != n:
        raise ValueError(
            f"mesh {sizes} needs {total} devices but {n} are available; "
            f"{_inventory()}")
    names = [a for a in AXIS_ORDER if a in sizes]
    names += [a for a in sizes if a not in names]
    shape = [sizes[a] for a in names]
    return Mesh(_device_array(devices, shape), names)


def data_parallel_mesh() -> Mesh:
    return make_mesh({"data": -1})


def fsdp_mesh(tensor: int = 1) -> Mesh:
    return make_mesh({"fsdp": -1, "tensor": tensor})


def mesh_axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1
