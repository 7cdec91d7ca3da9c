"""Device mesh and path sharding over ``torch.distributed`` (counterpart of ``orp_tpu/parallel/mesh.py``).

The JAX package's mesh is XLA's global view: one program, whose sharded
arrays get ``psum`` s inserted for them. Here the mesh is SPMD by hand:

- one process per rank, each driving one device (``cuda:{LOCAL_RANK %
  device_count}`` on the card, the CPU when asked);
- a 1-D ``torch.distributed.device_mesh.DeviceMesh`` named ``("paths",)``
  stands where ``jax.sharding.Mesh`` stands, over the ranks of the group that
  :func:`~orp_tpu_torch.parallel.multihost.initialize_multihost` formed;
- each rank holds its contiguous block of paths (:func:`path_indices`, the
  index-addressed Sobol and thinning streams make each block without
  communication), and the hedge nets and every decision are replicated;
- the reductions XLA lowers to ``psum`` are written out: :func:`path_sum` (an
  ``all_reduce`` SUM), :func:`path_mean` (the mean of the ranks' equal-shard
  means) and :func:`path_gather` (the global vector, as an ``all_reduce`` SUM
  of a zero-filled global buffer in which each rank wrote its block: exact,
  since ``x + 0 == x``, and on every backend, where ``gloo`` reduces CUDA
  tensors but does not gather them).

Every rank enters every collective in the same order, and every host branch
reads a replicated value (the result of an ``all_reduce``, the same bits on
every rank), so no rank waits on a collective the others skipped.

``MeshSpec`` names a topology by shape (frozen and hashable, as in the JAX
package); :func:`topology_fingerprint` spells it as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from orp_tpu_torch.utils.device import resolve_device

AXIS = "paths"
_MESHES: dict = {}


def _device_mesh_cls():
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A topology by shape: ``n_devices`` ranks over a 1-D ``axis`` mesh (None =
    every rank of the group). Hashable, and buildable wherever a group of that
    size exists."""

    n_devices: int | None = None
    axis: str = AXIS

    def __post_init__(self):
        if self.n_devices is not None and self.n_devices < 1:
            raise ValueError(f"MeshSpec.n_devices={self.n_devices}: need >= 1")

    @classmethod
    def from_flag(cls, value) -> "MeshSpec | None":
        """The CLI contract: ``None``/0 -> no mesh, an int/str N -> an N-rank mesh."""
        if value is None:
            return None
        n = int(value)
        return None if n == 0 else cls(n_devices=n)

    def build(self, device=None):
        return make_mesh(self.n_devices, axis=self.axis, device=device)

    def describe(self, device=None) -> dict:
        """JSON-able provenance: the resolved mesh shape and its device kind
        (builds the mesh: :func:`describe_mesh` describes a built one)."""
        return describe_mesh(self.build(device))


def describe_mesh(mesh) -> dict:
    """:meth:`MeshSpec.describe`'s fields of a BUILT mesh, read from the mesh
    object alone: no group is formed and no collective entered (the run
    manifest describes the mesh a run already built)."""
    platform, kind = _platform_kind(mesh_device(mesh))
    return {"axis": mesh.mesh_dim_names[0], "n_devices": mesh.size(),
            "mesh_shape": list(mesh.shape), "platform": platform, "device_kind": kind}


def _is_mesh(mesh) -> bool:
    return isinstance(mesh, _device_mesh_cls())


def spec_of(mesh) -> "MeshSpec | None":
    """``None``, an int rank count, a ``MeshSpec`` or a built mesh -> ``MeshSpec``
    (or None)."""
    if mesh is None or isinstance(mesh, MeshSpec):
        return mesh
    if isinstance(mesh, int):
        return MeshSpec.from_flag(mesh)
    if _is_mesh(mesh):
        return MeshSpec(n_devices=mesh.size(), axis=mesh.mesh_dim_names[0])
    raise TypeError(f"expected None, int, MeshSpec or DeviceMesh; got {type(mesh)}")


def as_mesh(mesh, device=None):
    """The built-mesh counterpart of :func:`spec_of` (None and the int-0 "no
    mesh" spelling pass through as None)."""
    if mesh is None or _is_mesh(mesh):
        return mesh
    spec = spec_of(mesh)
    return None if spec is None else spec.build(device)


def local_rank() -> int:
    """This process's index among its host's ranks: torchrun's ``LOCAL_RANK``,
    else the global rank."""
    env = os.environ.get("LOCAL_RANK")
    return int(env) if env is not None else (dist.get_rank() if dist.is_initialized() else 0)


def rank_device(device=None) -> torch.device:
    """The device this rank drives: ``cuda:{LOCAL_RANK % device_count}`` by
    default (raises with no card), or ``device`` when the caller names one."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank() % torch.cuda.device_count())
    return dev


def make_mesh(n_devices: int | None = None, axis: str = AXIS, device=None):
    """A 1-D ``DeviceMesh`` named ``(axis,)`` over the first ``n_devices`` ranks
    of the process group (all by default) on this rank's device
    (:func:`rank_device`). Needs the group
    (``parallel.multihost.initialize_multihost``); every rank of the group
    must call it for the whole group, and every rank of the submesh for a
    smaller one (:func:`join_submesh`, which a rank outside the submesh calls
    instead: here it raises)."""
    mesh = join_submesh(n_devices, axis=axis, device=device)
    if mesh is None:
        raise ValueError(f"rank {dist.get_rank()} is not among the first {n_devices} ranks: "
                         "only they build that mesh (parallel.mesh.join_submesh)")
    return mesh


def join_submesh(n_devices: int | None = None, axis: str = AXIS, device=None):
    """The mesh over the first ``n_devices`` ranks of the process group (all by
    default), or None on a rank outside them. The whole group is a
    ``DeviceMesh`` over every rank; a smaller one is a subgroup formed with
    group-local synchronization (``dist.new_group(...,
    use_local_synchronization=True)``), so only its members wait on each other
    and a rank outside it returns at once: after a degradation from 4 ranks to
    2 the standing-down ranks 2 and 3 make the same call and leave, and a later
    rebuild from 2 to 1 needs nothing of them. Meshes are cached by size, axis
    and device, so every later call is local."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a torch.distributed process group: call "
                           "parallel.multihost.initialize_multihost first")
    world = dist.get_world_size()
    if n_devices is not None and n_devices > world:
        raise ValueError(f"requested {n_devices} devices, have {world}")
    n = world if n_devices is None else n_devices
    dev = rank_device(device)
    key = (n, axis, dev)
    if key in _MESHES and _MESHES[key][0] is dist.group.WORLD:  # built in this group
        return _MESHES[key][1]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if n == world:
        mesh = _device_mesh_cls()(dev.type, list(range(n)), mesh_dim_names=(axis,))
    else:
        group = dist.new_group(ranks=list(range(n)), use_local_synchronization=True)
        mesh = (None if dist.get_rank() >= n
                else _device_mesh_cls().from_group(group, dev.type, mesh_dim_names=(axis,)))
    if mesh is not None:
        mesh._orp_device = dev
    _MESHES[key] = (dist.group.WORLD, mesh)
    return mesh


def mesh_device(mesh) -> torch.device:
    """The device this rank holds its shard on: the one :func:`make_mesh` was
    given, else the CPU or this rank's card, by the mesh's device type."""
    dev = getattr(mesh, "_orp_device", None)
    return dev if dev is not None else rank_device(mesh.device_type)


def mesh_size(mesh) -> int:
    return 1 if mesh is None else mesh.size()


def mesh_rank(mesh) -> int:
    """This rank's coordinate on the mesh's axis (0 without a mesh)."""
    if mesh is None:
        return 0
    coord = mesh.get_coordinate()
    if coord is None:
        raise RuntimeError(f"rank {dist.get_rank()} is not in the mesh {mesh}")
    return coord[0]


def dist_backend(mesh) -> str:
    """The backend of the mesh's process group (``"nccl"``, ``"gloo"``, ...)."""
    return str(dist.get_backend(mesh.get_group()))


def _platform_kind(dev: torch.device) -> tuple[str, str]:
    if dev.type == "cuda":
        return "gpu", torch.cuda.get_device_name(dev)
    return "cpu", "cpu"


def topology_fingerprint(mesh=None, device=None) -> str:
    """Filesystem-safe key of a topology, ``<platform>-<device kind>-n<mesh
    size>``, as the JAX package spells it: ``gpu-NVIDIA_H100_80GB_HBM3-n1`` on
    one card, ``cpu-cpu-n4`` for four CPU ranks. A built mesh names its own
    device; a ``MeshSpec`` or int that gives its rank count is spelled without
    building it (no group needed: one process names every topology it exports),
    on ``device``, else the default device (the card when one is present, the
    CPU otherwise, as JAX's default backend)."""
    return topology_entry(mesh, device)["dir"]


def topology_entry(mesh=None, device=None) -> dict:
    """The JAX package's index row of a topology (``aot/bundle_exec._topo_entry``):
    ``dir`` (:func:`topology_fingerprint`), ``axis`` (None for one device),
    ``n_devices``, ``mesh_shape``, ``platform`` and ``device_kind``, without
    building the mesh."""
    n, dev = _topology_of(mesh, device)
    platform, kind = _platform_kind(dev)
    spec = None if _is_mesh(mesh) else spec_of(mesh)
    axis = (mesh.mesh_dim_names[0] if _is_mesh(mesh) else
            None if spec is None or n == 1 else spec.axis)
    safe = lambda s: "".join(c if c.isalnum() else "_" for c in str(s))  # noqa: E731
    return {"dir": f"{safe(platform)}-{safe(kind)}-n{n}", "axis": axis, "n_devices": n,
            "mesh_shape": [n], "platform": platform, "device_kind": kind}


def _topology_of(mesh, device) -> tuple[int, torch.device]:
    """``(rank count, device)`` of a topology, building nothing where the count
    is given."""
    if _is_mesh(mesh):
        return mesh.size(), mesh_device(mesh)
    spec = spec_of(mesh)
    if spec is not None and spec.n_devices is None:
        m = spec.build(device)
        return m.size(), mesh_device(m)
    if device is not None:
        dev = torch.device(device)
    else:
        dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return (1 if spec is None else spec.n_devices), dev


def path_sharding(mesh, ndim: int = 1) -> tuple:
    """The placements of a path-sharded array: its leading axis split over the
    mesh (``Shard(0)``); trailing axes are whole on every rank."""
    from torch.distributed.tensor import Shard

    return (Shard(0),)


def replicated_sharding(mesh) -> tuple:
    """The placements of a replicated value (params, optimizer state, scalars)."""
    from torch.distributed.tensor import Replicate

    return (Replicate(),)


def largest_submesh(n_alive: int, axis: str = AXIS) -> "MeshSpec | None":
    """The biggest topology worth rebuilding on after device loss: the largest
    power of two <= ``n_alive`` (None = single device), so the power-of-two
    serve buckets stay shard-divisible."""
    if n_alive < 1:
        raise ValueError(f"largest_submesh: n_alive={n_alive} — no devices "
                         "survive; nothing to rebuild on")
    n = 1 << (int(n_alive).bit_length() - 1)
    return None if n <= 1 else MeshSpec(n_devices=n, axis=axis)


def _size_of(mesh) -> int:
    """The rank count of any mesh-ish value (1 for no mesh)."""
    spec = spec_of(mesh)
    if spec is None:
        return 1
    if spec.n_devices is not None:
        return spec.n_devices
    return as_mesh(mesh).size()


def pad_to_mesh(n: int, mesh) -> int:
    """Smallest multiple of the mesh size >= ``n`` (``n`` itself without a mesh)."""
    d = _size_of(mesh)
    return ((int(n) + d - 1) // d) * d


def _check_divisible(n: int, mesh, what: str) -> None:
    d = _size_of(mesh)
    if n % d:
        raise ValueError(
            f"{what}={n} must be divisible by the mesh size {d} "
            f"(pad to {pad_to_mesh(n, mesh)} — parallel.mesh.pad_to_mesh)")


def shard_rows(n: int, mesh, what: str = "n_paths") -> slice:
    """This rank's contiguous block of ``n`` global rows (all of them without
    a mesh); ``n`` must divide by the mesh size."""
    _check_divisible(n, mesh, what)
    block = n // mesh_size(mesh)
    lo = mesh_rank(mesh) * block
    return slice(lo, lo + block)


def path_indices(n_paths: int, mesh=None, device=None) -> torch.Tensor:
    """Global path indices ``0..n_paths-1`` as int64: all of them on
    ``resolve_device(device)`` (the card by default) without a mesh, this rank's
    contiguous block on its device with one. Fed to the index-addressed Sobol
    and thinning streams, each rank generates exactly its own paths.
    ``n_paths`` must divide by the mesh size (pad with :func:`pad_to_mesh`)."""
    mesh = as_mesh(mesh, device)
    if mesh is None:
        return torch.arange(n_paths, dtype=torch.int64, device=resolve_device(device))
    rows = shard_rows(n_paths, mesh)
    return torch.arange(rows.start, rows.stop, dtype=torch.int64, device=mesh_device(mesh))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_paths(tree, mesh):
    """Every tensor leaf cut to this rank's block of its leading (path) axis,
    on this rank's device; ``mesh=None`` returns the tree unchanged. A leading
    axis that does not divide by the mesh raises, naming the padded size."""
    mesh = as_mesh(mesh)
    if mesh is None:
        return tree

    def cut(x):
        x = torch.as_tensor(x)
        n = int(x.shape[0]) if x.ndim else 0
        return x[shard_rows(n, mesh, "leading (path) axis")].to(mesh_device(mesh))

    return _tree_map(cut, tree)


def path_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed over the mesh's ranks (an ``all_reduce`` SUM into a copy);
    ``x`` itself without a mesh."""
    if mesh is None:
        return x
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=mesh.get_group())
    return y


def path_mean(local_mean: torch.Tensor, mesh) -> torch.Tensor:
    """The global mean from each rank's mean over its equal shard: their sum
    over the ranks divided by the rank count (``local_mean`` itself without a
    mesh, and the same bits on a 1-rank mesh)."""
    if mesh is None:
        return local_mean
    return path_sum(local_mean, mesh) / mesh.size()


def path_means(mesh, *local_means: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """:func:`path_mean` of several tensors in one ``all_reduce`` (packed flat,
    then cut back to their shapes); the tensors themselves without a mesh."""
    if mesh is None:
        return local_means
    flat = path_mean(torch.cat([x.reshape(-1) for x in local_means]), mesh)
    return tuple(part.reshape(x.shape) for part, x in
                 zip(flat.split([x.numel() for x in local_means]), local_means))


def path_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """The global array from every rank's block of its leading axis, in rank
    order: each rank writes its block into a zero-filled global buffer and the
    buffers are summed (exact: every other term is 0). ``x`` without a mesh."""
    if mesh is None:
        return x
    n = x.shape[0]
    buf = torch.zeros((n * mesh.size(), *x.shape[1:]), dtype=x.dtype, device=x.device)
    lo = mesh_rank(mesh) * n
    buf[lo:lo + n] = x
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.get_group())
    return buf


def replicate_from_first(value: float, mesh, device) -> float:
    """The first rank's host ``value`` on every rank (a sum in which the other
    ranks add 0), for a host decision that must agree across ranks."""
    if mesh is None:
        return value
    t = torch.tensor([value if mesh_rank(mesh) == 0 else 0.0], dtype=torch.float64)  # orp: noqa[ORP001] -- a host scalar summed across ranks in f64 so the reduction is exact to the caller's float
    return float(path_sum(t.to(device), mesh).cpu()[0])


#: int64 slots of a :func:`broadcast_from_first` header
HEADER_INTS = 8


def broadcast_from_first(mesh, header=None, payload=None):
    """Rank 0's small host message on every rank of ``mesh``: ``header``, at
    most :data:`HEADER_INTS` ints, and an optional 1-D ``payload`` sent as
    float64 (exact for the f32 and f64 rows a request carries). Rank 0 passes
    them; every other rank passes nothing and gets ``(header, payload)``, the
    payload a CPU tensor or None. Two broadcasts over the mesh's group (the
    header, then the payload when there is one), on the CPU for ``gloo`` and on
    the rank's card for NCCL; every rank of the mesh must call it."""
    group = mesh.get_group()
    dev = torch.device("cpu") if dist_backend(mesh) == "gloo" else mesh_device(mesh)
    src = dist.get_global_rank(group, 0)
    first = mesh_rank(mesh) == 0
    hdr = torch.zeros(HEADER_INTS + 2, dtype=torch.int64)
    if first:
        ints = [int(x) for x in header]
        if len(ints) > HEADER_INTS:
            raise ValueError(f"header of {len(ints)} ints; at most {HEADER_INTS}")
        hdr[0] = len(ints)
        hdr[1:1 + len(ints)] = torch.tensor(ints, dtype=torch.int64)
        hdr[-1] = -1 if payload is None else int(payload.numel())
    hdr = hdr.to(dev)
    dist.broadcast(hdr, src=src, group=group)
    hdr = hdr.cpu()
    n_ints, n_pay = int(hdr[0]), int(hdr[-1])
    ints = [int(x) for x in hdr[1:1 + n_ints]]
    if n_pay < 0:
        return ints, None
    # f64 carries the f32 and f64 rows of a request exactly
    wire = torch.float64  # orp: noqa[ORP001] -- a host message, not a device path
    if first:
        buf = payload.reshape(-1).to(device=dev, dtype=wire).contiguous()
    else:
        buf = torch.empty(n_pay, dtype=wire, device=dev)
    dist.broadcast(buf, src=src, group=group)
    return ints, buf.cpu()
