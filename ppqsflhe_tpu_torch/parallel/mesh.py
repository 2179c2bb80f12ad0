"""Process meshes for the framework's parallelism dimensions, on
``torch.distributed``.

Twin of :mod:`ppqsflhe_tpu.parallel.mesh`. The JAX package runs one
controller over a ``Mesh`` of devices, and its ``shard_map`` bodies run
once per device with ``jax.lax`` collectives between them. Here each device
is one process (a rank): every rank holds its local shard, and the port's
sharded functions are the ``shard_map`` bodies written out, with the
collectives below on the process group of a mesh axis. The axes are those
of the JAX package:

- ``client``: federated data parallelism; each rank holds its clients'
  ciphertext residues, and the aggregation is a modular sum over the axis;
- ``coef``: polynomial-coefficient sharding for the distributed NTT
  (:mod:`..ops.sharded_ntt`), the sequence-parallel analogue.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the default
process group, with named dims. On the card the backend is NCCL, one rank
per GPU; the CPU tests run ``gloo``. :func:`shard` and :func:`unshard` cut a
global tensor into the block of one rank and stitch the blocks back (the
counterparts of ``client_sharding`` and ``limb_sharding``).

:data:`collectives` counts the collectives issued through this module, ops
and payload bytes per kind, the bytes those of the op's output as
``bench_scaling.py``'s HLO scrape counts them
(``bench_scaling.py:40-104``): the port's counterpart of reading them off
the compiled program. A CUDA graph that captures collectives holds the
NCCL kernels of these groups' communicators: such graphs are tied to the
groups (:func:`tie`) and released by :func:`release_graphs` before
:func:`destroy_process_group` destroys the groups, so none outlives them.
"""

from __future__ import annotations

import contextlib
import math
import socket
import tempfile
import weakref

import torch
import torch.distributed as dist

# kind → {"ops", "bytes"} since the last reset
collectives = {k: {"ops": 0, "bytes": 0} for k in ("all_to_all", "all_reduce", "all_gather")}
# a raw 64-bit sum of 16 residues < 2^60 stays below 2^64 and below 16q,
# which the fold by 8q, 4q, 2q and q brings back into [0, q); a 17th term
# would leave the sum ≥ 16q for some inputs, beyond the fold
MAX_PSUM_SHARDS = 16
_SIGN = -(1 << 63)      # flips the sign bit: an unsigned compare as a signed one


def reset_collectives() -> None:
    for c in collectives.values():
        c["ops"] = c["bytes"] = 0


def read_collectives() -> dict:
    return {k: dict(v) for k, v in collectives.items()}


def restore_collectives(counts: dict) -> None:
    """Set the counter back to a :func:`read_collectives` snapshot (a
    capture issues nothing)."""
    for k, c in counts.items():
        collectives[k].update(c)


def _count(kind: str, t: torch.Tensor) -> None:
    collectives[kind]["ops"] += 1
    collectives[kind]["bytes"] += t.numel() * t.element_size()


# ---------------------------------------------------------------------------
# Process groups and meshes
# ---------------------------------------------------------------------------

def backend_for(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU: there is no fallback from
    one to the other."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# objects holding CUDA graphs with collectives of the current process groups,
# by id (a graph cache is a dict: unhashable)
_tied = weakref.WeakValueDictionary()


def tie(obj) -> None:
    """Tie ``obj`` (a graph or a graph cache, with a ``release()``) to the
    process groups: :func:`release_graphs` releases it."""
    _tied[id(obj)] = obj


def release_graphs() -> None:
    """Release every tied graph: each drops its CUDA graph (and the NCCL
    kernels it holds), and a later replay raises; a released cache stays
    tied and empty."""
    for obj in list(_tied.values()):
        obj.release()


def destroy_process_group() -> None:
    """``dist.destroy_process_group()`` after :func:`release_graphs`: no
    graph keeps the destroyed communicators' kernels."""
    release_graphs()
    dist.destroy_process_group()


@contextlib.contextmanager
def single_process_group(device="cuda"):
    """A one-rank process group on ``device``'s backend (a ``file://``
    rendezvous in a temporary directory), destroyed on exit after the
    graphs tied to it are released; on the card the current device is
    ``device``. Where a group is already initialized,
    that one is used and left as it is."""
    if dist.is_initialized():
        yield
        return
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(backend_for(device), init_method=f"file://{tmp}/rendezvous",
                                world_size=1, rank=0)
        try:
            yield
        finally:
            destroy_process_group()


def make_mesh(axis_sizes: dict | None = None, device_type: str = "cuda"):
    """A mesh over the initialized default group; with no sizes every rank
    sits on the ``client`` axis. Raises ValueError when the sizes' product
    is not the world size."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = {"client": world}
    if math.prod(axis_sizes.values()) != world:
        raise ValueError(f"mesh {axis_sizes} != {world} devices")
    return init_device_mesh(device_type, tuple(axis_sizes.values()),
                            mesh_dim_names=tuple(axis_sizes))


def axis_size(mesh, axis: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (``jax.lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    return mesh.get_group(axis)


def shard(x: torch.Tensor, index: int, count: int, dim: int) -> torch.Tensor:
    """Block ``index`` of ``count`` equal blocks of x along ``dim``."""
    if x.shape[dim] % count:
        raise ValueError(f"{count} shards do not divide dim {dim} of {tuple(x.shape)}")
    return x.chunk(count, dim)[index]


def unshard(parts, dim: int) -> torch.Tensor:
    """The blocks of :func:`shard`, in rank order, stitched back."""
    return torch.cat(list(parts), dim)


# ---------------------------------------------------------------------------
# Collectives (the jax.lax ones the shard_map bodies use)
# ---------------------------------------------------------------------------

def all_to_all_tiled(x: torch.Tensor, group, split_axis: int, concat_axis: int) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``:
    x is cut into D blocks along ``split_axis``, block d goes to rank d, and
    the blocks received are concatenated along ``concat_axis`` in the order
    of the ranks that sent them. ``all_to_all_single`` exchanges along dim
    0, so the blocks are packed onto a leading dim first and unpacked after."""
    D = dist.get_world_size(group)
    split_axis %= x.dim()
    concat_axis %= x.dim()
    send = x.unflatten(split_axis, (D, x.shape[split_axis] // D)).movedim(split_axis, 0)
    send = send.contiguous()
    recv = torch.empty_like(send)
    _count("all_to_all", recv)
    dist.all_to_all_single(recv, send, group=group)
    return recv.movedim(0, concat_axis).flatten(concat_axis, concat_axis + 1).contiguous()


def exchange_tiled(xs, split_axis: int, concat_axis: int) -> list:
    """What :func:`all_to_all_tiled` gives each of D ranks whose inputs are
    ``xs`` (in rank order), computed in one process: rank d receives block d
    of every input, concatenated in the order of the inputs."""
    D = len(xs)
    return [torch.cat([x.chunk(D, split_axis)[d] for x in xs], concat_axis) for d in range(D)]


def all_gather_stack(x: torch.Tensor, group) -> torch.Tensor:
    """``jax.lax.all_gather``: every rank's x stacked on a new leading axis
    of size D, in rank order, gathered flat into one preallocated tensor
    (rank d's elements are block d of the flat output)."""
    out = x.new_empty((dist.get_world_size(group),) + tuple(x.shape))
    _count("all_gather", out)
    dist.all_gather_into_tensor(out.view(-1), x.contiguous().view(-1), group=group)
    return out


def fold_mod(s: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Reduce a raw 64-bit sum of at most 16 residues < q (q < 2^60, so the
    sum is < 16q and < 2^64) into [0, q): the fold by 8q, 4q, 2q and q of
    the JAX package's sharded-round psum
    (``ppqsflhe_tpu/parallel/sharded_scheme.py:515-522``), each step
    halving the bound. The sum may exceed 2^63, so it is read as unsigned:
    int64 addition wraps as uint64 addition does, and each compare flips
    the sign bits."""
    for shift in (3, 2, 1, 0):
        step = q << shift
        s = torch.where((s ^ _SIGN) >= (step ^ _SIGN), s - step, s)
    return s


def psum_mod(x: torch.Tensor, q: torch.Tensor, group) -> torch.Tensor:
    """Modular ``psum``: every rank's residues x < q summed over ``group``
    (one ``all_reduce``) and folded back into [0, q); the result is on
    every rank. At most 16 ranks, as for the JAX psum: the raw sum of more
    could reach 16q, past the fold."""
    D = dist.get_world_size(group)
    if D > MAX_PSUM_SHARDS:
        raise ValueError(f"psum_mod folds at most {MAX_PSUM_SHARDS} shards (a raw sum of more "
                         f"residues can reach {MAX_PSUM_SHARDS}q, past the fold by 8q, 4q, 2q "
                         f"and q), got {D}")
    s = x.clone(memory_format=torch.contiguous_format)
    _count("all_reduce", s)
    dist.all_reduce(s, group=group)
    return fold_mod(s, q)

