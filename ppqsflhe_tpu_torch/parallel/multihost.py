"""Multi-host execution: the hosts of a federation in one
``torch.distributed`` job instead of HTTP file hops between them.

Twin of :mod:`ppqsflhe_tpu.parallel.multihost`. One process per device
joins the job; the global ``client`` axis is laid out process-major, so
each rank keeps its own clients' ciphertext residues, and the encrypted
FedAvg and the threshold fusion are one modular psum each over the job
(NCCL between cards, ``gloo`` on CPUs). The HTTP/file control plane of
:mod:`..comm` stays for federations whose hosts share no job.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import torch
import torch.distributed as dist

from ..ckks import threshold as th
from ..ckks.multikey import aggregate_sharded
from .mesh import axis_group, backend_for, free_port, make_mesh


def _env(*names):
    for name in names:
        if os.environ.get(name):
            return os.environ[name]
    return None


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, device="cuda") -> None:
    """Join the job: rendezvous at ``coordinator_address`` (host:port) as
    rank ``process_id`` of ``num_processes``. Unset arguments come from the
    environment ``torchrun`` sets (``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``) or, as a convenience, from the names the JAX
    module reads (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``,
    ``JAX_PROCESS_ID``). On the card the backend is NCCL and the rank's
    device is ``LOCAL_RANK`` (else the rank modulo the cards present); on
    the CPU, ``gloo``."""
    addr = coordinator_address or _env("JAX_COORDINATOR_ADDRESS")
    if addr is None and _env("MASTER_ADDR"):
        addr = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    world = num_processes or _env("JAX_NUM_PROCESSES", "WORLD_SIZE")
    rank = process_id if process_id is not None else _env("JAX_PROCESS_ID", "RANK")
    if addr is None or world is None or rank is None:
        raise ValueError("initialize needs a coordinator address, a process count and a "
                         "process id (arguments, or the torchrun / JAX_* environment)")
    device = torch.device(device)
    if device.type == "cuda":
        local = _env("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else int(rank) % torch.cuda.device_count())
    dist.init_process_group(backend_for(device), init_method=f"tcp://{addr}",
                            world_size=int(world), rank=int(rank))


def spawn_ranks(argv: list, n: int, device="cuda", timeout: float = 600) -> list:
    """Run ``python argv…`` as ranks 0 … n−1 of one job on this host (the
    environment ``torchrun`` would set; a free 127.0.0.1 port), wait for all
    of them, and return their outputs in rank order; raises if one fails or
    outlasts ``timeout`` seconds (all are then killed). On the card rank r
    takes card r (n must not exceed the cards present); on the CPU each
    rank sees no card and runs one thread."""
    cuda = torch.device(device).type == "cuda"
    if cuda and n > torch.cuda.device_count():
        raise ValueError(f"{n} ranks need {n} cards; {torch.cuda.device_count()} present")
    repo = str(Path(__file__).resolve().parents[2])
    base = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                WORLD_SIZE=str(n), PYTHONPATH=os.pathsep.join(
                    p for p in (repo, os.environ.get("PYTHONPATH")) if p))
    if not cuda:
        base.update(CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, *argv], cwd=repo, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              env=dict(base, RANK=str(r), LOCAL_RANK=str(r)))
             for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        raise RuntimeError(f"ranks of {argv} outlasted {timeout} s:\n" + "\n".join(outs))
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError(f"rank(s) {bad} of {argv} failed:\n"
                           + "\n".join(outs[r][-3000:] for r in bad))
    return outs


def global_client_mesh(device_type: str = "cuda"):
    """Every rank on one ``client`` axis, process-major (rank order), so a
    host's clients stay on its own devices."""
    return make_mesh({"client": dist.get_world_size()}, device_type)


def host_local_array(mesh, local: torch.Tensor, axis: str = "client") -> torch.Tensor:
    """This rank's (n_local, …) block of the global (n_total, …) stack: the
    stack stays where it is (the zero-copy counterpart of
    ``jax.make_array_from_process_local_data``). Raises unless ``axis`` is
    a dim of ``mesh`` and every rank on it holds the same n_local."""
    if axis not in mesh.mesh_dim_names:
        raise ValueError(f"mesh {mesh.mesh_dim_names} has no {axis!r} axis")
    n = local.shape[0]
    seen = torch.tensor([n, -n], dtype=torch.int64, device=local.device)
    dist.all_reduce(seen, op=dist.ReduceOp.MAX, group=axis_group(mesh, axis))
    if (int(seen[0]), -int(seen[1])) != (n, n):
        raise ValueError(f"ranks hold between {-int(seen[1])} and {int(seen[0])} local "
                         f"entries on {axis!r}; this one holds {n}")
    return local


def aggregate_multihost(ctx, local_stack: torch.Tensor, mesh, scale: float,
                        n_clients_total: int, average: bool = True):
    """Cross-host encrypted FedAvg over ``local_stack``, this rank's
    (clients_local, B, k, l, N) ciphertexts already in the common key
    domain: one modular psum over the global ``client`` axis
    (:func:`..ckks.multikey.aggregate_sharded`); every rank gets the
    aggregate."""
    return aggregate_sharded(ctx, host_local_array(mesh, local_stack), mesh, scale,
                             n_clients_total, average=average)


def partial_decrypt_multihost(ctx, ct, s_eval_local: torch.Tensor, gens_local, mesh,
                              smudging_bits: int | None = None) -> torch.Tensor:
    """Cross-host threshold decryption: this rank's parties'
    (``s_eval_local``, one generator each in ``gens_local``) smudged
    partials, fused by one psum over the job
    (:func:`..ckks.threshold.partial_decrypt_psum`)."""
    if smudging_bits is None:
        smudging_bits = th.DEFAULT_SMUDGING_BITS
    return th.partial_decrypt_psum(ctx, ct, host_local_array(mesh, s_eval_local), gens_local,
                                   mesh, smudging_bits=smudging_bits)
