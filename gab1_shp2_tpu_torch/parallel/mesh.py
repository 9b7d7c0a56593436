"""Device-mesh sharding for ensemble workloads.

Counterpart of ``gab1_shp2_tpu/parallel/mesh.py``.  The scaling axis of
this model family is the *ensemble* axis (parameter sets; N up to 10k in
the target workload).  The model state is tiny (18 species x O(100)
nodes), so the decomposition is pure data parallelism: the members are
split into equal shards, one per slot of a 1-D mesh, and every slot
solves its shard on its own device.

The JAX package runs its mesh in one process, and its shards never
communicate; the reference's own parallelism is ``Threads.@threads``
(``get_param_posteriors.jl:147``).  Here, likewise, one process runs one
worker thread per slot.  A thread on a CUDA device works inside
``torch.cuda.device(dev)`` on the stream the caller had current for
that device, so the device-global state a kernel library reads (the
current device) is the slot's.  A device may appear more than once in a
mesh: ``["cuda:0", "cuda:0"]`` gives two independent shards on one card,
``["cpu", "cpu"]`` two on the host.  Outputs are gathered on
``mesh.devices[0]`` in member order.  An exception in any worker is
raised in the caller once every worker has stopped.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

ENSEMBLE_AXIS = "ensemble"


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """A 1-D mesh: one slot per entry of ``devices``."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def normalize_device(dev) -> torch.device:
    """``dev`` as a ``torch.device``, a CUDA device with its index."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def ensemble_mesh(devices: Optional[Sequence] = None,
                  axis: str = ENSEMBLE_AXIS) -> DeviceMesh:
    """A 1-D mesh with the single axis ``axis`` over ``devices`` (default:
    every visible CUDA card; raises where there is none — pass
    ``["cpu", ...]`` to shard on the host)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ensemble_mesh() spans the CUDA cards, and "
                "torch.cuda.is_available() is False; pass devices "
                "(e.g. ['cpu', 'cpu']) to shard on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = tuple(normalize_device(d) for d in devices)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return DeviceMesh(devices=devs, axis_names=(axis,))


def _n_members(tree) -> int:
    return pytree.tree_leaves(tree)[0].shape[0]


def pad_to_multiple(tree, multiple: int):
    """Pad the leading axis of every leaf up to a multiple of ``multiple``
    (the slot count) by repeating the last member; returns
    ``(padded_tree, original_n)``."""
    n = _n_members(tree)
    pad = (-n) % multiple

    def _pad(a):
        if pad == 0:
            return a
        return torch.cat([a, a[-1:].expand((pad,) + tuple(a.shape[1:]))],
                         dim=0)

    return pytree.tree_map(_pad, tree), n


def shard_ensemble(tree, mesh: DeviceMesh):
    """Split a pytree with a leading ensemble axis into one equal shard
    per slot, each on its slot's device (a list in slot order).  The
    member count must be a multiple of the slot count
    (:func:`pad_to_multiple`)."""
    n, D = _n_members(tree), mesh.size
    if n % D:
        raise ValueError(f"{n} members do not split into {D} equal shards; "
                         "pad them with pad_to_multiple first")
    m = n // D
    return [pytree.tree_map(lambda a: a[i * m:(i + 1) * m].to(dev), tree)
            for i, dev in enumerate(mesh.devices)]


@contextlib.contextmanager
def _on_device(dev: torch.device, stream):
    """The context a worker of slot device ``dev`` runs in: the slot's
    card as the current device, and ``stream`` as its current stream."""
    if dev.type != "cuda":
        yield
        return
    with torch.cuda.device(dev), torch.cuda.stream(stream):
        yield


def run_sharded_batch(batch_fn: Callable, batched_args, mesh: DeviceMesh):
    """Run the *batch-aware* ``batch_fn`` on every slot's shard.

    Each slot's worker thread hands ``batch_fn`` its local (N/D, ...)
    shard of ``batched_args`` on the slot's device, so the per-slot
    program keeps the lane-minor batched layout (e.g.
    ``ops/batch_stiff.solve_stiff_batch``).  The returned pytrees are
    concatenated on ``mesh.devices[0]`` in member order.  If a worker
    raises, the first exception in slot order is raised here (with the
    others noted) after every worker has stopped.
    """
    shards = shard_ensemble(batched_args, mesh)
    streams = {dev: torch.cuda.current_stream(dev)
               for dev in mesh.devices if dev.type == "cuda"}

    def work(i):
        dev = mesh.devices[i]
        with _on_device(dev, streams.get(dev)):
            return batch_fn(shards[i])

    with concurrent.futures.ThreadPoolExecutor(
            max_workers=mesh.size,
            thread_name_prefix="ensemble-slot") as pool:
        futures = [pool.submit(work, i) for i in range(mesh.size)]
        concurrent.futures.wait(futures)
    errors = [f.exception() for f in futures]
    failed = [(i, e) for i, e in enumerate(errors) if e is not None]
    if failed:
        first = failed[0][1]
        for i, e in failed[1:]:
            first.add_note(f"slot {i} ({mesh.devices[i]}) also raised "
                           f"{type(e).__name__}: {e}")
        raise first
    dev0 = mesh.devices[0]
    return pytree.tree_map(
        lambda *xs: torch.cat([x.to(dev0) for x in xs], dim=0),
        *[f.result() for f in futures])


def run_sharded(fn: Callable, batched_args, mesh: DeviceMesh):
    """Apply the per-member ``fn`` over the ensemble, sharded over
    ``mesh``: every slot applies ``fn`` to its members one at a time and
    stacks the results (the JAX package vmaps ``fn``; the port's
    per-member solvers are host loops that ``torch.func.vmap`` cannot
    trace).  Outputs are gathered as in :func:`run_sharded_batch`."""

    def per_member(shard):
        outs = [fn(pytree.tree_map(lambda a: a[j], shard))
                for j in range(_n_members(shard))]
        return pytree.tree_map(lambda *xs: torch.stack(xs), *outs)

    return run_sharded_batch(per_member, batched_args, mesh)
