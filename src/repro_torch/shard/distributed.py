"""Multi-process runtime: ``torch.distributed`` wiring for the shard layer.

The counterpart of ``repro.shard.distributed``: the same instance-axis
programs spanning a fleet of worker processes (on one host or many).  It
owns:

* :func:`initialize`: an idempotent ``init_process_group`` on the
  ``gloo`` backend, taking the coordinator address, process count and
  process id from arguments or from the ``REPRO_COORDINATOR`` /
  ``REPRO_NUM_PROCESSES`` / ``REPRO_PROCESS_ID`` environment (the contract
  ``tests/harness.py`` spawns workers with);
* :func:`initialize_from_env`: the no-op-when-unset variant entry points
  call unconditionally;
* :func:`all_gather_rows`: every process's row block, gathered in rank
  order as host tensors.

Gloo carries only the finished rows, which are small, whatever device
computed them: rows move, nothing is reduced, so the sharded results stay
bit-exact at any process count.  NCCL is not used: it cannot put two
ranks on one card.  Process ``p`` owns the ``p``-th contiguous block of
rows (:func:`repro_torch.shard.batch.shard_blocks`), so spawn order never
moves a row.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

ENV_COORDINATOR = "REPRO_COORDINATOR"
ENV_NUM_PROCESSES = "REPRO_NUM_PROCESSES"
ENV_PROCESS_ID = "REPRO_PROCESS_ID"

DEFAULT_TIMEOUT_S = 300


def is_initialized() -> bool:
    """True once this process has joined a fleet."""
    return dist.is_available() and dist.is_initialized()


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               initialization_timeout: int | None = None) -> None:
    """Join the fleet: ``init_process_group("gloo")`` at
    ``tcp://<coordinator>``, from arguments or the ``REPRO_*`` env.

    Arguments win over the environment; together they must give all three
    of (coordinator ``host:port``, process count, process id).  A second
    call is a no-op.  ``initialization_timeout`` (seconds, default 300)
    bounds the wait for the other processes: a rank that never joins
    makes every other rank fail, naming itself and the coordinator.
    """
    if is_initialized():
        return
    coordinator = coordinator or os.environ.get(ENV_COORDINATOR)
    if num_processes is None and os.environ.get(ENV_NUM_PROCESSES):
        num_processes = int(os.environ[ENV_NUM_PROCESSES])
    if process_id is None and os.environ.get(ENV_PROCESS_ID):
        process_id = int(os.environ[ENV_PROCESS_ID])
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError(
            "distributed.initialize needs coordinator address, process "
            "count and process id: pass them or set "
            f"{ENV_COORDINATOR}/{ENV_NUM_PROCESSES}/{ENV_PROCESS_ID} "
            f"(got coordinator={coordinator!r}, "
            f"num_processes={num_processes!r}, process_id={process_id!r})")
    timeout = int(initialization_timeout or DEFAULT_TIMEOUT_S)
    try:
        dist.init_process_group(
            backend="gloo", init_method=f"tcp://{coordinator}",
            world_size=int(num_processes), rank=int(process_id),
            timeout=datetime.timedelta(seconds=timeout))
    except (RuntimeError, TimeoutError) as e:
        raise TimeoutError(
            f"process {process_id} of {num_processes}: the fleet at "
            f"{coordinator} did not form within {timeout} s "
            f"({str(e).splitlines()[0] if str(e) else type(e).__name__})"
        ) from e


def initialize_from_env(initialization_timeout: int | None = None) -> bool:
    """Join the fleet iff the ``REPRO_*`` env names one; returns whether
    it does.  A plain single-process run sees no env and pays nothing."""
    if not os.environ.get(ENV_COORDINATOR):
        return False
    initialize(initialization_timeout=initialization_timeout)
    return True


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def check_processes(processes: int) -> int:
    """``processes`` if it is this fleet's size, else raise."""
    procs = int(processes)
    if procs != process_count():
        raise ValueError(
            f"processes={procs} but this process belongs to a fleet of "
            f"{process_count()}: launch one worker per process with the "
            f"{ENV_COORDINATOR}/{ENV_NUM_PROCESSES}/{ENV_PROCESS_ID} env "
            "(see tests/harness.py) and call initialize_from_env() first")
    return procs


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every process's ``x`` (equal shapes), concatenated in rank order
    on the host."""
    local = x.detach().cpu().contiguous()
    if process_count() == 1:
        return local
    parts = [torch.empty_like(local) for _ in range(process_count())]
    dist.all_gather(parts, local)
    return torch.cat(parts)
