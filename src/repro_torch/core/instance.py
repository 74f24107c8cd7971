"""FJSP instance model: jobs with DAG task dependencies on heterogeneous machines.

The counterpart of ``repro.core.instance``.  The numpy level (:class:`Job`,
:class:`Instance`, the generators) is copied verbatim, so that the same
numpy seed gives the same instances in both packages.  The packed level,
:class:`PackedInstance`, holds torch tensors on one device.

Batch convention of the port: where the reference ``vmap``s, the port
writes the axes out.  An instance may carry leading axes (``[B, T, M]``
for a batch of instances); a candidate tensor carries the instance's
leading axes followed by its own (``[B, Pop, T]``).  :func:`aligned`
expands an instance's fields to a candidate's leading shape as views.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device

# A task that cannot run on machine m gets this processing time; the decoder
# masks such machines out, this is belt-and-braces.
INF_DUR = np.int32(2**20)

EPOCH_HOURS = 0.25  # 15-minute epochs, as in the paper.

# The paper's heterogeneous setup (Section 3.1): five server classes.
HETERO_POWERS_KW = (0.25, 0.5, 1.0, 1.5, 2.0)
HETERO_SPEEDS = (1.0 / 3.0, 1.0 / 2.0, 1.0, 4.0 / 3.0, 2.0)


@dataclasses.dataclass(frozen=True)
class Job:
    """One job: ``k`` tasks with a DAG over them and an arrival epoch."""

    arrival: int
    # durations on the *baseline* (speed-1) machine, one per task, in epochs.
    base_durations: tuple[int, ...]
    # DAG edges (u, v): task u must complete before task v starts. Local
    # indices 0..k-1, topologically consistent (u < v).
    edges: tuple[tuple[int, int], ...]

    @property
    def n_tasks(self) -> int:
        return len(self.base_durations)


@dataclasses.dataclass(frozen=True)
class Instance:
    """A full FJSP instance (numpy level)."""

    jobs: tuple[Job, ...]
    powers_kw: tuple[float, ...]   # per machine
    speeds: tuple[float, ...]      # per machine, relative to baseline
    # allowed[j][i] -> tuple of machine ids; None means "all machines".
    allowed: tuple | None = None

    @property
    def n_jobs(self) -> int:
        return len(self.jobs)

    @property
    def n_machines(self) -> int:
        return len(self.powers_kw)

    @property
    def n_tasks(self) -> int:
        return sum(j.n_tasks for j in self.jobs)

    def durations_matrix(self) -> np.ndarray:
        """[T, M] int32 processing times (ceil of base/speed), INF if disallowed."""
        T, M = self.n_tasks, self.n_machines
        dur = np.full((T, M), INF_DUR, dtype=np.int32)
        t = 0
        for ji, job in enumerate(self.jobs):
            for i, d in enumerate(job.base_durations):
                for m in range(M):
                    if self.allowed is not None and m not in self.allowed[ji][i]:
                        continue
                    dur[t, m] = max(1, int(np.ceil(d / self.speeds[m])))
                t += 1
        return dur


class PackedInstance(NamedTuple):
    """Fixed-shape, padded tensors for the decoders and solvers.

    The padding contract is the reference's: padded tasks have
    ``task_mask == False``, zero duration on machine 0 and no
    dependencies; padded machines are never ``allowed``, carry ``INF_DUR``
    for real tasks and zero power.  Every field may carry leading batch
    axes (``stack_packed``).
    """

    dur: torch.Tensor        # int32 [..., T, M]
    allowed: torch.Tensor    # bool  [..., T, M]
    pred: torch.Tensor       # bool  [..., T, T] ; pred[t, u] -> u before t
    arrival: torch.Tensor    # int32 [..., T]
    job: torch.Tensor        # int32 [..., T]
    task_mask: torch.Tensor  # bool  [..., T]
    power: torch.Tensor      # float32 [..., M]

    @property
    def T(self) -> int:  # noqa: N802 - matches the math.
        return self.dur.shape[-2]

    @property
    def M(self) -> int:  # noqa: N802
        return self.dur.shape[-1]

    @property
    def lead(self) -> tuple[int, ...]:
        """The instance's leading (batch) shape."""
        return tuple(self.dur.shape[:-2])

    @property
    def device(self) -> torch.device:
        return self.dur.device


# Trailing (per-instance) rank of each PackedInstance field.
_FIELD_RANK = {"dur": 2, "allowed": 2, "pred": 2, "arrival": 1, "job": 1,
               "task_mask": 1, "power": 1}
_FIELD_DTYPE = {"dur": torch.int32, "allowed": torch.bool,
                "pred": torch.bool, "arrival": torch.int32,
                "job": torch.int32, "task_mask": torch.bool,
                "power": torch.float32}


def bcast_lead(x: torch.Tensor, lead: Sequence[int],
               trailing: int = 0) -> torch.Tensor:
    """Expand ``x`` of shape ``p + trail`` to ``lead + trail`` as a view.

    ``p`` (all but the last ``trailing`` axes) must be a prefix of
    ``lead``: a per-instance tensor lines up with the instance axes of a
    ``[B, Pop, ...]`` candidate tensor, the way ``vmap`` lines them up in
    the reference.
    """
    lead = tuple(lead)
    nd = x.ndim - trailing
    if nd > len(lead):
        raise ValueError(f"shape {tuple(x.shape)} has more leading axes "
                         f"than {lead}")
    trail = tuple(x.shape[nd:])
    x = x.reshape(tuple(x.shape[:nd]) + (1,) * (len(lead) - nd) + trail)
    return x.expand(lead + trail)


def aligned(inst: PackedInstance, lead: Sequence[int]) -> PackedInstance:
    """Every field of ``inst`` expanded (as views) to ``lead``."""
    return PackedInstance(*(bcast_lead(getattr(inst, f), lead, r)
                            for f, r in _FIELD_RANK.items()))


def pack(inst: Instance, pad_tasks: int | None = None,
         pad_machines: int | None = None,
         device: str | torch.device = DEFAULT_DEVICE) -> PackedInstance:
    """Pack an :class:`Instance` to fixed-shape tensors on ``device``.

    Same arrays as ``repro.core.instance.pack`` for the same instance and
    padding; see the padding contract on :class:`PackedInstance`.
    """
    T_real, M_real = inst.n_tasks, inst.n_machines
    T = pad_tasks or T_real
    M = pad_machines or M_real
    if T < T_real:
        raise ValueError(f"pad_tasks={T} < real task count {T_real}")
    if M < M_real:
        raise ValueError(f"pad_machines={M} < real machine count {M_real}")

    dur = np.zeros((T, M), dtype=np.int32)
    allowed = np.zeros((T, M), dtype=bool)
    pred = np.zeros((T, T), dtype=bool)
    arrival = np.zeros((T,), dtype=np.int32)
    job_id = np.zeros((T,), dtype=np.int32)
    task_mask = np.zeros((T,), dtype=bool)
    power = np.zeros((M,), dtype=np.float32)
    power[:M_real] = np.asarray(inst.powers_kw, dtype=np.float32)

    dmat = inst.durations_matrix()
    dur[:T_real, :M_real] = dmat
    allowed[:T_real, :M_real] = dmat < INF_DUR
    dur[:T_real, M_real:] = INF_DUR
    t0 = 0
    for ji, job in enumerate(inst.jobs):
        k = job.n_tasks
        for (u, v) in job.edges:
            if not (0 <= u < v < k):
                raise ValueError(f"edge ({u},{v}) not topological in job {ji}")
            pred[t0 + v, t0 + u] = True
        arrival[t0:t0 + k] = job.arrival
        job_id[t0:t0 + k] = ji
        task_mask[t0:t0 + k] = True
        t0 += k
    # Padding tasks: dur 0 on machine 0 only, no deps, arrive at 0.
    if T > T_real:
        allowed[T_real:, 0] = True
    return packed_from_numpy(
        {"dur": dur, "allowed": allowed, "pred": pred, "arrival": arrival,
         "job": job_id, "task_mask": task_mask, "power": power}, device)


def packed_from_numpy(fields: dict[str, np.ndarray],
                      device: str | torch.device = DEFAULT_DEVICE
                      ) -> PackedInstance:
    """Build a :class:`PackedInstance` from numpy arrays, one per field.

    The carry-across function: ``{f: np.asarray(getattr(p, f))}`` of a
    reference ``PackedInstance`` (batched or not) gives the port the very
    same instance.
    """
    dev = resolve_device(device)
    missing = set(_FIELD_RANK) - set(fields)
    if missing:
        raise ValueError(
            f"packed_from_numpy: missing fields {sorted(missing)}")
    return PackedInstance(**{
        f: torch.tensor(np.asarray(fields[f]), dtype=_FIELD_DTYPE[f],
                        device=dev)
        for f in _FIELD_RANK})


def stack_packed(insts: Sequence[PackedInstance]) -> PackedInstance:
    """Stack same-shape packed instances along a leading batch axis."""
    if not insts:
        raise ValueError("stack_packed: empty instance sequence")
    shapes = {(p.T, p.M) for p in insts}
    if len(shapes) > 1:
        raise ValueError(
            "stack_packed: mixed (T, M) shapes "
            f"{sorted(shapes)} — pack with common pad_tasks/pad_machines")
    return PackedInstance(*(torch.stack([getattr(p, f) for p in insts])
                            for f in PackedInstance._fields))


# ---------------------------------------------------------------------------
# Generators (Section 3.1 of the paper), copied from the reference.
# ---------------------------------------------------------------------------

def chain_edges(k: int) -> tuple[tuple[int, int], ...]:
    """t0 -> t1 -> ... -> t_{k-1}."""
    return tuple((i, i + 1) for i in range(k - 1))


def branch_edges(k: int) -> tuple[tuple[int, int], ...]:
    """Root feeding two (near-)balanced chains (the middle shape of Fig. 3)."""
    if k <= 2:
        return chain_edges(k)
    edges = [(0, 1), (0, 2)]
    # Continue the two branches alternately: 1->3, 2->4, 3->5, ...
    for v in range(3, k):
        edges.append((v - 2, v))
    return tuple(edges)


def fanout_edges(k: int) -> tuple[tuple[int, int], ...]:
    """One root feeding all other tasks (the right shape of Fig. 3)."""
    return tuple((0, v) for v in range(1, k))


DAG_SHAPES = ("chain", "branch", "fanout")
_EDGE_FNS = {"chain": chain_edges, "branch": branch_edges, "fanout": fanout_edges}


def sample_job(rng: np.random.Generator, k: int, mean_dur: float = 7.0,
               arrival_horizon: int = 96, shape: str | None = None) -> Job:
    """Sample one job per the paper: exp(mean 7 epochs) durations (ceil, >=1),
    uniform arrival in the next 24h (96 epochs), DAG from Fig. 3 shapes."""
    if shape is None:
        shape = DAG_SHAPES[rng.integers(len(DAG_SHAPES))]
    durs = np.maximum(1, np.ceil(rng.exponential(mean_dur, size=k))).astype(int)
    arrival = int(rng.integers(0, arrival_horizon))
    return Job(arrival=arrival, base_durations=tuple(int(d) for d in durs),
               edges=_EDGE_FNS[shape](k))


def generate_instance(
    rng: np.random.Generator,
    n_jobs: int = 10,
    k_tasks: int = 4,
    n_machines: int = 5,
    heterogeneous: bool = False,
    mean_dur: float = 7.0,
    arrival_horizon: int = 96,
    shape: str | None = None,
) -> Instance:
    """Sample a paper-style instance (Section 3.1 defaults: n=10, k=4, M=5)."""
    jobs = tuple(sample_job(rng, k_tasks, mean_dur, arrival_horizon, shape)
                 for _ in range(n_jobs))
    if heterogeneous:
        if n_machines == 5:
            powers, speeds = HETERO_POWERS_KW, HETERO_SPEEDS
        else:  # cycle the 5 classes
            powers = tuple(HETERO_POWERS_KW[i % 5] for i in range(n_machines))
            speeds = tuple(HETERO_SPEEDS[i % 5] for i in range(n_machines))
    else:
        powers = (1.0,) * n_machines
        speeds = (1.0,) * n_machines
    return Instance(jobs=jobs, powers_kw=powers, speeds=speeds)
