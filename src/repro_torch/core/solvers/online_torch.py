"""Batched online dispatch in PyTorch.

The counterpart of ``repro.core.solvers.online_jax``: the paper's §4
question (can an online heuristic approach the offline bound?) as an
epoch-driven dispatcher that advances every row of a batch together.
Where the reference ``vmap``s, the port writes the axes out: a schedule
carries the instance's leading axes and then its own — ``[B, T]`` for the
greedy baseline of ``B`` instances, ``[B, P, T]`` for ``P`` gate policies
— and a ``scan`` over epochs becomes a Python loop over them.

Exact-match construction (held to the reference and to the numpy oracle
:mod:`repro_torch.core.solvers.online`):

* the downstream critical path is a reverse loop over the topological
  task order;
* the ``theta``-quantile gate threshold of every epoch comes from
  :func:`repro_torch.kernels.ops.gate_threshold` (the ``gate_quantile``
  kernel on the card, its plain version on the CPU) with the same linear
  interpolation ``np.quantile`` uses, truncated window included;
* within an epoch, ``M`` rounds of "place the lowest-indexed eligible
  task" reproduce the oracle's index-order fixpoint: placing a task only
  removes options inside the epoch.

Every ``argmax``/``argmin`` keeps the first index on ties, as in the
reference.  ``stretch`` should be binary-exact (1.25, 1.5, 2.0, ...) so
that ``int(stretch * makespan)`` truncates alike in float32 and float64.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.decoder import take_at, take_row
from repro_torch.core.instance import PackedInstance, aligned, bcast_lead
from repro_torch.core.objectives import makespan
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.kernels import ops
from repro_torch.obs import traced_call

BIG = 1 << 20

# Tie-break slack on the quantile gate: intensity must exceed the threshold
# by more than this to count as dirty (the reference's value).
GATE_EPS = 1e-9

MACHINE_RULES = ("earliest_finish", "min_energy")

# Epochs between two checks of the early exit.  Each check reads one bool
# back to the host; the epochs after every row has finished are no-ops, so
# checking less often changes nothing but the number of host syncs.
EXIT_CHECK_EVERY = 16


class OnlineSchedule(NamedTuple):
    start: torch.Tensor      # int32 [*lead, T]
    assign: torch.Tensor     # int32 [*lead, T]
    scheduled: torch.Tensor  # bool  [*lead, T] — dispatched within the horizon


class DispatchState(NamedTuple):
    """Progress of the epoch-driven dispatcher, one row per lead index.

    The carry of :func:`simulate_online`'s epoch loop.  The task-side
    fields and the machine axis split apart as (:class:`LaneState`,
    ``mfree``) for callers whose machines are shared between lanes.
    """

    scheduled: torch.Tensor  # bool  [*lead, T] — placed on a machine
    comp: torch.Tensor       # int32 [*lead, T] — completion epoch
    mfree: torch.Tensor      # int32 [*lead, M] — next epoch each machine is free
    start: torch.Tensor      # int32 [*lead, T]
    assign: torch.Tensor     # int32 [*lead, T]

    def schedule(self) -> OnlineSchedule:
        return OnlineSchedule(self.start, self.assign, self.scheduled)

    def split(self) -> tuple["LaneState", torch.Tensor]:
        """(task-side state, machine free-times) — the shared-fleet view."""
        return LaneState(self.scheduled, self.comp, self.start,
                         self.assign), self.mfree


class LaneState(NamedTuple):
    """Task-side half of :class:`DispatchState` — no machine axis."""

    scheduled: torch.Tensor  # bool  [*lead, T]
    comp: torch.Tensor       # int32 [*lead, T]
    start: torch.Tensor      # int32 [*lead, T]
    assign: torch.Tensor     # int32 [*lead, T]

    def merge(self, mfree: torch.Tensor) -> DispatchState:
        return DispatchState(self.scheduled, self.comp, mfree,
                             self.start, self.assign)


def init_lane_state(T: int, lead: Sequence[int] = (),
                    device: str | torch.device = DEFAULT_DEVICE
                    ) -> LaneState:
    """All-zeros task-side state (nothing scheduled), ``[*lead, T]``."""
    dev = resolve_device(device)
    shape = tuple(lead) + (T,)
    return LaneState(torch.zeros(shape, dtype=torch.bool, device=dev),
                     *(torch.zeros(shape, dtype=torch.int32, device=dev)
                       for _ in range(3)))


def init_dispatch_state(T: int, M: int, lead: Sequence[int] = (),
                        device: str | torch.device = DEFAULT_DEVICE
                        ) -> DispatchState:
    """The all-zeros state every simulation starts from: nothing
    scheduled, every machine free."""
    return init_lane_state(T, lead, device).merge(
        torch.zeros(tuple(lead) + (M,), dtype=torch.int32,
                    device=resolve_device(device)))


class SweepResult(NamedTuple):
    """Output of :func:`sweep_policies` (leading axes: B instances, P policies)."""

    greedy: OnlineSchedule          # [B, T] carbon-agnostic baseline
    gated: OnlineSchedule           # [B, P, T] one per policy
    greedy_makespan: torch.Tensor   # int32 [B]
    budget: torch.Tensor            # int32 [B, P] = int(stretch * greedy_makespan)


def downstream_critical_path(inst: PackedInstance) -> torch.Tensor:
    """Min-duration downstream critical path per task, incl. itself.

    int32 ``[*instance_lead, T]``.  Tasks are topologically indexed, so
    one reverse pass suffices.
    """
    T = inst.T
    dmin = torch.where(inst.allowed, inst.dur, BIG).amin(-1)
    succ = inst.pred.transpose(-1, -2) & inst.task_mask[..., None, :]
    cp = torch.zeros(inst.lead + (T,), dtype=torch.int32, device=inst.device)
    for t in range(T - 1, -1, -1):
        best = torch.where(succ[..., t, :], cp, 0).amax(-1)
        cp[..., t] = torch.where(inst.task_mask[..., t], dmin[..., t] + best,
                                 0)
    return cp


def sorted_windows(intensity: torch.Tensor, window, max_window: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-epoch forecast windows, sorted — the plain path of the gate.

    ``intensity`` ``[*lead, E]``; ``window`` broadcasts to ``lead``.
    Invalid slots (past ``window`` or past the forecast end) become
    ``+inf`` and sort to the back; the valid count ``n`` ``[*lead, E]``
    tells the quantile how far to interpolate.  Returns the sorted
    ``[*lead, E, max_window]`` windows and ``n``.
    """
    dev = intensity.device
    E = intensity.shape[-1]
    off = torch.arange(max_window, device=dev)
    idx = torch.arange(E, device=dev)[:, None] + off[None, :]     # [E, W]
    win = torch.as_tensor(window, device=dev)[..., None, None]
    valid = (off < win) & (idx < E)                                # [*, E, W]
    vals = torch.where(valid, intensity[..., idx.clamp_max(E - 1)],
                       float("inf"))
    n = valid.sum(-1, dtype=torch.int32).expand(intensity.shape)
    return torch.sort(vals, dim=-1).values, n


def quantile_threshold(sv: torch.Tensor, n: torch.Tensor,
                       theta) -> torch.Tensor:
    """Interpolated ``theta``-quantile of each sorted window -> ``[*lead, E]``.

    Replicates ``np.quantile``'s linear interpolation; ``theta`` is a
    scalar or broadcasts to ``n``.
    """
    theta = torch.as_tensor(theta, dtype=torch.float32, device=sv.device)
    vi = theta * (n - 1).to(torch.float32)
    lo = torch.floor(vi)
    gamma = vi - lo
    lo_i = lo.to(torch.int64)
    hi_i = torch.minimum(lo_i + 1, (n - 1).to(torch.int64))
    a = torch.gather(sv, -1, lo_i.unsqueeze(-1)).squeeze(-1)
    b = torch.gather(sv, -1, hi_i.unsqueeze(-1)).squeeze(-1)
    diff = b - a
    # np.quantile's _lerp switches formula at gamma >= 0.5 for accuracy.
    return torch.where(gamma >= 0.5, b - diff * (1.0 - gamma),
                       a + diff * gamma)


def dirty_mask(intensity: torch.Tensor, theta, window,
               max_window: int) -> torch.Tensor:
    """``dirty[t] = intensity[t] > quantile(intensity[t:t+window], theta)``.

    ``intensity`` ``[*lead, E]`` float32; ``theta`` broadcasts to it and
    ``window`` (capped by ``max_window``) to ``lead``.  The threshold is
    :func:`repro_torch.kernels.ops.gate_threshold`: the ``gate_quantile``
    kernel for a CUDA tensor, its plain version for a CPU tensor, with no
    switch between them.  The ``GATE_EPS`` comparison stays here.
    """
    return forecast_dirty_mask(intensity, intensity, theta, window,
                               max_window)


def forecast_dirty_mask(observed: torch.Tensor, forecast: torch.Tensor,
                        theta, window, max_window: int) -> torch.Tensor:
    """``observed[t] > quantile(forecast[t:t+window], theta)``.

    The gate of the forecast-driven dispatchers
    (:mod:`repro_torch.forecast.rolling`): the *observed* intensity is
    compared against the threshold of the *forecast* window.
    ``forecast`` ``[*lead, E]`` goes through one
    :func:`repro_torch.kernels.ops.gate_threshold` call; ``observed``
    broadcasts to it; ``theta`` and ``window`` as in :func:`dirty_mask`,
    which is this mask with the forecast as its own observation.
    """
    thr = ops.gate_threshold(forecast, theta, window, max_window)
    return observed > thr + GATE_EPS


def _check_rule(machine_rule: str) -> None:
    if machine_rule not in MACHINE_RULES:
        raise ValueError(f"unknown machine_rule {machine_rule!r}")


def dispatch_epoch_shared(inst: PackedInstance, lane: LaneState,
                          mfree: torch.Tensor, dirty_t: torch.Tensor,
                          budget: torch.Tensor, t: int,
                          machine_rule: str = "earliest_finish",
                          cp: torch.Tensor | None = None,
                          preds: torch.Tensor | None = None
                          ) -> tuple[LaneState, torch.Tensor]:
    """One epoch of the online dispatcher with an external machine axis.

    ``lane`` fields are ``[*lead, T]`` and ``mfree`` ``[*lead, M]``; the
    instance's leading axes are a prefix of ``lead``; ``dirty_t`` (the
    gate at epoch ``t``) and ``budget`` broadcast to ``lead``.  Every task
    that has arrived, whose predecessors have completed, that passes the
    gate (not dirty, or waiting would break ``budget``) and finds a free
    allowed machine is placed.  ``cp`` (:func:`downstream_critical_path`)
    and ``preds`` (the masked predecessor matrix) are recomputed from
    ``inst`` when not given.  Returns new tensors; the inputs are not
    changed.

    At most ``M`` tasks can be placed per epoch, and placements only
    shrink later tasks' options, so ``M`` rounds of "place the
    lowest-indexed eligible task" reproduce the oracle's index-order pass.
    """
    _check_rule(machine_rule)
    lead = tuple(lane.scheduled.shape[:-1])
    dev = lane.scheduled.device
    a = aligned(inst, lead)
    if cp is None:
        cp = downstream_critical_path(inst)
    if preds is None:
        preds = inst.pred & inst.task_mask[..., None, :]
    cp = bcast_lead(cp, lead, 1)
    preds = bcast_lead(preds, lead, 2)
    budget = bcast_lead(torch.as_tensor(budget, device=dev), lead)
    dirty_t = bcast_lead(torch.as_tensor(dirty_t, device=dev), lead)

    # Epoch-invariant parts of eligibility: a predecessor placed *this*
    # epoch completes at t + dur > t, so it blocks successors exactly like
    # an unscheduled one.
    done = lane.scheduled & (lane.comp <= t)
    blocked = (preds & ~done[..., None, :]).any(-1)
    waiting = dirty_t[..., None] & (t + 1 + cp <= budget[..., None])
    base = a.task_mask & (a.arrival <= t) & ~blocked & ~waiting

    tix = torch.arange(inst.T, device=dev)
    mix = torch.arange(inst.M, device=dev)
    scheduled, comp, start, assign = lane
    for _ in range(inst.M):
        free = a.allowed & (mfree <= t)[..., None, :]              # [*, T, M]
        elig = base & ~scheduled & free.any(-1)
        tk = elig.to(torch.uint8).argmax(-1)     # lowest eligible index
        place = take_at(elig, tk)
        durs = take_row(a.dur, tk)                                 # [*, M]
        free_tk = take_row(free, tk)
        cost = a.power * durs.to(torch.float32)
        if machine_rule == "earliest_finish":
            dmin = torch.where(free_tk, durs, BIG).amin(-1, keepdim=True)
            cand = free_tk & (durs == dmin)
            m = torch.where(cand, cost, float("inf")).argmin(-1)
        else:  # min_energy
            cmin = torch.where(free_tk, cost, float("inf")).amin(
                -1, keepdim=True)
            cand = free_tk & (cost == cmin)
            m = torch.where(cand, durs, BIG).argmin(-1)
        c = (t + take_at(durs, m)).unsqueeze(-1)
        at_t = (tix == tk.unsqueeze(-1)) & place.unsqueeze(-1)     # [*, T]
        at_m = (mix == m.unsqueeze(-1)) & place.unsqueeze(-1)      # [*, M]
        scheduled = scheduled | at_t
        comp = torch.where(at_t, c, comp)
        start = torch.where(at_t, t, start)
        assign = torch.where(at_t, m.to(torch.int32).unsqueeze(-1), assign)
        mfree = torch.where(at_m, c, mfree)
    return LaneState(scheduled, comp, start, assign), mfree


def dispatch_epoch(inst: PackedInstance, state: DispatchState,
                   dirty_t: torch.Tensor, budget: torch.Tensor, t: int,
                   machine_rule: str = "earliest_finish",
                   cp: torch.Tensor | None = None,
                   preds: torch.Tensor | None = None) -> DispatchState:
    """One epoch of the online dispatcher — the pool-step entry point.

    :func:`dispatch_epoch_shared` with the machines owned by the state
    (``state.mfree`` is this row's fleet).  Applying it for
    ``t = 0 .. n_epochs - 2`` from :func:`init_dispatch_state` is
    :func:`simulate_online`.
    """
    lane, mfree = state.split()
    lane, mfree = dispatch_epoch_shared(inst, lane, mfree, dirty_t, budget,
                                        t, machine_rule=machine_rule, cp=cp,
                                        preds=preds)
    return lane.merge(mfree)


def simulate_online(inst: PackedInstance, dirty: torch.Tensor,
                    budget: torch.Tensor | int, n_epochs: int,
                    machine_rule: str = "earliest_finish",
                    state0: DispatchState | None = None,
                    t0: int = 0) -> OnlineSchedule:
    """Run the event-driven dispatcher for epochs ``0 .. n_epochs - 2``.

    ``dirty`` ``[*lead, >= n_epochs - 1]`` bool gates ready tasks (all
    False == greedy), and its leading axes are the schedule's; the
    instance's are a prefix of them.  ``budget`` (broadcast to ``lead``)
    is the stretch cap on ``t + 1 + critical_path`` while waiting.  A task
    is dispatched at the first epoch where it has arrived, its
    predecessors have completed, the gate is open (or waiting would break
    the budget) and an allowed machine is free — on the free machine
    minimizing ``(duration, power * duration, index)`` under
    ``"earliest_finish"`` or ``(power * duration, duration, index)`` under
    ``"min_energy"``.

    ``state0`` (default: :func:`init_dispatch_state`, an idle fleet) seeds
    the simulation: a state with non-zero ``mfree`` dispatches onto a warm
    fleet.  Its fields broadcast to ``lead``.

    The loop ends once every real task of every row is scheduled (later
    epochs are no-ops), checked every :data:`EXIT_CHECK_EVERY` epochs.
    It starts at epoch ``t0``: where no real task arrives before ``t0``
    (and ``state0`` holds no placement) the epochs before it place
    nothing, so skipping them changes no result.
    """
    _check_rule(machine_rule)
    lead = tuple(dirty.shape[:-1])
    dev = dirty.device
    a = aligned(inst, lead)
    cp = bcast_lead(downstream_critical_path(inst), lead, 1)
    preds = bcast_lead(inst.pred & inst.task_mask[..., None, :], lead, 2)
    budget = bcast_lead(torch.as_tensor(budget, dtype=torch.int32,
                                        device=dev), lead)
    if state0 is None:
        state0 = init_dispatch_state(inst.T, inst.M, lead, dev)
    else:
        state0 = DispatchState(*(bcast_lead(x, lead, 1) for x in state0))
    lane, mfree = state0.split()
    padded = ~a.task_mask
    for t in range(t0, n_epochs - 1):
        if (t - t0) % EXIT_CHECK_EVERY == 0 \
                and bool((lane.scheduled | padded).all()):
            break
        lane, mfree = dispatch_epoch_shared(
            a, lane, mfree, dirty[..., t], budget, t,
            machine_rule=machine_rule, cp=cp, preds=preds)
    return lane.merge(mfree).schedule()


def stretch_budget(stretch, ms0: torch.Tensor) -> torch.Tensor:
    """``int(stretch * makespan)`` in float32, truncated as the
    reference's ``astype(int32)`` truncates; ``stretch`` broadcasts
    against ``ms0``."""
    return (torch.as_tensor(stretch, dtype=torch.float32, device=ms0.device)
            * ms0.to(torch.float32)).to(torch.int32)


def _on(inst: PackedInstance, dev: torch.device) -> PackedInstance:
    return PackedInstance(*(f.to(dev) for f in inst))


def online_greedy_torch(inst: PackedInstance, n_epochs: int,
                        machine_rule: str = "earliest_finish",
                        device: str | torch.device = DEFAULT_DEVICE
                        ) -> OnlineSchedule:
    """Carbon-agnostic baseline (gate always open) over a static horizon,
    for one instance or a batch ``[B, ...]``, on ``device``."""
    dev = resolve_device(device)
    inst = _on(inst, dev)
    return simulate_online(
        inst, torch.zeros(inst.lead + (n_epochs,), dtype=torch.bool,
                          device=dev), 0, n_epochs, machine_rule=machine_rule)


def online_carbon_gated_torch(inst: PackedInstance, intensity,
                              theta: float = 0.5, window: int = 96,
                              stretch: float = 1.5,
                              machine_rule: str = "earliest_finish",
                              state0: DispatchState | None = None,
                              device: str | torch.device = DEFAULT_DEVICE
                              ) -> OnlineSchedule:
    """Gated dispatch (mirrors ``online_carbon_gated``) on ``device``.

    ``intensity`` is ``[*instance_lead, E]``.  Runs the greedy baseline
    first to set ``budget = int(stretch * makespan)`` (same
    ``machine_rule``), then the gated simulation over the forecast.
    ``state0`` dispatches both runs onto a warm fleet (see
    :func:`simulate_online`).
    """
    dev = resolve_device(device)
    inst = _on(inst, dev)
    intensity = torch.as_tensor(intensity, dtype=torch.float32).to(dev)
    if state0 is not None:
        state0 = DispatchState(*(x.to(dev) for x in state0))
    n_epochs = int(intensity.shape[-1])
    g = simulate_online(
        inst, torch.zeros(inst.lead + (n_epochs,), dtype=torch.bool,
                          device=dev), 0, n_epochs,
        machine_rule=machine_rule, state0=state0)
    ms0 = makespan(inst, g.start, g.assign)
    budget = stretch_budget(stretch, ms0)
    dirty = dirty_mask(intensity, theta, window, max_window=int(window))
    return simulate_online(inst, dirty, budget, n_epochs,
                           machine_rule=machine_rule, state0=state0)


def policy_grid(thetas: Sequence[float], windows: Sequence[int],
                stretches: Sequence[float]
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Outer product of gate knobs, flattened theta-major to three aligned
    ``[P]`` numpy arrays (float32, int32, float32): host-side labels of a
    sweep's policy rows."""
    th, wi, sx = np.meshgrid(np.asarray(thetas, np.float32),
                             np.asarray(windows, np.int32),
                             np.asarray(stretches, np.float32),
                             indexing="ij")
    return th.ravel(), wi.ravel(), sx.ravel()


def gate_rows(intensity: torch.Tensor, thetas: torch.Tensor,
              windows: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A sweep's gate rows: intensity and theta ``[B, Th, W, E]`` and
    window ``[B, Th, W]``, as expanded views of ``intensity [B, E]``,
    ``thetas [Th]`` and ``windows [W]``."""
    B, E = intensity.shape
    rows = (B, thetas.shape[0], windows.shape[0])
    return (intensity[:, None, None, :].expand(rows + (E,)),
            thetas[:, None, None].expand(rows + (E,)),
            windows.expand(rows))


def _sweep(batch: PackedInstance, intensity: torch.Tensor,
           thetas: torch.Tensor, windows: torch.Tensor,
           stretches: torch.Tensor, n_epochs: int, max_window: int,
           machine_rule: str = "earliest_finish") -> SweepResult:
    B = batch.lead
    Th, W, S = thetas.shape[0], windows.shape[0], stretches.shape[0]
    dev = intensity.device
    g = simulate_online(batch, torch.zeros(B + (n_epochs,), dtype=torch.bool,
                                           device=dev), 0, n_epochs,
                        machine_rule=machine_rule)
    ms0 = makespan(batch, g.start, g.assign)                       # [B]

    # Every (instance, theta, window) gate row in one gate_quantile launch;
    # stretches share the row's mask.  Policies are theta-major.
    inten, theta_r, window_r = gate_rows(intensity, thetas, windows)
    dirty = dirty_mask(inten, theta_r, window_r, max_window)       # [B,Th,W,E]
    dirty = dirty[..., None, :].expand(B + (Th, W, S, n_epochs)) \
        .reshape(B + (Th * W * S, n_epochs))
    budget = stretch_budget(stretches, ms0[..., None])
    budget = budget[..., None, None, :].expand(B + (Th, W, S)) \
        .reshape(B + (Th * W * S,))
    gated = simulate_online(batch, dirty, budget, n_epochs,
                            machine_rule=machine_rule)
    return SweepResult(g, gated, ms0, budget)


def sweep_policies(batch: PackedInstance, intensity, thetas, windows,
                   stretches, machine_rule: str = "earliest_finish",
                   device: str | torch.device = DEFAULT_DEVICE
                   ) -> SweepResult:
    """Batched instances x policy grid, on ``device``.

    ``batch``: stacked instances ``[B, ...]``; ``intensity``: per-instance
    forecast ``[B, E]``; ``thetas``/``windows``/``stretches``: the three
    *axes* of the gate-policy grid.  Gated results carry a flattened
    policy axis of size ``P = len(thetas) * len(windows) * len(stretches)``
    in the theta-major order :func:`policy_grid` enumerates.  The greedy
    baseline runs once per instance and every gated run reuses its
    makespan for the budget; all ``B x |thetas| x |windows|`` gate rows go
    through one ``gate_quantile`` launch.
    """
    dev = resolve_device(device)
    windows = np.asarray(windows, np.int32)
    if windows.size == 0 or windows.min() < 1:
        raise ValueError(f"windows must be >= 1, got {windows.tolist()}")
    intensity = torch.as_tensor(intensity, dtype=torch.float32).to(dev)
    # traced_call: with tracing off this IS a direct _sweep call; with it
    # on, the host records the call's wall-clock span, synchronised with
    # the card (repro_torch.obs).
    return traced_call(
        "online_torch.sweep", _sweep, _on(batch, dev), intensity,
        torch.as_tensor(np.asarray(thetas, np.float32), device=dev),
        torch.as_tensor(windows, device=dev),
        torch.as_tensor(np.asarray(stretches, np.float32), device=dev),
        n_epochs=int(intensity.shape[-1]), max_window=int(windows.max()),
        machine_rule=machine_rule)
