"""The plain reference of the bi-level bound, in NumPy.

It judges what the program's ``solve_bilevel_batch`` returned for a job
from the job's own inputs (the harness's raw instances and carbon
intensities), and works out again everything the program derived from
them: the task arrays, the cumulative traces, the durations on the
assigned servers.  It imports nothing of the program.

What it checks, per instance (paper §2 and Appendix A):

* both schedules against Eqs. 4-8 (arrival, DAG precedence, allowed
  server, no overlap on a server), the optimized one also against the
  deadline ``floor(S * OPT)``;
* the reported OPT against the baseline's makespan, and the deadline;
* the reported carbon and energy of both schedules against Def. 2.2 and
  2.3 in float64, and the reported savings against those values;
* the timing sweep, through the fallback guard: the reference decodes
  the baseline's own order on its servers (the serial SGS) and sweeps it
  (:func:`timing_sweep`, the carbon-greedy shift of each task inside its
  slack, latest first), which is the schedule phase 2 may never end
  worse than;
* the phase-2 search, by how much it gained over that swept baseline:
  the job's summed objective over the swept baseline's
  (``carbon_search_ratio`` or ``energy_search_ratio`` by the job's
  objective; the other reads 0);
* one phase-2 fitness call of the search (``fitness_rel_gap``): the
  candidates the program scored, on a sample of the job's instances,
  decoded again by the reference's serial SGS, swept by its timing sweep,
  and scored by Def. 2.3 (or 2.2) in float64 plus the validator's
  penalty, against the fitness values the program gave them.  This is
  the only number through which the population's SGS, timing sweep and
  carbon integral (the ``schedule_eval`` kernel) reach ``correct``
  directly; the program's search state (the candidates) is taken as it
  stands, and the reference follows one step from it.

:func:`judge_job` gives every number compared, each of which is worse when
larger; a configuration's ``limits`` give the limit of each.
"""
from __future__ import annotations

import numpy as np

EPOCH_HOURS = 0.25
BIG = 1 << 28
MACHINE_WEIGHT = 10 ** 6
ENERGY_CARBON_TIEBREAK = 1e-6
VIOLATION_PENALTY = 1e5       # fitness units per unit of violation mass

NUMBERS = ("violations", "opt_mismatch", "carbon_rel_gap", "energy_rel_gap",
           "savings_gap", "sweep_gap", "carbon_search_ratio",
           "energy_search_ratio", "fitness_rel_gap")


# ---------------------------------------------------------------------------
# Inputs: the task arrays of the harness's raw instances.
# ---------------------------------------------------------------------------

def task_arrays(insts, pad_tasks: int) -> dict:
    """Stacked arrays of ``insts`` (each with ``jobs``, ``powers_kw`` and
    ``speeds``), ``pad_tasks`` tasks each: ``dur`` int64 ``[B, T, M]``
    (``ceil(base / speed)``, at least 1), ``pred`` bool ``[B, T, T]``
    (``pred[b, t, u]``: u before t), ``arrival`` ``[B, T]``, ``mask``
    ``[B, T]`` (real tasks), ``power`` float64 ``[B, M]``."""
    B = len(insts)
    M = len(insts[0].powers_kw)
    T = pad_tasks
    dur = np.zeros((B, T, M), np.int64)
    pred = np.zeros((B, T, T), bool)
    arrival = np.zeros((B, T), np.int64)
    mask = np.zeros((B, T), bool)
    power = np.zeros((B, M), np.float64)
    for b, inst in enumerate(insts):
        power[b] = inst.powers_kw
        t0 = 0
        for job in inst.jobs:
            k = len(job.base_durations)
            for i, d in enumerate(job.base_durations):
                dur[b, t0 + i] = [max(1, int(np.ceil(d / s)))
                                  for s in inst.speeds]
            for u, v in job.edges:
                pred[b, t0 + v, t0 + u] = True
            arrival[b, t0:t0 + k] = job.arrival
            mask[b, t0:t0 + k] = True
            t0 += k
        if t0 > T:
            raise ValueError(f"instance {b} has {t0} tasks, over {T}")
    return {"dur": dur, "pred": pred, "arrival": arrival, "mask": mask,
            "power": power}


def cumulative(intensity: np.ndarray, dtype=np.float64) -> np.ndarray:
    """``cum[..., e] = sum_{e' < e} I[..., e'] * EPOCH_HOURS``, summed in
    float64 and held in ``dtype``: ``[..., H+1]``."""
    cum = np.zeros(intensity.shape[:-1] + (intensity.shape[-1] + 1,))
    np.cumsum(intensity.astype(np.float64) * EPOCH_HOURS, axis=-1,
              out=cum[..., 1:])
    return cum.astype(dtype)


def _rows(x: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``x[b, idx[b, ...]]`` along the last axis."""
    return np.take_along_axis(x, idx, axis=-1)


def durations(a: dict, assign: np.ndarray) -> np.ndarray:
    """Each task's duration on its server, ``[B, T]``."""
    return np.take_along_axis(a["dur"], assign[..., None], -1)[..., 0]


# ---------------------------------------------------------------------------
# Feasibility (Eqs. 4-8 and the deadline) and the objectives.
# ---------------------------------------------------------------------------

def violations(a: dict, start: np.ndarray, assign: np.ndarray,
               deadline: np.ndarray | None = None) -> np.ndarray:
    """Violation mass of each schedule, int64 ``[B]`` (0: feasible)."""
    mask = a["mask"]
    M = a["dur"].shape[-1]
    d = durations(a, assign)
    comp = start + d
    both = mask[:, :, None] & mask[:, None, :]
    v_arr = np.where(mask, np.maximum(a["arrival"] - start, 0), 0).sum(-1)
    gap = comp[:, None, :] - start[:, :, None]           # [b, t, u]
    v_dep = np.where(a["pred"] & both, np.maximum(gap, 0), 0).sum((1, 2))
    bad_m = (assign < 0) | (assign >= M)
    v_mach = (mask & bad_m).sum(-1)
    same = assign[:, :, None] == assign[:, None, :]
    upper = np.triu(np.ones(mask.shape[-1:] * 2, bool), 1)
    ov = (np.minimum(comp[:, :, None], comp[:, None, :])
          - np.maximum(start[:, :, None], start[:, None, :]))
    v_olap = np.where(same & both & upper, np.maximum(ov, 0), 0).sum((1, 2))
    total = v_arr + v_dep + v_mach * MACHINE_WEIGHT + v_olap
    if deadline is not None:
        over = comp - np.asarray(deadline)[:, None]
        total = total + np.where(mask, np.maximum(over, 0), 0).sum(-1)
    return total


def makespan(a: dict, start: np.ndarray, assign: np.ndarray) -> np.ndarray:
    comp = start + durations(a, assign)
    return np.where(a["mask"], comp, 0).max(-1)


def energy(a: dict, assign: np.ndarray) -> np.ndarray:
    """Def. 2.2 in float64: ``sum P_m * p_{t,m} * EPOCH_HOURS`` (kWh)."""
    p = _rows(a["power"], assign)
    return np.where(a["mask"], p * durations(a, assign) * EPOCH_HOURS,
                    0.0).sum(-1)


def carbon(a: dict, start: np.ndarray, assign: np.ndarray,
           cum: np.ndarray) -> np.ndarray:
    """Def. 2.3 on ``cum`` ``[B, H+1]``: ``sum P_m (cum[s+d] - cum[s])``,
    ends clipped into ``[0, H]``, in ``cum``'s precision."""
    H = cum.shape[-1] - 1
    s0 = np.clip(start, 0, H)
    s1 = np.clip(start + durations(a, assign), 0, H)
    delta = _rows(cum, s1) - _rows(cum, s0)
    p = _rows(a["power"], assign).astype(cum.dtype)
    return np.where(a["mask"], p * delta, cum.dtype.type(0)).sum(-1)


# ---------------------------------------------------------------------------
# The swept baseline: the serial SGS on fixed servers, then the sweep.
# ---------------------------------------------------------------------------

def sgs_fixed(a: dict, prio: np.ndarray, assign: np.ndarray) -> np.ndarray:
    """Serial SGS: T times, the ready task of highest ``prio`` (the first
    on a tie) starts at the latest of its arrival, its predecessors' ends
    and its server's last end.  Returns the starts ``[B, T]``."""
    B, T = prio.shape
    ar = np.arange(B)
    pred = a["pred"] & a["mask"][:, None, :]
    remaining = pred.sum(-1)
    done = np.zeros((B, T), bool)
    comp = np.zeros((B, T), np.int64)
    mfree = np.zeros((B, a["dur"].shape[-1]), np.int64)
    start = np.zeros((B, T), np.int64)
    d = durations(a, assign)
    for _ in range(T):
        ready = ~done & (remaining == 0)
        t = np.where(ready, prio, -np.inf).argmax(-1)
        pc = np.where(pred[ar, t], comp, 0).max(-1)
        m = assign[ar, t]
        s = np.maximum(np.maximum(a["arrival"][ar, t], pc), mfree[ar, m])
        c = s + d[ar, t]
        done[ar, t] = True
        comp[ar, t] = c
        mfree[ar, m] = np.maximum(mfree[ar, m], c)
        start[ar, t] = s
        remaining -= pred[ar, :, t]
    return start


def timing_sweep(a: dict, start: np.ndarray, assign: np.ndarray,
                 cum32: np.ndarray, deadline: np.ndarray,
                 sweeps: int) -> np.ndarray:
    """The carbon timing sweep: per sweep, tasks in descending
    ``(start, index)`` order each move to the start in ``[own start,
    min(successors' starts, next start on its server, deadline) - d]``
    whose emissions ``cum[s + d] - cum[s]`` (float32) are least, the
    earliest on a tie."""
    B, T = start.shape
    H = cum32.shape[-1] - 1
    ar = np.arange(B)
    mask = a["mask"]
    d = durations(a, assign)
    succ = np.swapaxes(a["pred"], 1, 2) & mask[:, None, :]
    same = (assign[:, :, None] == assign[:, None, :]) & mask[:, None, :]
    svec = np.arange(H + 1)
    tix = np.arange(T)
    dl = np.asarray(deadline, np.int64)
    start = start.copy()
    for _ in range(sweeps):
        key = start * T + tix
        order = np.argsort(-np.where(mask, key, -BIG), axis=-1,
                           kind="stable")
        for j in range(T):
            t = order[:, j]
            dt = d[ar, t]
            succ_cap = np.where(succ[ar, t], start, BIG).min(-1)
            after = same[ar, t] & (key > key[ar, t][:, None])
            mnext = np.where(after, start, BIG).min(-1)
            hi = np.minimum(np.minimum(succ_cap, mnext), dl) - dt
            lo = start[ar, t]
            idx = np.minimum(svec[None, :] + dt[:, None], H)
            cost = _rows(cum32, idx) - cum32
            window = (svec >= lo[:, None]) & (svec <= hi[:, None])
            best = np.where(window, cost, np.float32(np.inf)).argmin(-1)
            move = mask[ar, t] & (hi >= lo)
            start[ar, t] = np.where(move, best, lo)
    return start


# ---------------------------------------------------------------------------
# The comparison.
# ---------------------------------------------------------------------------

def _objective(objective: str, energy64, carbon64):
    if objective == "carbon":
        return carbon64
    return energy64 + ENERGY_CARBON_TIEBREAK * carbon64


def _fitness(objective: str, energy64, carbon64, viol):
    return (_objective(objective, energy64, carbon64)
            + VIOLATION_PENALTY * viol)


def fitness_rows(job: dict, a: dict, fit: dict | None, cum32: np.ndarray,
                 deadline: np.ndarray, sweeps: int) -> dict | None:
    """The tapped fitness call's candidates on the job's sampled
    instances (``job["fit_rows"]``), each instance's population one row
    apiece, decoded and swept by the reference: the rows' task arrays
    ``a``, ``start``, ``assign``, ``deadline``, the sampled instances
    ``rows``, and the program's ``value`` of each row.  None where the
    call is missing or is not one the reference can score (another
    objective or machine rule, frozen tasks, shapes not the job's)."""
    B, T = a["mask"].shape
    M = a["dur"].shape[-1]
    if (fit is None or fit["objective"] != job["objective"]
            or fit["machine_rule"] != "fixed" or fit["frozen"] is not None):
        return None
    prio, assign, value = fit["prio"], fit["assign"], fit["value"]
    if (prio.ndim != 3 or prio.shape[0] != B or prio.shape[-1] != T
            or assign.shape != prio.shape
            or np.shape(value) != prio.shape[:-1]):
        return None
    rows = np.asarray(job["fit_rows"])
    P = prio.shape[1]
    sub = {k: np.repeat(v[rows], P, axis=0) for k, v in a.items()}
    p = prio[rows].reshape(-1, T)
    s = assign[rows].reshape(-1, T).astype(np.int64)
    if ((s < 0) | (s >= M)).any():
        return None
    dl = np.repeat(deadline[rows], P)
    start = timing_sweep(sub, sgs_fixed(sub, p, s), s,
                         np.repeat(cum32[rows], P, axis=0), dl, sweeps)
    return {"a": sub, "start": start, "assign": s, "deadline": dl,
            "rows": rows, "P": P,
            "value": np.asarray(value)[rows].reshape(-1)}


def fitness_gap(job: dict, f: dict | None, cum64: np.ndarray) -> float:
    """The widest relative gap of the program's fitness values to the
    reference's on :func:`fitness_rows`' rows (inf where there are
    none)."""
    if f is None:
        return float("inf")
    a, start, assign = f["a"], f["start"], f["assign"]
    c64 = np.repeat(cum64[f["rows"]], f["P"], axis=0)
    want = _fitness(job["objective"], energy(a, assign),
                    carbon(a, start, assign, c64),
                    violations(a, start, assign, f["deadline"]))
    got = np.asarray(f["value"], np.float64)
    return float((np.abs(got - want) / np.maximum(np.abs(want), 1e-9))
                 .max())


def _deadline(job: dict, a: dict, out: dict) -> np.ndarray:
    """``floor(S * OPT)``, OPT the makespan of the reported baseline."""
    M = a["dur"].shape[-1]
    bs = out["base_start"].astype(np.int64)
    ba = np.clip(out["base_assign"].astype(np.int64), 0, M - 1)
    opt = makespan(a, bs, ba)
    return np.floor(job["stretch"] * opt + 1e-6).astype(np.int64)


def judge_job(job: dict, out: dict, sweeps: int) -> dict:
    """The numbers of one job.

    ``job``: the inputs the harness made (``insts``, ``pad_tasks``,
    ``intensity`` float32 ``[B, H]``, ``stretch``, ``objective``).
    ``out``: what the program returned, as NumPy: ``opt_makespan``,
    ``deadline``, ``base_start``, ``base_assign``, ``base_carbon``,
    ``base_energy``, ``opt_start``, ``opt_assign``, ``opt_carbon``,
    ``opt_energy``, ``carbon_savings``, ``energy_savings``.
    """
    a = task_arrays(job["insts"], job["pad_tasks"])
    cum64 = cumulative(job["intensity"], np.float64)
    cum32 = cumulative(job["intensity"], np.float32)
    bs, ba = out["base_start"].astype(np.int64), \
        out["base_assign"].astype(np.int64)
    os_, oa = out["opt_start"].astype(np.int64), \
        out["opt_assign"].astype(np.int64)
    M = a["dur"].shape[-1]
    if ((ba < 0) | (ba >= M) | (oa < 0) | (oa >= M)).any():
        # A server index out of range is a machine violation; clip it
        # for the lookups below, which it would otherwise break.
        bad = (((ba < 0) | (ba >= M)) & a["mask"]).sum() \
            + (((oa < 0) | (oa >= M)) & a["mask"]).sum()
        ba, oa = np.clip(ba, 0, M - 1), np.clip(oa, 0, M - 1)
    else:
        bad = 0

    opt = makespan(a, bs, ba)
    deadline = _deadline(job, a, out)
    viol = (violations(a, bs, ba).sum() + violations(a, os_, oa, deadline)
            .sum() + bad * MACHINE_WEIGHT)
    mismatch = ((out["opt_makespan"] != opt)
                | (out["deadline"] != deadline)).sum()

    c_b, c_o = carbon(a, bs, ba, cum64), carbon(a, os_, oa, cum64)
    e_b, e_o = energy(a, ba), energy(a, oa)

    def rel(port, ref):
        return np.abs(np.asarray(port, np.float64) - ref) \
            / np.maximum(np.abs(ref), 1e-9)

    c_gap = max(rel(out["base_carbon"], c_b).max(),
                rel(out["opt_carbon"], c_o).max())
    e_gap = max(rel(out["base_energy"], e_b).max(),
                rel(out["opt_energy"], e_o).max())
    s_gap = max(np.abs(out["carbon_savings"] - (1 - c_o / c_b)).max(),
                np.abs(out["energy_savings"] - (1 - e_o / e_b)).max())

    fb = timing_sweep(a, sgs_fixed(a, -bs.astype(np.float64), ba), ba,
                      cum32, deadline, sweeps)
    f_fb = _objective(job["objective"], energy(a, ba),
                      carbon(a, fb, ba, cum64))
    f_opt = _objective(job["objective"], e_o, c_o)
    ratio = float(f_opt.sum() / f_fb.sum())
    fit = fitness_rows(job, a, out.get("fit"), cum32, deadline, sweeps)
    return {
        "violations": float(viol),
        "opt_mismatch": float(mismatch),
        "carbon_rel_gap": float(c_gap),
        "energy_rel_gap": float(e_gap),
        "savings_gap": float(s_gap),
        "sweep_gap": float(max(((f_opt - f_fb) / f_fb).max(), 0.0)),
        "carbon_search_ratio": ratio if job["objective"] == "carbon"
        else 0.0,
        "energy_search_ratio": ratio if job["objective"] == "energy"
        else 0.0,
        "fitness_rel_gap": fitness_gap(job, fit, cum64),
    }


def aggregate(per_job: list[dict]) -> dict:
    """The numbers of a run from its jobs': the sum of the counts, the
    widest of the gaps and ratios."""
    summed = ("violations", "opt_mismatch")
    return {k: (sum(p[k] for p in per_job) if k in summed
                else max(p[k] for p in per_job)) for k in NUMBERS}


# ---------------------------------------------------------------------------
# The control: the reference in the program's place, in bfloat16.
# ---------------------------------------------------------------------------

def bf16(x: np.ndarray) -> np.ndarray:
    """Round float32 values to bfloat16 (to nearest, ties to even), held
    as float32."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def carbon_bf16(a: dict, start, assign, intensity) -> np.ndarray:
    """Def. 2.3 with every step in bfloat16: the trace, its running sum,
    each task's delta, its power product and the sum over tasks."""
    I = bf16(intensity.astype(np.float32) * np.float32(EPOCH_HOURS))
    B, H = I.shape
    cum = np.zeros((B, H + 1), np.float32)
    for e in range(H):
        cum[:, e + 1] = bf16(cum[:, e] + I[:, e])
    s0 = np.clip(start, 0, H)
    s1 = np.clip(start + durations(a, assign), 0, H)
    delta = bf16(_rows(cum, s1) - _rows(cum, s0))
    g = bf16(bf16(_rows(a["power"], assign).astype(np.float32)) * delta)
    total = np.zeros(B, np.float32)
    for t in range(g.shape[-1]):
        total = bf16(total + np.where(a["mask"][:, t], g[:, t], 0))
    return total


def energy_bf16(a: dict, assign) -> np.ndarray:
    p = bf16(_rows(a["power"], assign).astype(np.float32))
    g = bf16(p * bf16(durations(a, assign).astype(np.float32)
                      * np.float32(EPOCH_HOURS)))
    total = np.zeros(g.shape[0], np.float32)
    for t in range(g.shape[-1]):
        total = bf16(total + np.where(a["mask"][:, t], g[:, t], 0))
    return total


def _sum_bf16(parts) -> np.ndarray:
    total = bf16(parts[0])
    for x in parts[1:]:
        total = bf16(total + bf16(x))
    return total


def control_out(job: dict, out: dict, sweeps: int) -> dict:
    """``out`` with every value the program computed from the trace and
    the powers (carbon, energy, savings, and the tapped call's fitness
    values on the sampled instances) worked out by the reference in
    bfloat16 instead, on the program's schedules (the fitness: on the
    reference's decode of the program's candidates)."""
    a = task_arrays(job["insts"], job["pad_tasks"])
    I = job["intensity"]
    bs, ba = out["base_start"].astype(np.int64), \
        out["base_assign"].astype(np.int64)
    os_, oa = out["opt_start"].astype(np.int64), \
        out["opt_assign"].astype(np.int64)
    c_b, c_o = carbon_bf16(a, bs, ba, I), carbon_bf16(a, os_, oa, I)
    e_b, e_o = energy_bf16(a, ba), energy_bf16(a, oa)
    ctl = {**out, "base_carbon": c_b, "opt_carbon": c_o,
           "base_energy": e_b, "opt_energy": e_o,
           "carbon_savings": bf16(1 - bf16(c_o / c_b)),
           "energy_savings": bf16(1 - bf16(e_o / e_b))}
    f = fitness_rows(job, a, out.get("fit"),
                     cumulative(I, np.float32), _deadline(job, a, out),
                     sweeps)
    if f is not None:
        fa, fs, fm = f["a"], f["start"], f["assign"]
        c = carbon_bf16(fa, fs, fm, np.repeat(I[f["rows"]], f["P"], axis=0))
        parts = [c] if job["objective"] == "carbon" else [
            energy_bf16(fa, fm), ENERGY_CARBON_TIEBREAK * c]
        pen = VIOLATION_PENALTY * violations(fa, fs, fm, f["deadline"])
        value = np.array(out["fit"]["value"], np.float32)
        value[f["rows"]] = _sum_bf16(parts + [pen.astype(np.float32)]) \
            .reshape(len(f["rows"]), f["P"])
        ctl["fit"] = {**out["fit"], "value": value}
    return ctl
