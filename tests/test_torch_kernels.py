"""Port vs reference: the ``schedule_eval`` kernel path on the CPU.

On CPU tensors the port's wrapper runs the kernel's plain version, so here
the port is held (a) bitwise to its own ``objectives.carbon`` — the
"select in the kernel, combine in the wrapper" contract the CUDA kernel
must keep too — and (b) allclose at rtol 1e-6 to the reference's Pallas
kernel (interpret mode) and its jnp path, which sum in another order.
The kernel itself is compared on the card in ``test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import jax
import jax.numpy as jnp

from repro.core import objectives as jobj
from repro.core.instance import stack_packed
from repro.core.solvers import common as jcommon
from repro.kernels import ops as jops
from repro.kernels.schedule_eval import schedule_delta_pallas
from repro.scenarios import FAMILY_NAMES, FLEET_NAMES
from repro_torch.core import objectives as tobj
from repro_torch.core.instance import packed_from_numpy
from repro_torch.core.solvers import common as tcommon
from repro_torch.kernels import LAUNCHES, ops as tops, reset_launches
from repro_torch.kernels.ref import schedule_carbon_ref, schedule_delta_ref
from repro_torch.kernels.schedule_eval import schedule_delta
from tests.strategies import scenario_case

RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers per host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_port(p):
    return packed_from_numpy({f: np.asarray(getattr(p, f)) for f in p._fields},
                             device="cpu")


def population(rng, p, pop, horizon, overrun=False):
    """Random (starts, assigns) with only *allowed* machines — the
    reference suite's ``_population``."""
    hi = 2 * horizon if overrun else max(horizon // 2, 2)
    lo = -5 if overrun else 0
    starts = rng.integers(lo, hi, (pop, p.T)).astype(np.int32)
    allowed = np.asarray(p.allowed)
    assigns = np.zeros((pop, p.T), np.int32)
    for t in range(p.T):
        choices = np.nonzero(allowed[t])[0]
        if len(choices):
            assigns[:, t] = rng.choice(choices, size=pop)
    return starts, assigns


def exact(a, b, ctx=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, f"{ctx}: dtype {a.dtype} != {b.dtype}"
    assert np.array_equal(a, b), f"{ctx}: max |diff| {np.abs(a - b).max()}"


@pytest.mark.parametrize("family", FAMILY_NAMES)
@pytest.mark.parametrize("fleet", FLEET_NAMES)
def test_population_carbon_matches_reference(family, fleet):
    seed = 7 * FAMILY_NAMES.index(family) + FLEET_NAMES.index(fleet)
    rng = np.random.default_rng(seed)
    p, w = scenario_case(3, family=family, fleet=fleet, horizon=300)
    cum = w.cumulative()
    starts, assigns = population(rng, p, 9, 300, overrun=True)
    tp = to_port(p)
    ts, ta, tc = (torch.as_tensor(starts), torch.as_tensor(assigns),
                  torch.as_tensor(cum))
    got = tops.population_carbon(tp, ts, ta, tc)
    # Bitwise: the port's wrapper == the port's own objectives.carbon.
    exact(tobj.carbon(tp, ts, ta, tc).numpy(), got.numpy(), "port")
    # allclose: the reference's kernel (interpret) and its jnp path.
    js, ja, jc = jnp.asarray(starts), jnp.asarray(assigns), jnp.asarray(cum)
    kern = jops.population_carbon(p, js, ja, jc, interpret=True)
    plain = jax.vmap(lambda s, a: jobj.carbon(p, s, a, jc))(js, ja)
    assert_allclose(got.numpy(), np.asarray(kern), rtol=RTOL)
    assert_allclose(got.numpy(), np.asarray(plain), rtol=RTOL)


def test_schedule_delta_equals_pallas_kernel():
    """Per-task deltas are one subtraction: bitwise equal to the TPU
    kernel's output (interpret mode), instance by instance."""
    rng = np.random.default_rng(4)
    cases = [scenario_case(s, pad_tasks=40, horizon=250) for s in (1, 2, 3)]
    starts = rng.integers(-7, 300, (3, 5, 40)).astype(np.int32)
    durs = rng.integers(0, 60, (3, 5, 40)).astype(np.int32)
    cums = np.stack([w.cumulative() for _, w in cases])
    got = schedule_delta(torch.as_tensor(starts), torch.as_tensor(durs),
                         torch.as_tensor(cums))
    for b in range(3):
        want = schedule_delta_pallas(jnp.asarray(starts[b]),
                                     jnp.asarray(durs[b]),
                                     jnp.asarray(cums[b]), interpret=True)
        exact(np.asarray(want), got[b].numpy(), f"instance {b}")


def test_population_carbon_overrun_regression():
    """Candidates ending at or past H+1 integrate to the trace edge (the
    reference's ``test_population_carbon_overrun_regression``, ported)."""
    rng = np.random.default_rng(0)
    p, w = scenario_case(1, family="chain", fleet="homog", horizon=120)
    cum = w.cumulative()
    H = cum.shape[0] - 1
    starts = rng.integers(H - 2, H + 40, (8, p.T)).astype(np.int32)
    _, assigns = population(rng, p, 8, H)
    tp, tc = to_port(p), torch.as_tensor(cum)
    got = tops.population_carbon(tp, torch.as_tensor(starts),
                                 torch.as_tensor(assigns), tc)
    exact(tobj.carbon(tp, torch.as_tensor(starts), torch.as_tensor(assigns),
                      tc).numpy(), got.numpy(), "overrun")
    assert np.all(got.numpy() >= 0.0)
    ref = jops.population_carbon(p, jnp.asarray(starts), jnp.asarray(assigns),
                                 jnp.asarray(cum), interpret=True)
    assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL)
    # A task straddling the edge integrates exactly to cum[H].
    one = torch.full((1, p.T), H - 1, dtype=torch.int32)
    a1 = torch.as_tensor(assigns[:1])
    exact(tobj.carbon(tp, one, a1, tc).numpy(),
          tops.population_carbon(tp, one, a1, tc).numpy(), "edge-straddle")


def test_population_carbon_batched_bitwise():
    """[B, Pop, T] through the wrapper == objectives.carbon on the same
    tensors, bitwise; and == the plain carbon reference allclose."""
    rng = np.random.default_rng(12)
    cases = [scenario_case(s, pad_tasks=40, pad_machines=5, horizon=300)
             for s in (5, 6, 7)]
    batch = stack_packed([p for p, _ in cases])
    cums = torch.as_tensor(np.stack([w.cumulative() for _, w in cases]))
    pops = [population(rng, p, 6, 300, overrun=True) for p, _ in cases]
    starts = torch.as_tensor(np.stack([s for s, _ in pops]))
    assigns = torch.as_tensor(np.stack([a for _, a in pops]))
    tb = to_port(batch)
    got = tops.population_carbon(tb, starts, assigns, cums)
    assert got.shape == (3, 6)
    exact(tobj.carbon(tb, starts, assigns, cums).numpy(), got.numpy(),
          "batched")
    dur = tobj.task_durations(tb, assigns)
    power = torch.gather(tb.power[:, None, :].expand(3, 6, 5), -1,
                         assigns.long()) * tb.task_mask[:, None, :]
    assert_allclose(got.numpy(),
                    schedule_carbon_ref(starts, dur, power, cums).numpy(),
                    rtol=RTOL)


def test_seed_7776_fitness_case():
    """The case where the reference's own kernel and jnp paths part by
    4.9e-4 under jax 0.9 (``test_population_fitness_property``,
    seed=7776, carbon/fixed): the port sits within rtol 1e-6 of both."""
    seed = 7776
    p, w = scenario_case(seed, family=FAMILY_NAMES[seed % len(FAMILY_NAMES)],
                         fleet=FLEET_NAMES[seed % len(FLEET_NAMES)],
                         horizon=320)
    cum = w.cumulative()
    rng = np.random.default_rng(seed)
    prio = rng.normal(size=(4, p.T)).astype(np.float32)
    _, assign = population(rng, p, 4, 320)
    deadline = 100 + seed % 150
    args = (jnp.asarray(cum), jnp.int32(deadline), jnp.asarray(prio),
            jnp.asarray(assign), "carbon", "fixed", 2)
    want_jnp = jcommon.population_fitness(p, *args, use_kernels=False)
    want_kern = jcommon.population_fitness(p, *args, use_kernels=True)
    got = tcommon.population_fitness(
        to_port(p), torch.as_tensor(cum), deadline, torch.as_tensor(prio),
        torch.as_tensor(assign), "carbon", "fixed", 2)
    assert_allclose(got.numpy(), np.asarray(want_jnp), rtol=RTOL)
    assert_allclose(got.numpy(), np.asarray(want_kern), rtol=RTOL)


def test_cpu_runs_the_plain_version_and_counts_nothing():
    reset_launches()
    rng = np.random.default_rng(2)
    start = torch.as_tensor(rng.integers(-3, 90, (2, 3, 7)), dtype=torch.int32)
    dur = torch.as_tensor(rng.integers(0, 9, (2, 3, 7)), dtype=torch.int32)
    cum = torch.as_tensor(np.cumsum(rng.random((2, 81)), 1),
                          dtype=torch.float32)
    exact(schedule_delta_ref(start, dur, cum).numpy(),
          schedule_delta(start, dur, cum).numpy())
    assert all(n == 0 for n in LAUNCHES.values())


@pytest.mark.parametrize("bad", ["dtype", "rank", "batch", "cum_dtype"])
def test_schedule_delta_rejects_bad_inputs(bad):
    start = torch.zeros((2, 3, 4), dtype=torch.int32)
    dur = torch.zeros((2, 3, 4), dtype=torch.int32)
    cum = torch.zeros((2, 10), dtype=torch.float32)
    if bad == "dtype":
        start = start.long()
    elif bad == "rank":
        start, dur = start[0], dur[0]
    elif bad == "batch":
        cum = cum[:1]
    else:
        cum = cum.double()
    with pytest.raises((TypeError, ValueError)):
        schedule_delta(start, dur, cum)
