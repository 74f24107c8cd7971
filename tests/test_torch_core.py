"""Port vs reference: instances, carbon traces, validator and objectives.

The same numpy seeds build the same instances and traces in both
packages; schedules made with numpy go through the JAX functions and their
``repro_torch`` counterparts (on the CPU).  Integers must be equal, float
objectives allclose at rtol 1e-6 (the two frameworks sum in different
orders).
"""
import dataclasses

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import jax
import jax.numpy as jnp

from repro.core import carbon as jcarbon
from repro.core import instance as jinstance
from repro.core import objectives as jobj
from repro.core import validate as jval
from repro.scenarios import FAMILY_NAMES, FLEET_NAMES
from repro_torch.core import carbon as tcarbon
from repro_torch.core import instance as tinstance
from repro_torch.core import objectives as tobj
from repro_torch.core import validate as tval
from tests.strategies import scenario_case

RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers per host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_port(p) -> tinstance.PackedInstance:
    return tinstance.packed_from_numpy(
        {f: np.asarray(getattr(p, f)) for f in p._fields}, device="cpu")


def t2n(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def schedules(rng, p, pop, broken: bool):
    """(start, assign) [pop, T]: decoded-feasible-ish or deliberately broken
    (starts before arrival, overlaps, disallowed machines)."""
    allowed = np.asarray(p.allowed)
    assign = np.zeros((pop, p.T), np.int32)
    for t in range(p.T):
        choices = np.nonzero(allowed[t])[0] if not broken else \
            np.arange(allowed.shape[1])
        assign[:, t] = rng.choice(choices, size=pop)
    hi = 60 if broken else 300
    start = rng.integers(0, hi, (pop, p.T)).astype(np.int32)
    return start, assign


@pytest.mark.parametrize("hetero", [False, True])
@pytest.mark.parametrize("n_machines,pad", [(5, None), (3, 30), (10, 44)])
def test_pack_and_generators_equal(hetero, n_machines, pad):
    for seed in range(3):
        ji = jinstance.generate_instance(np.random.default_rng(seed),
                                         n_jobs=6, k_tasks=4,
                                         n_machines=n_machines,
                                         heterogeneous=hetero)
        ti = tinstance.generate_instance(np.random.default_rng(seed),
                                         n_jobs=6, k_tasks=4,
                                         n_machines=n_machines,
                                         heterogeneous=hetero)
        assert dataclasses.asdict(ji) == dataclasses.asdict(ti)
        jp = jinstance.pack(ji, pad_tasks=pad,
                            pad_machines=n_machines + 2 if pad else None)
        tp = tinstance.pack(ti, pad_tasks=pad,
                            pad_machines=n_machines + 2 if pad else None,
                            device="cpu")
        for f in jp._fields:
            a, b = np.asarray(getattr(jp, f)), t2n(getattr(tp, f))
            assert a.dtype == b.dtype, f
            assert_array_equal(a, b, err_msg=f)


def test_stack_and_carry_across():
    ps = [scenario_case(s, pad_tasks=40, pad_machines=4)[0] for s in range(3)]
    jb = jinstance.stack_packed(ps)
    tb = tinstance.stack_packed([to_port(p) for p in ps])
    carried = to_port(jb)
    for f in jb._fields:
        assert_array_equal(np.asarray(getattr(jb, f)), t2n(getattr(tb, f)))
        assert_array_equal(t2n(getattr(carried, f)), t2n(getattr(tb, f)))
    assert tb.lead == (3,) and tb.T == 40 and tb.M == 4
    with pytest.raises(ValueError):
        tinstance.stack_packed([to_port(ps[0]),
                                to_port(scenario_case(0)[0])])


@pytest.mark.parametrize("region", sorted(jcarbon.REGIONS))
def test_traces_and_cum_equal(region):
    jy = jcarbon.synthesize(region, days=20, seed=7)
    ty = tcarbon.synthesize(region, days=20, seed=7)
    assert_array_equal(jy.intensity, ty.intensity)
    for s in range(3):
        jw = jcarbon.sample_window(jy, np.random.default_rng(s), 500)
        tw = tcarbon.sample_window(ty, np.random.default_rng(s), 500)
        jc, tc = jw.cumulative(), tw.cumulative()
        assert tc.dtype == np.float32
        assert_array_equal(jc, tc)


@pytest.mark.parametrize("family", FAMILY_NAMES)
@pytest.mark.parametrize("broken", [False, True])
def test_validator_masses_equal(family, broken):
    rng = np.random.default_rng(FAMILY_NAMES.index(family) + 10 * broken)
    p, _ = scenario_case(5, family=family,
                         fleet=FLEET_NAMES[len(family) % 3])
    start, assign = schedules(rng, p, 7, broken)
    tp = to_port(p)
    for deadline in (None, 150):
        jr = jax.vmap(lambda s, a: jval.violation_report(p, s, a, deadline))(
            jnp.asarray(start), jnp.asarray(assign))
        tr = tval.violation_report(tp, torch.as_tensor(start),
                                   torch.as_tensor(assign), deadline)
        for f in jr._fields:
            got = t2n(getattr(tr, f))
            assert got.dtype == np.int32, f
            assert_array_equal(np.asarray(getattr(jr, f)), got, err_msg=f)
        jt = jax.vmap(lambda s, a: jval.total_violations(p, s, a, deadline))(
            jnp.asarray(start), jnp.asarray(assign))
        tt = tval.total_violations(tp, torch.as_tensor(start),
                                   torch.as_tensor(assign), deadline)
        assert_array_equal(np.asarray(jt), t2n(tt))
    if broken:
        assert t2n(tt).min() > 0
    # The numpy reports are the same strings.
    for i in range(3):
        assert (jval.check_feasible_np(p, start[i], assign[i], 150)
                == tval.check_feasible_np(tp, start[i], assign[i], 150))


def test_validator_batch_with_sweep_axes():
    rng = np.random.default_rng(3)
    ps = [scenario_case(s, pad_tasks=40, pad_machines=5)[0] for s in range(3)]
    jb = jinstance.stack_packed(ps)
    start = rng.integers(0, 80, (3, 2, 4, 40)).astype(np.int32)
    assign = rng.integers(0, 5, (3, 2, 4, 40)).astype(np.int32)
    deadline = rng.integers(40, 120, (3, 2, 4)).astype(np.int32)
    for dl in (None, deadline):
        want = jval.total_violations_batch(jb, start, assign, dl)
        got = tval.total_violations_batch(
            to_port(jb), torch.as_tensor(start), torch.as_tensor(assign),
            None if dl is None else torch.as_tensor(dl))
        assert_array_equal(np.asarray(want), t2n(got))


@pytest.mark.parametrize("fleet", FLEET_NAMES)
def test_objectives_match(fleet):
    rng = np.random.default_rng(FLEET_NAMES.index(fleet))
    p, w = scenario_case(11, family="layered", fleet=fleet, horizon=400)
    cum = w.cumulative()
    start, assign = schedules(rng, p, 9, broken=False)
    start[:2] += 350                      # some overrun the trace
    tp = to_port(p)
    js, ja = jnp.asarray(start), jnp.asarray(assign)
    ts, ta = torch.as_tensor(start), torch.as_tensor(assign)
    jc = jnp.asarray(cum)
    want = jax.vmap(lambda s, a: jobj.evaluate(p, s, a, jc))(js, ja)
    got = tobj.evaluate(tp, ts, ta, torch.as_tensor(cum))
    assert_array_equal(np.asarray(want.makespan), t2n(got.makespan))
    assert_allclose(t2n(got.energy), np.asarray(want.energy), rtol=RTOL)
    assert_allclose(t2n(got.carbon), np.asarray(want.carbon), rtol=RTOL)
    assert_allclose(
        t2n(tobj.utilization(tp, ts, ta)),
        np.asarray(jax.vmap(lambda s, a: jobj.utilization(p, s, a))(js, ja)),
        rtol=RTOL)
    assert_array_equal(
        np.asarray(jax.vmap(lambda a: jobj.task_durations(p, a))(ja)),
        t2n(tobj.task_durations(tp, ta)))


def test_pack_asks_for_the_card_by_default():
    """No device given means the card; on a host without one that raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    inst = tinstance.generate_instance(np.random.default_rng(0), n_jobs=2)
    with pytest.raises(RuntimeError, match="cuda"):
        tinstance.pack(inst)
