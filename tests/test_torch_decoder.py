"""Port vs reference: SGS, the carbon timing sweep and the upward rank.

Every integer the decoders produce must be equal: ``sgs`` start, assign
and seq_key for all three machine rules, ``timing_sweep`` starts (with and
without ``frozen``), on single instances and on padded ``[B, Pop, T]``
batches.  Inputs are made with numpy and carried into both packages.
"""
import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

import jax
import jax.numpy as jnp

from repro.core import decoder as jdec
from repro.core.instance import stack_packed
from repro.scenarios import FAMILY_NAMES, FLEET_NAMES
from repro_torch.core import decoder as tdec
from repro_torch.core.instance import packed_from_numpy
from tests.strategies import scenario_case


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


def candidates(rng, allowed, lead):
    """prio float32 and allowed assign int32 of shape ``lead + (T,)``."""
    allowed = np.asarray(allowed)
    T = allowed.shape[-2]
    prio = rng.normal(size=lead + (T,)).astype(np.float32)
    # Integer-valued priorities give ties: the first-index rule must hold.
    prio[..., :1, :] = np.round(prio[..., :1, :])
    g = rng.gumbel(size=lead + allowed.shape[-2:])
    full = np.broadcast_to(allowed.reshape(allowed.shape[:-2]
                                           + (1,) * (len(lead) + 2
                                                     - allowed.ndim)
                                           + allowed.shape[-2:]),
                           lead + allowed.shape[-2:])
    assign = np.where(full, g, -np.inf).argmax(-1).astype(np.int32)
    return prio, assign


def jax_sgs_pop(p, prio, assign, rule):
    return jax.vmap(lambda pr, a: jdec.sgs(p, pr, a, machine_rule=rule))(
        jnp.asarray(prio), jnp.asarray(assign))


@pytest.mark.parametrize("rule", jdec.MACHINE_RULES)
@pytest.mark.parametrize("family", FAMILY_NAMES)
def test_sgs_equal(rule, family):
    seed = FAMILY_NAMES.index(family)
    p, _ = scenario_case(seed, family=family,
                         fleet=FLEET_NAMES[seed % len(FLEET_NAMES)])
    rng = np.random.default_rng(seed)
    prio, assign = candidates(rng, p.allowed, (6,))
    want = jax_sgs_pop(p, prio, assign, rule)
    got = tdec.sgs(to_port(p), torch.as_tensor(prio), torch.as_tensor(assign),
                   machine_rule=rule)
    for f in want._fields:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert g.dtype == np.int32, f
        assert_array_equal(w, g, err_msg=f"{rule}/{family}: {f}")


@pytest.mark.parametrize("rule", jdec.MACHINE_RULES)
def test_sgs_padded_batch_equal(rule):
    """[B, Pop, T] candidates on a padded stack decode in one call."""
    ps = [scenario_case(s, pad_tasks=40, pad_machines=5)[0]
          for s in (3, 8, 13)]
    batch = stack_packed(ps)
    rng = np.random.default_rng(5)
    prio, assign = candidates(rng, batch.allowed, (3, 4))
    got = tdec.sgs(to_port(batch), torch.as_tensor(prio),
                   torch.as_tensor(assign), machine_rule=rule)
    for b, p in enumerate(ps):
        want = jax_sgs_pop(p, prio[b], assign[b], rule)
        for f in want._fields:
            assert_array_equal(np.asarray(getattr(want, f)),
                               getattr(got, f)[b].numpy(),
                               err_msg=f"{rule}[{b}]: {f}")


def test_sgs_unknown_rule():
    p = to_port(scenario_case(0)[0])
    with pytest.raises(ValueError):
        tdec.sgs(p, torch.zeros(p.T), machine_rule="fastest")


@pytest.mark.parametrize("family", FAMILY_NAMES)
@pytest.mark.parametrize("frozen", [False, True])
def test_timing_sweep_equal(family, frozen):
    seed = 20 + FAMILY_NAMES.index(family)
    p, w = scenario_case(seed, family=family,
                         fleet=FLEET_NAMES[seed % len(FLEET_NAMES)],
                         horizon=400)
    cum = w.cumulative()
    rng = np.random.default_rng(seed)
    prio, assign = candidates(rng, p.allowed, (5,))
    dec = jax_sgs_pop(p, prio, assign, "fixed")
    fz = (np.arange(p.T) < p.T // 3) if frozen else None
    for deadline in (np.int32(180), np.int32(1 << 27)):
        want = jax.vmap(lambda s, a: jdec.timing_sweep(
            p, s, a, jnp.asarray(cum), jnp.asarray(deadline), 2,
            frozen=None if fz is None else jnp.asarray(fz)))(dec.start,
                                                            dec.assign)
        got = tdec.timing_sweep(
            to_port(p), torch.tensor(np.asarray(dec.start)),
            torch.tensor(np.asarray(dec.assign)), torch.as_tensor(cum),
            torch.as_tensor(deadline), 2,
            frozen=None if fz is None else torch.as_tensor(fz))
        assert got.dtype == torch.int32
        assert_array_equal(np.asarray(want), got.numpy())


def test_timing_sweep_padded_batch_equal():
    cases = [scenario_case(s, pad_tasks=40, pad_machines=5, horizon=350)
             for s in (31, 32)]
    batch = stack_packed([p for p, _ in cases])
    cums = np.stack([w.cumulative() for _, w in cases])
    rng = np.random.default_rng(9)
    prio, assign = candidates(rng, batch.allowed, (2, 4))
    deadline = np.array([150, 220], np.int32)
    tb = to_port(batch)
    dec = tdec.sgs(tb, torch.as_tensor(prio), torch.as_tensor(assign),
                   machine_rule="fixed")
    got = tdec.timing_sweep(tb, dec.start, dec.assign, torch.as_tensor(cums),
                            torch.as_tensor(deadline), 2)
    for b, (p, _) in enumerate(cases):
        jd = jax_sgs_pop(p, prio[b], assign[b], "fixed")
        want = jax.vmap(lambda s, a: jdec.timing_sweep(
            p, s, a, jnp.asarray(cums[b]), jnp.asarray(deadline[b]), 2))(
                jd.start, jd.assign)
        assert_array_equal(np.asarray(want), got[b].numpy())


def test_upward_rank_equal():
    ps = [scenario_case(s, family=FAMILY_NAMES[s % 5], pad_tasks=40,
                        pad_machines=5)[0] for s in range(4)]
    batch = stack_packed(ps)
    got = tdec.upward_rank(to_port(batch)).numpy()
    for b, p in enumerate(ps):
        assert_array_equal(np.asarray(jdec.upward_rank(p)), got[b])
