"""The port's shard layer across a process fleet (gloo, on the CPU).

Each fleet test spawns real worker processes through
:func:`tests.harness.run_distributed`, which hands every rank the
``REPRO_COORDINATOR`` / ``REPRO_NUM_PROCESSES`` / ``REPRO_PROCESS_ID``
env and asserts that the ranks print the same result.  The payloads
import only ``repro_torch`` (the card's machine has no JAX):

* a 2-process fleet's sharded dispatch, bound, learner and evaluation
  equal the single-device entries bit for bit (checked inside the
  payload), and its sharded structure sweeps equal the in-process
  single-device sweeps and the TINY golden;
* spawn order does not move a number;
* a worker that never joins fails the fleet: the harness names the rank
  left hanging, and ``initialize``'s own timeout names the process and
  the coordinator;
* ``initialize`` wants the whole env contract.
"""
import json

import pytest
import torch

from repro_torch import bench, shard
from repro_torch.scenarios import sweep_structure
from repro_torch.shard import distributed
from tests.harness import run_distributed
from tests.test_structure_golden import GOLDEN_PATH, _assert_row_matches

PRELUDE = ("from repro_torch.shard import initialize_from_env\n"
           "initialize_from_env(initialization_timeout=120)\n")

# Rank-invariant by construction (the harness compares the ranks' lines).
PARITY_PAYLOAD = PRELUDE + r"""
import json
import torch
torch.set_num_threads(1)
from repro_torch import bench, shard
from repro_torch.core.solvers import SAConfig, solve_bilevel_batch
from repro_torch.core.solvers.common import RowDraws, row_seeds
from repro_torch.core.solvers.online_torch import sweep_policies
from repro_torch.learn import LearnConfig, evaluate_theta, train_gate
from repro_torch.scenarios import build_batch, sweep_structure
from repro_torch.shard.batch import tree_map

P = shard.process_count()


def same(a, b):
    out = []
    tree_map(lambda x, y: out.append(torch.equal(x, y)), a, b)
    return all(out)


spec = bench.structure_spec(tiny=True)
sb = build_batch(spec, "cpu")
B = 5                                  # padded to 6 rows at 1 x 2 shards
b = type(sb.batch)(*(f[:B] for f in sb.batch))
inten, cum = sb.intensity[:B], sb.cum[:B]
ok = {}
for per_proc in (1, 2):
    devs = ["cpu"] * per_proc
    on = dict(devices=devs, processes=P)
    ref = sweep_policies(b, inten, (0.3, 0.6), (48,), (1.5,), device="cpu")
    got = shard.dispatch_sharded(b, inten, (0.3, 0.6), (48,), (1.5,), **on)
    ok[f"dispatch_{per_proc}"] = same(ref, got)
    seeds = row_seeds(3, B)
    kw = dict(objective="carbon", stretch=1.5,
              cfg1=SAConfig(pop=8, iters=6, sweeps=1),
              cfg2=SAConfig(pop=8, iters=6, sweeps=1))
    ref = solve_bilevel_batch(b, cum, RowDraws(seeds, "cpu"), **kw)
    ok[f"bilevel_{per_proc}"] = same(
        ref, shard.bilevel_sharded(b, cum, seeds, **on, **kw))
    group, window = [0, 1, 0, 1, 1], [48, 24, 48, 48, 96]
    args = (b, inten, cum, group, window, 1.5, [0.4, 0.6],
            LearnConfig(steps=2))
    ref = train_gate(*args, device="cpu")
    got = shard.train_sharded(*args, **on)
    ok[f"train_{per_proc}"] = same(tuple(ref[:5]), tuple(got[:5]))
    th = ref.theta[torch.as_tensor(group)]
    ref = evaluate_theta(b, inten, cum, th, window, 1.5, device="cpu")
    got = shard.eval_theta_sharded(b, inten, cum, th, window, 1.5, **on)
    ok[f"eval_{per_proc}"] = same(ref, got)

tiny, meta = sweep_structure(spec, offline=False, devices=["cpu"],
                             processes=P)
cut = type(spec)(cells=spec.cells[:2], instances_per_cell=2,
                 horizon=spec.horizon, sa=spec.sa._replace(iters=6))
offline, _ = shard.sweep_sharded(cut, offline=True, devices=["cpu"],
                                 processes=P)
print(json.dumps({"procs": P, "ok": ok, "tiny": tiny, "offline": offline,
                  "meta": [meta["devices"], meta["processes"],
                           meta["pad_tasks"], meta["pad_machines"]]}))
"""

# Rank 0 leaves at once; rank 1 waits for a fleet that never forms.
DEAD_WORKER_PAYLOAD = r"""
import os, sys
if int(os.environ["REPRO_PROCESS_ID"]) == 0:
    sys.exit(0)
from repro_torch.shard import initialize_from_env
initialize_from_env(initialization_timeout={timeout})
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers per host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fleet():
    """The parity payload on a 2-process fleet, spawned in rank order."""
    results = run_distributed(PARITY_PAYLOAD, processes=2, devices=1,
                              timeout=600)
    assert set(results) == {0, 1}
    return results[0]


def test_fleet_parity(fleet):
    assert fleet["procs"] == 2
    assert fleet["ok"] and all(fleet["ok"].values()), fleet["ok"]
    assert fleet["meta"][:2] == [1, 2]


def test_fleet_reproduces_the_single_process_sweeps(fleet):
    """The TINY grid swept by two processes: equal to the single-device
    sweep and to ``structure_tiny.json``; the cut grid with the offline
    bound equal to the single-device sweep."""
    with open(GOLDEN_PATH) as f:
        golden = json.load(f)["structure_tiny"]
    spec = bench.structure_spec(tiny=True)
    single, _ = sweep_structure(spec, offline=False, device="cpu")
    assert fleet["tiny"] == json.loads(json.dumps(single))
    assert fleet["meta"][2:] == [golden["pad_tasks"], golden["pad_machines"]]
    for got, want in zip(fleet["tiny"], golden["cells"]):
        _assert_row_matches(got, want, f"cell[{want['family']}-m"
                            f"{want['n_machines']}-{want['fleet']}]")
    cut = type(spec)(cells=spec.cells[:2], instances_per_cell=2,
                     horizon=spec.horizon, sa=spec.sa._replace(iters=6))
    single, _ = sweep_structure(cut, offline=True, device="cpu")
    assert fleet["offline"] == json.loads(json.dumps(single))


def test_spawn_order_does_not_matter(fleet):
    """Workers launched in reversed OS order: rank identity comes from the
    env, row blocks from the rank, so no number moves."""
    results = run_distributed(PARITY_PAYLOAD, processes=2, devices=1,
                              timeout=600, spawn_order=(1, 0))
    assert results[0] == fleet


def test_dead_worker_times_out_naming_the_hung_rank():
    with pytest.raises(TimeoutError, match=r"rank\(s\) \[1\] still running"):
        run_distributed(DEAD_WORKER_PAYLOAD.format(timeout=120),
                        processes=2, devices=1, timeout=8)


def test_initialize_timeout_names_the_process():
    """With its own short timeout the waiting rank fails by itself,
    naming its process id, the fleet's size and the coordinator."""
    with pytest.raises(AssertionError,
                       match=r"(?s)rank\(s\) \[1\] failed.*process 1 of 2: "
                       r"the fleet at 127\.0\.0\.1:\d+ did not form"):
        run_distributed(DEAD_WORKER_PAYLOAD.format(timeout=3), processes=2,
                        devices=1, timeout=120)


def test_initialize_wants_the_full_env_contract(monkeypatch):
    for var in (distributed.ENV_COORDINATOR, distributed.ENV_NUM_PROCESSES,
                distributed.ENV_PROCESS_ID):
        monkeypatch.delenv(var, raising=False)
    assert shard.initialize_from_env() is False
    monkeypatch.setenv(distributed.ENV_COORDINATOR, "127.0.0.1:1")
    with pytest.raises(ValueError, match="REPRO_NUM_PROCESSES"):
        shard.initialize_from_env()
    monkeypatch.setenv(distributed.ENV_NUM_PROCESSES, "2")
    with pytest.raises(ValueError, match="process_id=None"):
        shard.initialize_from_env()
    assert not shard.is_initialized()
