"""The serve engine over a placed mesh of gloo ranks on the CPU, against
one process's engine.

Two fleets of reduced hymba, each one payload run once per module
(``tests.harness.run_distributed``; every rank's last stdout line must be
the same JSON, so every rank reports the same tokens and the same
``summary()`` counts):

* **2 x 1** (``data=2``, 2 ranks): the pool's 4 lanes cut over the data
  ranks, 2 each; greedy and temperature sampling, and a pool of 3 lanes
  refused;
* **2 x 2** (``data=2, model=2``, 4 ranks): the same, the model split
  over ``model`` too; and a variant with one kv head (which does not
  split over ``model``) under ``kv_seq_shard``, each rank holding half of
  every lane's KV ring.

The payloads import only ``repro_torch``; this process serves the same
requests through one process's engine on the same weights.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.models.api import build_model
from repro_torch.serve import Request, ServeConfig, ServeEngine
from tests.harness import run_distributed
from tests.test_torch_mesh_fleet import PRELUDE

LENGTHS = (12, 40, 25, 33, 18, 38)     # prompts of mixed lengths
MAX_NEW = 6
SC = dict(batch_slots=4, max_len=48)   # the ring: 48 slots, 24 a rank
TEMPERATURE = 0.8
VARIANTS = {"hymba": {}, "hymba_kv1": {"n_kv_heads": 1}}

PAYLOAD = PRELUDE + r"""
import dataclasses
import json
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch import configs
from repro_torch.launch.mesh import MeshShape, ProcessMesh
from repro_torch.launch.sharding import make_parallel
from repro_torch.models.api import build_model
from repro_torch.models import parallel
from repro_torch.serve import Request, ServeConfig, ServeEngine

LENGTHS, MAX_NEW, SC = @LENGTHS@, @MAX_NEW@, @SC@
mesh = ProcessMesh.build(MeshShape.parse("@MESH@"), "cpu")
out = {}
for name, kw, lever in @RUNS@:
    cfg = dataclasses.replace(configs.get("hymba-1.5b").reduced(), **kw)
    par = make_parallel(cfg, mesh, kv_seq_shard=lever)
    model = build_model(cfg, "cpu", seed=0, par=par)
    rng = np.random.default_rng(26)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in LENGTHS]
    for temp in (0.0, @TEMPERATURE@):
        eng = ServeEngine(model, ServeConfig(temperature=temp, **SC),
                          device="cpu")
        parallel.reset_traffic()
        done = eng.run([Request(i, p, max_new=MAX_NEW)
                        for i, p in enumerate(prompts)])
        summary = eng.summary()
        summary.pop("wall")           # each rank's own clock
        out[f"{name}.{temp}"] = {
            "tokens": {r.rid: r.out_tokens for r in done},
            "done": sorted(r.rid for r in done if r.done),
            "summary": summary,
            "kv_shape": list(eng.caches["k_cache"].shape),
            "data_traffic": {op: v[:2] for op, v in
                             parallel.TRAFFIC.get("data", {}).items()}}
try:
    ServeEngine(model, ServeConfig(batch_slots=3, max_len=48), device="cpu")
    out["odd_pool"] = "accepted"
except ValueError as e:
    out["odd_pool"] = str(e)
torch.distributed.barrier()            # the ranks leave together
torch.distributed.destroy_process_group()
print(json.dumps(out))
"""

FLEETS = {"2x1": ("data=2,model=1", 2, [("hymba", {}, False)]),
          "2x2": ("data=2,model=2", 4, [("hymba", {}, False),
                                        ("hymba_kv1", {"n_kv_heads": 1},
                                         True)])}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers per host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def one_process():
    """One process's engine on the same weights and requests."""
    out = {}
    for name, kw in VARIANTS.items():
        cfg = dataclasses.replace(configs.get("hymba-1.5b").reduced(), **kw)
        model = build_model(cfg, "cpu", seed=0)
        rng = np.random.default_rng(26)
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                   for n in LENGTHS]
        eng = ServeEngine(model, ServeConfig(**SC), device="cpu")
        done = eng.run([Request(i, p, max_new=MAX_NEW)
                        for i, p in enumerate(prompts)])
        summary = eng.summary()
        summary.pop("wall")
        out[name] = ({str(r.rid): r.out_tokens for r in done}, summary)
    return out


@pytest.fixture(scope="module", params=list(FLEETS))
def fleet(request):
    spec, n, runs = FLEETS[request.param]
    payload = (PAYLOAD.replace("@MESH@", spec).replace("@RUNS@", repr(runs))
               .replace("@LENGTHS@", repr(LENGTHS))
               .replace("@MAX_NEW@", repr(MAX_NEW)).replace("@SC@", repr(SC))
               .replace("@TEMPERATURE@", repr(TEMPERATURE)))
    res = run_distributed(payload, processes=n, devices=1, timeout=600)
    return request.param, runs, res[0]


def test_mesh_engine_serves_one_process_tokens(fleet, one_process):
    """Every request done, with one process's greedy tokens (the prefill's
    and 6 decode ticks'), on every rank (the harness holds the ranks'
    JSON equal), and the same ``summary()`` counts; each rank holds 2 of
    the 4 lanes, and under ``kv_seq_shard`` 24 of each lane's 48 ring
    slots for the one kv head; the logits cross the data ranks once a
    tick."""
    name, runs, r = fleet
    for variant, kw, lever in runs:
        got = r[f"{variant}.0.0"]
        tokens, summary = one_process[variant]
        assert got["done"] == list(range(len(LENGTHS)))
        assert got["tokens"] == tokens
        assert got["summary"] == summary
        assert got["kv_shape"][1] == SC["batch_slots"] // 2
        assert got["kv_shape"][2] == (SC["max_len"] // 2 if lever
                                      else SC["max_len"])
        calls, nbytes = got["data_traffic"]["all_gather"]
        assert calls == summary["ticks"]


def test_mesh_engine_samples_alike_on_every_rank(fleet):
    """Temperature sampling: every rank draws the same tokens for the
    whole pool (one seeded generator each, on the gathered logits), so
    the lanes stay the same everywhere; every request is served to
    ``max_new``."""
    _, runs, r = fleet
    for variant, _, _ in runs:
        got = r[f"{variant}.{TEMPERATURE}"]
        assert got["done"] == list(range(len(LENGTHS)))
        assert all(len(t) == 1 + MAX_NEW for t in got["tokens"].values())
        assert got["tokens"] != r[f"{variant}.0.0"]["tokens"]


def test_mesh_engine_refuses_a_pool_data_does_not_split(fleet):
    assert "batch_slots=3" in fleet[2]["odd_pool"]
    assert "2 data ranks" in fleet[2]["odd_pool"]
