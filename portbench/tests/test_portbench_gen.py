"""The harness's copy of the generators draws what the program's paper
batch draws: the same instances and carbon windows for one seed."""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from portbench.drivers.bound import _program_instance
from portbench.harness import gen
from portbench.tests.portbench_tiny import REPO


@pytest.mark.parametrize("config,hetero", [("paper-homog", False),
                                           ("paper-hetero", True)])
def test_paper_draw_is_the_paper_batch(config, hetero):
    from repro_torch.bench import BenchSetup, paper_batch
    from repro_torch.core.instance import pack, stack_packed
    with open(os.path.join(REPO, "portbench", "configs",
                           f"{config}.json")) as f:
        cfg = json.load(f)
    seed, n = 2**31 + 77, 6
    want, want_cum = paper_batch(BenchSetup(instances=n, seed=seed,
                                            heterogeneous=hetero), "cpu")
    year = gen.year_trace(cfg["trace"])
    insts, starts = gen.paper_draw(np.random.default_rng(seed), n,
                                   cfg["instance"], year,
                                   cfg["trace"]["horizon"])
    got = stack_packed([pack(_program_instance(i), pad_tasks=40,
                             device="cpu") for i in insts])
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    _, cum = gen.windows(year, starts, cfg["trace"]["horizon"])
    np.testing.assert_array_equal(cum, want_cum.numpy())


def test_year_is_the_programs():
    from repro_torch.core.carbon import synthesize
    np.testing.assert_array_equal(
        gen.synthesize("AU-SA", 366, 2024).intensity,
        synthesize("AU-SA", 366, 2024).intensity)
