from repro_torch.core.solvers.common import (Draws, ScheduleResult,
                                             TorchDraws, decode_full,
                                             population_fitness)
from repro_torch.core.solvers.annealing import SAConfig, solve_sa
from repro_torch.core.solvers.genetic import GAConfig, solve_ga
from repro_torch.core.solvers.bilevel import (BilevelResult, solve_bilevel,
                                              solve_bilevel_batch)
from repro_torch.core.solvers.online import (online_carbon_gated,
                                             online_greedy)
from repro_torch.core.solvers.online_torch import (
    DispatchState, LaneState, OnlineSchedule, SweepResult, dirty_mask,
    dispatch_epoch, dispatch_epoch_shared, downstream_critical_path,
    init_dispatch_state, init_lane_state, online_carbon_gated_torch,
    online_greedy_torch, policy_grid, simulate_online, sweep_policies)
from repro_torch.core.solvers.rolling import (MPCConfig, MPCResult, solve_mpc,
                                              solve_mpc_batch)

__all__ = [
    "Draws", "ScheduleResult", "TorchDraws", "decode_full",
    "population_fitness", "SAConfig", "solve_sa", "GAConfig", "solve_ga",
    "BilevelResult", "solve_bilevel", "solve_bilevel_batch",
    "online_carbon_gated", "online_greedy", "DispatchState", "LaneState",
    "OnlineSchedule", "SweepResult", "dirty_mask", "dispatch_epoch",
    "dispatch_epoch_shared", "downstream_critical_path",
    "init_dispatch_state", "init_lane_state", "online_carbon_gated_torch",
    "online_greedy_torch", "policy_grid", "simulate_online",
    "sweep_policies", "MPCConfig", "MPCResult", "solve_mpc",
    "solve_mpc_batch",
]
