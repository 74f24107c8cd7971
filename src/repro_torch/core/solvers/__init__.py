from repro_torch.core.solvers.common import (Draws, ScheduleResult,
                                             TorchDraws, decode_full,
                                             population_fitness)
from repro_torch.core.solvers.annealing import SAConfig, solve_sa
from repro_torch.core.solvers.genetic import GAConfig, solve_ga
from repro_torch.core.solvers.bilevel import (BilevelResult, solve_bilevel,
                                              solve_bilevel_batch)

__all__ = [
    "Draws", "ScheduleResult", "TorchDraws", "decode_full",
    "population_fitness", "SAConfig", "solve_sa", "GAConfig", "solve_ga",
    "BilevelResult", "solve_bilevel", "solve_bilevel_batch",
]
