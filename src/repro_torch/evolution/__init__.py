from repro_torch.evolution.nsga2 import NSGA2Config  # noqa
from repro_torch.evolution import ga  # noqa
from repro_torch.evolution.ga import (GAState, StreamingResult,  # noqa
                                      evaluate_population_streaming,
                                      init_state, init_state_from_population,
                                      make_step, run_generational,
                                      select_top_streaming)
from repro_torch.evolution.island import (IslandState,  # noqa
                                          host_snapshot,
                                          place_island_state,
                                          init_island_state, make_epoch,
                                          make_evolve, make_merge,
                                          make_reseed, run_islands,
                                          state_from_arrays)
from repro_torch.evolution.archive import (Archive, init_archive,  # noqa
                                           merge, pareto_front)
