from repro_torch.ants.model import (AntsState, simulate,  # noqa
                                    simulate_batch, simulate_state,
                                    food_sources, nest_mask,
                                    init_state, make_step)
