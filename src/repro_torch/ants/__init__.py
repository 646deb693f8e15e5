from repro_torch.ants.model import (AntsState, simulate,  # noqa
                                    simulate_batch, food_sources, nest_mask,
                                    init_state, make_step)
