from repro_torch.train.optimizer import (OptimizerConfig,  # noqa
                                         adamw_update, init_opt_state,
                                         opt_state_axes)
from repro_torch.train.train_step import (TrainState,  # noqa
                                          abstract_train_state,
                                          init_train_state, make_train_step,
                                          train_state_axes)
