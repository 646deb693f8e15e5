from repro_torch.checkpoint.checkpointer import (latest_step,  # noqa
                                                 prune, require_settings,
                                                 restore, save,
                                                 saved_leaves)
