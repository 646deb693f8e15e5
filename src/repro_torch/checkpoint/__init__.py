from repro_torch.checkpoint.checkpointer import (latest_step,  # noqa
                                                 prune, restore, save)
