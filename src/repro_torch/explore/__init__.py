from repro_torch.explore.replication import median, replicated_batch  # noqa
