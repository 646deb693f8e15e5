from repro_torch.models.model import Model, build  # noqa: F401
