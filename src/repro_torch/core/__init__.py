from repro_torch.core.prototype import Context  # noqa
from repro_torch.core.hook import Hook, SavePopulationHook  # noqa
