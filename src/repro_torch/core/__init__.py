from repro_torch.core.prototype import Context  # noqa
from repro_torch.core.hook import Hook, SavePopulationHook  # noqa
from repro_torch.core.prototype import Val  # noqa
from repro_torch.core.task import PyTask, Task, TaskError  # noqa
from repro_torch.core.faults import FaultSpec  # noqa
from repro_torch.core.environment import Environment, LocalEnvironment  # noqa
from repro_torch.core.envpool import EnvironmentPool  # noqa
