"""The paper's primary contribution: a workflow engine for distributed model
exploration — tasks, dataflow, hooks, environments, and the DSL. Ported from
``repro.core``."""
from repro_torch.core.prototype import Val, Context  # noqa
from repro_torch.core.task import Task, PyTask, TorchTask, TaskError  # noqa
from repro_torch.core.workflow import Capsule, Workflow, Transition  # noqa
from repro_torch.core.hook import (Hook, ToStringHook, DisplayHook,  # noqa
                                   CSVHook, SavePopulationHook,
                                   CheckpointHook)
from repro_torch.core.source import (Source, ConstantSource,  # noqa
                                     CSVSource, FunctionSource)
from repro_torch.core.environment import (Environment,  # noqa
                                          LocalEnvironment,
                                          MeshEnvironment,
                                          EGIEnvironment,
                                          DeviceEnvironment,
                                          make_device_members,
                                          pinned_device)
from repro_torch.core.envpool import EnvironmentPool, PoolStats  # noqa
from repro_torch.core.faults import (FaultSpec, InjectedFailure,  # noqa
                                     ResultCorruption)
from repro_torch.core.cache import (TaskCache, DEFAULT_CACHE,  # noqa
                                    fingerprint_task, inputs_digest)
from repro_torch.core.scheduler import RunRecord, TaskRecord  # noqa
from repro_torch.core.taskqueue import TaskQueue, QueueEntry  # noqa
from repro_torch.core.service import ExplorationService  # noqa
from repro_torch.core.dsl import Puzzle, puzzle, explore, aggregate  # noqa
