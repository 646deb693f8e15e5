from repro_torch.explore.sampling import (Sampling, GridSampling,  # noqa
                                          UniformSampling, LHSSampling,
                                          SobolSampling, SeedSampling,
                                          CrossSampling)
from repro_torch.explore.statistics import (StatisticTask, median,  # noqa
                                            mean, std, q)
from repro_torch.explore.replication import (Replicate, replicated,  # noqa
                                             replicated_batch)
from repro_torch.explore.surrogate import (SurrogateConfig,  # noqa
                                           SurrogateExplorer,
                                           SurrogateResult, run_surrogate)
from repro_torch.explore.moacq import (MOSurrogateConfig,  # noqa
                                       MOSurrogateExplorer,
                                       MOSurrogateResult, run_surrogate_mo)
