from repro_torch.explore.sampling import (Sampling, GridSampling,  # noqa
                                          UniformSampling, LHSSampling,
                                          SobolSampling, SeedSampling,
                                          CrossSampling)
from repro_torch.explore.statistics import (StatisticTask, median,  # noqa
                                            mean, std, q)
from repro_torch.explore.replication import (Replicate, replicated,  # noqa
                                             replicated_batch)
