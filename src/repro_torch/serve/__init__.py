from repro_torch.serve.engine import (ServeConfig, draw_gumbel,  # noqa
                                      generate, make_decode_step,
                                      make_prefill_step, sample_token,
                                      teacher_forced_logits)
from repro_torch.serve.bandit import (ARM_BOUNDS, Arm, ArmStats,  # noqa
                                      BanditConfig, BanditRouter,
                                      RouteResult, make_model_arm,
                                      quantize_params_int8, token_diversity)
