from repro_torch.serve.engine import (ServeConfig, draw_gumbel,  # noqa
                                      generate, make_decode_step,
                                      make_prefill_step, sample_token,
                                      teacher_forced_logits)
