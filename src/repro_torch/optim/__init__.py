from repro_torch.optim.optimizers import (OptConfig, cosine_schedule,
                                          init_opt_state, opt_update)
