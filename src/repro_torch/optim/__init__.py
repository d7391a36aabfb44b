from repro_torch.optim.optimizers import (Optimizer, adafactor, adamw,
                                          clip_by_global_norm, get_optimizer,
                                          warmup_cosine)
