from repro_torch.optim.optimizer import (OptState, adamw_update,
                                         clip_by_global_norm, global_norm,
                                         init_opt_state, lr_schedule)

__all__ = ["OptState", "init_opt_state", "adamw_update", "lr_schedule",
           "global_norm", "clip_by_global_norm"]
