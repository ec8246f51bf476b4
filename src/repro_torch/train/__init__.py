"""Training: AdamW, int8 gradient compression with error feedback, the
train / prefill / serve steps and manifest-driven checkpoints (the
reference's ``repro.train``, on one device: no mesh)."""
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                         init_opt_state)
from repro_torch.train.train_step import (make_loss_fn, make_prefill_step,
                                          make_serve_step, make_train_step)
