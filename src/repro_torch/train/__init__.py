from repro_torch.train.loop import Trainer
from repro_torch.train.step import (cross_entropy, init_state, make_loss_fn,
                                    make_train_step)

__all__ = ["Trainer", "cross_entropy", "init_state", "make_loss_fn",
           "make_train_step"]
