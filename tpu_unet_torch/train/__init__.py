from tpu_unet_torch.train.optimizer import (PlateauState, make_optimizer, plateau_init,
                                            plateau_step, set_learning_rate)
from tpu_unet_torch.train.trainer import Trainer
