from umeregrobust_tpu_torch.train.checkpoint import (
    load_checkpoint, optimizer_state, save_checkpoint)
from umeregrobust_tpu_torch.train.trainer import (
    TrainConfig, Trainer, make_train_step)
