from umeregrobust_tpu_torch.losses.losses import (
    CUBE_CORNERS,
    cube_registration_loss,
    nanmedian_mean,
    pointwise_infonce,
    ume_contrastive_loss,
)
