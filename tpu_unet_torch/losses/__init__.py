from tpu_unet_torch.losses.metrics import (
    iou,
    pixel_error,
    evaluation_metrics,
    batch_evaluation_metrics,
)
