from tpu_unet_torch.losses.bce import weighted_bce_with_logits, one_hot_targets
from tpu_unet_torch.losses.metrics import (
    iou,
    pixel_error,
    evaluation_metrics,
    batch_evaluation_metrics,
)
from tpu_unet_torch.losses.weights import class_balance, weighted_map
