from tpu_unet_torch.ops.conv_pallas import (
    conv3x3_bias_relu,
    conv3x3_bias_relu_plain,
)
from tpu_unet_torch.ops.edt_pallas import column_pass, column_pass_plain
from tpu_unet_torch.ops.pad import reflect_pad, fold_reflect
