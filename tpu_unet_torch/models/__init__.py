from tpu_unet.config import ModelConfig
from tpu_unet_torch.models.unet import UNet, center_crop_or_pad
