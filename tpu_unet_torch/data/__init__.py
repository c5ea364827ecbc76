from tpu_unet_torch.data.ingest import (
    SegmentationData,
    preprocess_gt,
    crop_distribution,
    square_crop,
)
from tpu_unet_torch.data.synthetic import synthetic_dataset
