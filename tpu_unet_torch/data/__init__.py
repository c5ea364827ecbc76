from tpu_unet_torch.data.ingest import (
    SegmentationData,
    preprocess_gt,
    crop_distribution,
    square_crop,
    load_ctc_training,
    load_ctc_test,
    load_isbi_training,
)
from tpu_unet_torch.data.synthetic import synthetic_dataset
from tpu_unet_torch.data.augment import AugmentPipeline
