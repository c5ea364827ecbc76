from tpu_unet_torch.infer.tiles import TileInference, make_tile_batch_forward
from tpu_unet_torch.infer.tester import evaluate, export_predictions
