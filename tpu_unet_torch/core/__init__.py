from tpu_unet_torch.core.geometry import (CONTEXT, DEPTH, TilePlan, context_for_depth,
                                          input_size_compute, input_size_for_output,
                                          output_size_for_input, plan_tiles, valid_sizes)
