from tpu_unet_torch.utils.profiling import (StepTimer, measure_roundtrip, timeit_readback,
                                            trace_capture)
from tpu_unet_torch.utils.debug import enable_nan_checks, debug_flags
