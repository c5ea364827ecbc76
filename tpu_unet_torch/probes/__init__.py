"""Probes that time one kernel family on the card at fixed shapes; each runs
as ``python -m tpu_unet_torch.probes.<name>``."""
