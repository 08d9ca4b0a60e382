"""mfu.recon: the forwards' model FLOPs (flops.model_flops, train=False) over the window's wall time and the chip's bf16 peak."""
from portbench.metrics._lib import mfu as read  # noqa: F401
