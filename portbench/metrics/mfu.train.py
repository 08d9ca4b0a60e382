"""mfu.train: the train step's model FLOPs (flops.model_flops, train=True) over the window's wall time and the chips' bf16 peak."""
from portbench.metrics._lib import mfu as read  # noqa: F401
