"""idle_share.train: the share of the traced steps in which no operation ran on the device."""
from portbench.metrics._lib import idle_share as read  # noqa: F401
