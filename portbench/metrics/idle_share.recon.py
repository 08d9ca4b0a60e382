"""idle_share.recon: the share of the traced calls in which no operation ran on the device."""
from portbench.metrics._lib import idle_share as read  # noqa: F401
