"""attn_roofline.train: the summed bounds of every layer's attention forward and backward over the
traced steps' valid tokens and allowed pairs (flops.attention_bound_s), over the device time of the
attention forward and backward kernels in the trace."""
from portbench import flops
from portbench.metrics._lib import family_time, share


def read(cell, counters):
    t = counters.get("trace")
    if not t:
        return None
    return share(flops.attention_bound_s(cell.config, t["tokens"], t["pairs"], backward=True),
                 family_time(counters, "attention_fwd", "attention_bwd"))
