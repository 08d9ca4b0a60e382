"""attn_roofline.recon: the summed bounds of every layer's attention forward over the traced calls'
tokens and allowed pairs (flops.attention_bound_s), over the attention forward kernels' device time."""
from portbench import flops
from portbench.metrics._lib import family_time, share


def read(cell, counters):
    t = counters.get("trace")
    if not t:
        return None
    return share(flops.attention_bound_s(cell.config, t["tokens"], t["pairs"], backward=False),
                 family_time(counters, "attention_fwd"))
