"""dct_roofline.recon: the byte bound of the traced calls' front and back end (flops.dct_bytes and
flops.idct_bytes at HBM's rate) over the device time of the DCT and IDCT libraries' kernels."""
from portbench import flops
from portbench.metrics._lib import family_time, share


def read(cell, counters):
    t = counters.get("trace")
    if not t:
        return None
    (h, w), n, tokens, p = t["image_hw"], t["images"], t["tokens"], cell.config["patch_size"]
    nbytes = flops.dct_bytes(n, h, w, tokens, p) + flops.idct_bytes(n, h, w, tokens, p)
    return share(nbytes / flops.HBM_BYTES_PER_S, family_time(counters, "dct"))
