"""Small cells for the CPU: the real cells' files with the widths, depths, pools and windows cut down."""
from __future__ import annotations

import copy
import time

from portbench import common

TINY_MODEL = {
    "encoder_config": {"hidden_size": 32, "intermediate_size": 64, "num_attention_heads": 2, "num_hidden_layers": 1},
    "decoder_config": {"hidden_size": 32, "intermediate_size": 64, "num_attention_heads": 2, "num_hidden_layers": 1},
    "vq_num_codebooks": 2,
    "vq_codebook_size": 256,
}


def tiny_cell(workload: str, seed: int = 7, seconds: float = 0.5, trace: bool = False, **traffic) -> common.Cell:
    spec = common.find_cell(workload)
    cfg = copy.deepcopy(spec["config"])
    for k, v in TINY_MODEL.items():
        if isinstance(v, dict):
            cfg[k].update(v)
        else:
            cfg[k] = v
    tr = dict(spec["traffic"])
    if tr["kind"] == "train":
        tr.update(rows=4, pool_images=48, image_sizes=[[56, 56], [70, 84], [42, 98], [28, 28]], feed_images=8,
                  warmup_steps=4, trace_steps=2, block_rows=2, norm_side=56)
    else:
        tr.update(image_size=[56, 56], images_per_call=2, pool_images=6, warmup_calls=1, trace_calls=2, block_rows=1,
                  norm_side=56)
    tr.update(traffic)
    return common.Cell(
        name=workload, config=cfg, traffic=tr, chips=spec["workload"]["chips"], seed=seed, seconds=seconds,
        trace=trace, end_to_end=spec["end_to_end"], per_layer=spec["per_layer"], limits=spec["limits"],
        device="cpu", t0=time.perf_counter(),
    )
