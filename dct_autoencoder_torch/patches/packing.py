"""Host-side greedy sequence packing into fixed-shape batches.

Per-image token streams are packed first-fit into rows of at most
`max_seq_len` tokens, then collated into dense (b, max_seq_len) tensors.
The padding image id is 0 and the padding mask is True.  The model derives
its attention mask from the ids, so no (b, s, s) mask is built.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import obs
from .container import DCTPatches

Item = Tuple[np.ndarray, np.ndarray, np.ndarray]


@dataclasses.dataclass
class GroupPatchesState:
    """Packing state carried across dataloader pulls: completed rows
    (`groups`), the open row (`group`) and its token count."""

    groups: List[List[Item]]
    group: List[Item]
    seq_len: int

    @staticmethod
    def empty() -> "GroupPatchesState":
        return GroupPatchesState(groups=[], group=[], seq_len=0)


def group_patches_by_max_seq_len(
    items: List[Item],
    max_seq_len: int,
    state: Optional[GroupPatchesState] = None,
) -> GroupPatchesState:
    """Greedy packing of (patches (k, pz), positions (k, 2), channels (k,))
    items; a row is closed as soon as the next image would overflow it."""
    if state is None:
        state = GroupPatchesState.empty()

    for patches, pos, channels in items:
        k = patches.shape[0]
        if k > max_seq_len:
            raise ValueError(f"image with {k} tokens exceeds max_seq_len {max_seq_len}")
        if pos.shape[0] != k or channels.shape[0] != k:
            raise ValueError("patches, positions and channels disagree in length")

        if state.seq_len + k > max_seq_len:
            state.groups.append(state.group)
            state.group = []
            state.seq_len = 0

        state.group.append((patches, pos, channels))
        state.seq_len += k

    return state


def fill_batch(groups: List[List[Item]], max_seq_len: int, pz: int):
    """Padded (b, S, ...) numpy buffers:
    (patches, positions, channels, image_ids, key_pad_mask)."""
    b = len(groups)
    out_patches = np.zeros((b, max_seq_len, pz), dtype=np.float32)
    out_positions = np.zeros((b, max_seq_len, 2), dtype=np.int32)
    out_channels = np.zeros((b, max_seq_len), dtype=np.int32)
    out_image_ids = np.zeros((b, max_seq_len), dtype=np.int32)
    out_pad = np.ones((b, max_seq_len), dtype=bool)
    for r, row in enumerate(groups):
        off = 0
        for slot, (patches, pos, ch) in enumerate(row):
            k = patches.shape[0]
            out_patches[r, off : off + k] = patches
            out_positions[r, off : off + k] = pos
            out_channels[r, off : off + k] = ch
            out_image_ids[r, off : off + k] = slot
            out_pad[r, off : off + k] = False
            off += k
    return out_patches, out_positions, out_channels, out_image_ids, out_pad


def build_attn_mask(image_ids: np.ndarray, key_pad_mask: np.ndarray) -> np.ndarray:
    """(b, s) ids and padding -> the (b, s, s) bool mask the ids imply:
    allowed(i, j) = ids[i] == ids[j] and not pad[j].  The model never
    builds it; tools and tests that want the dense mask do."""
    return (image_ids[:, :, None] == image_ids[:, None, :]) & ~key_pad_mask[:, None, :]


def batch_groups(
    groups: List[List[Item]],
    max_seq_len: int,
    patch_sizes: Tuple[Tuple[int, int], ...] = (),
    original_sizes: Tuple[Tuple[int, int], ...] = (),
    _data: Optional[Dict[str, List[Any]]] = None,
    device="cpu",
) -> DCTPatches:
    """Collate completed rows into a DCTPatches batch on `device` (span
    `dct.pack.collate`; the uploads are `dct.copy.h2d.batch`)."""
    with obs.span("dct.pack.collate"):
        pz = next((item[0].shape[-1] for row in groups for item in row), 0)
        patches, positions, channels, image_ids, pad = fill_batch(groups, max_seq_len, pz)
        data_tuple = tuple((k, tuple(v)) for k, v in _data.items()) if _data else None
        as_t = lambda a: obs.to_device(a, device, "batch")
        return DCTPatches(
            patches=as_t(patches),
            key_pad_mask=as_t(pad),
            batched_image_ids=as_t(image_ids),
            patch_channels=as_t(channels),
            patch_positions=as_t(positions),
            patch_sizes=tuple(tuple(ps) for ps in patch_sizes),
            original_sizes=tuple(tuple(os) for os in original_sizes),
            _data=data_tuple,
        )
