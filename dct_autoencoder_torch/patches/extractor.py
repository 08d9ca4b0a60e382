"""Feature extraction: RGB images -> packed DCT patch token batches, and back.

* The front-end (RGB -> IPT -> whole-image DCT -> crop -> patchify) is
  kernels/dct_patchify.py: the CUDA kernel for images on the card, its plain
  version on the CPU.  Any image size goes through the kernel.
* Tokens are ranked by importance (0.1 * |patch|_inf - (h + w) / channel
  importance) with a stable sort on the device; only the data-dependent
  token budget k is applied on the host, to the sorted prefix.
* Packing is host-side (packing.py); batches land on the extractor's device.
* The back-end scatters tokens onto per-image DCT canvases (numpy) and runs
  kernels/idct_unpatchify.py per (canvas, size) group.
"""
from __future__ import annotations

import math
import random as _random
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..kernels.dct_patchify import fused_ipt_dct_patchify
from ..kernels.idct_unpatchify import fused_idct_unpatchify_rgb
from .container import DCTPatches
from .packing import GroupPatchesState, batch_groups, group_patches_by_max_seq_len


def exp_trunc_dist(beta: float, rng: Optional[_random.Random] = None) -> float:
    """Exponential draw for the stochastic token budget (same draws as the
    JAX package given the same random.Random)."""
    r = rng if rng is not None else _random
    return -1.0 / beta * math.log(r.random())


class DCTAutoencoderFeatureExtractor:
    """Image <-> packed DCT token pipeline on `device`."""

    def __init__(
        self,
        channels: int,
        patch_size: int,
        sample_patches_beta: float,
        max_patch_h: int,
        max_patch_w: int,
        max_seq_len: int,
        channel_importances: Tuple[float, ...] = (8.0, 1.0, 1.0),
        patch_sample_magnitude_weight: float = 0.1,
        rng: Optional[_random.Random] = None,
        device="cuda",
    ):
        from ..models.autoencoder import resolve_device

        if channels != 3:
            raise ValueError(f"the DCT kernels take 3-channel RGB images, got channels={channels}")
        self.channels = channels
        self.patch_size = patch_size
        self.sample_patches_beta = sample_patches_beta
        self.max_patch_h = max_patch_h
        self.max_patch_w = max_patch_w
        self.max_seq_len = max_seq_len
        self.channel_importances = tuple(float(x) for x in channel_importances)
        self.patch_sample_magnitude_weight = patch_sample_magnitude_weight
        self.rng = rng
        self.device = resolve_device(device)
        self._meta_cache = {}

    # ------------------------------------------------------------------ in

    def _get_crop_dims(self, h: int, w: int) -> Tuple[int, int]:
        """Floor (h, w) to patch multiples."""
        if h < self.patch_size or w < self.patch_size:
            raise ValueError(f"image {h}x{w} is smaller than one {self.patch_size}px patch")
        return (h // self.patch_size) * self.patch_size, (w // self.patch_size) * self.patch_size

    def _meta(self, h: int, w: int) -> dict:
        """Per-shape static token metadata (on the device)."""
        key = (h, w, self.max_seq_len)
        if key in self._meta_cache:
            return self._meta_cache[key]
        p, c = self.patch_size, self.channels
        ch, cw = self._get_crop_dims(h, w)
        ph, pw = ch // p, cw // p
        hh, ww = np.meshgrid(np.arange(ph), np.arange(pw), indexing="ij")
        valid = (hh < self.max_patch_h) & (ww < self.max_patch_w)
        vidx = np.nonzero(valid.reshape(-1))[0]
        hv = hh.reshape(-1)[vidx].astype(np.int32)
        wv = ww.reshape(-1)[vidx].astype(np.int32)
        total = len(vidx) * c
        dev = self.device
        meta = dict(
            crop=(ch, cw),
            grid=(ph, pw),
            total=total,
            cap=min(total, self.max_seq_len),
            vidx=torch.as_tensor(vidx, device=dev),
            # per-token (patch-major, channel-minor) metadata
            pos_rep=torch.as_tensor(np.stack([np.repeat(hv, c), np.repeat(wv, c)], axis=-1), device=dev),
            ch_rep=torch.as_tensor(np.tile(np.arange(c, dtype=np.int32), len(vidx)), device=dev),
            pos_dist=torch.as_tensor(-(hv + wv).astype(np.float32), device=dev),
            chan_imp=torch.as_tensor(np.asarray(self.channel_importances, dtype=np.float32), device=dev),
        )
        self._meta_cache[key] = meta
        return meta

    def _sorted_tokens(self, ims: torch.Tensor, meta: dict):
        """(B, c, h, w) on the device -> importance-sorted top-`cap`
        (patches (B, cap, p*p), positions (B, cap, 2), channels (B, cap))."""
        if ims.dtype == torch.uint8:
            ims = ims.float() / 255.0
        ims = ims.float().contiguous()
        ch, cw = meta["crop"]
        x = fused_ipt_dct_patchify(ims, self.patch_size, ch, cw)
        x = x.index_select(1, meta["vidx"])  # (B, s_valid, c, p*p)
        b = x.shape[0]
        mags = x.abs().amax(dim=-1) * self.patch_sample_magnitude_weight
        scores = mags + meta["pos_dist"][None, :, None] / meta["chan_imp"][None, None, :]
        order = torch.argsort(-scores.reshape(b, -1), dim=-1, stable=True)[:, : meta["cap"]]
        flat = x.reshape(b, meta["total"], -1)
        patches = torch.gather(flat, 1, order[..., None].expand(-1, -1, flat.shape[-1]))
        return patches, meta["pos_rep"][order], meta["ch_rep"][order]

    def sample_k(self, total: int) -> int:
        """Stochastic token budget."""
        k = total
        if self.sample_patches_beta > 0.0:
            k = min(round(exp_trunc_dist(self.sample_patches_beta, self.rng)), k)
            k = max(1, k)
        return min(k, self.max_seq_len)

    def preprocess_many(self, images: Sequence) -> List[dict]:
        """Images (c, h, w), float in [0, 1] or uint8, grouped by shape into
        one device call each (span `dct.front.preprocess`, with the copies
        `dct.copy.h2d.images` and `dct.copy.d2h.tokens` inside).  Returns
        per-image dicts in input order:
        patches (k, p*p), positions (k, 2), channels (k,), original_sizes,
        patch_sizes."""
        with obs.span("dct.front.preprocess"):
            by_shape = {}
            for i, im in enumerate(images):
                im = np.asarray(im)
                by_shape.setdefault(im.shape, []).append((i, im))

            out: List[Optional[dict]] = [None] * len(images)
            for (c, h, w), group in by_shape.items():
                if c != self.channels:
                    raise ValueError(f"expected {self.channels} channels, got {c}")
                meta = self._meta(h, w)
                stack = obs.to_device(np.stack([im for _, im in group]), self.device, "images")
                patches, positions, channels = (
                    obs.to_host(t, "tokens").numpy() for t in self._sorted_tokens(stack, meta)
                )
                for j, (i, _) in enumerate(group):
                    k = self.sample_k(meta["total"])
                    out[i] = dict(
                        patches=patches[j, :k],
                        positions=positions[j, :k],
                        channels=channels[j, :k],
                        original_sizes=(h, w),
                        patch_sizes=meta["grid"],
                    )
            return out  # type: ignore[return-value]

    def preprocess(self, im) -> dict:
        """One image (c, h, w) -> its token dict (see preprocess_many)."""
        return self.preprocess_many([im])[0]

    # --------------------------------------------------------------- batches

    def _batch(self, groups, patch_sizes, original_sizes, data) -> DCTPatches:
        return batch_groups(
            groups,
            self.max_seq_len,
            patch_sizes=tuple(patch_sizes),
            original_sizes=tuple(original_sizes),
            _data=data or None,
            device=self.device,
        )

    def iter_batches(self, dataloader: Iterable, batch_size: Optional[int] = None, drain: bool = False):
        """Greedy-pack a stream of per-image dicts into DCTPatches batches
        (span `dct.pack.rows` for each pull, collation included).

        `dataloader` yields dicts of lists (column -> per-image values);
        open rows carry over between pulls.  With batch_size None every pull
        is flushed into one batch.  drain=True also flushes the packing
        state when the stream ends (the last batches may have fewer rows).
        """
        state: Optional[GroupPatchesState] = None
        cum_original_sizes: List[Tuple[int, int]] = []
        cum_patch_sizes: List[Tuple[int, int]] = []
        cum_data: dict = {}

        def take(groups):
            nonlocal cum_original_sizes, cum_patch_sizes, cum_data
            n = sum(len(g) for g in groups)
            orig, cum_original_sizes = cum_original_sizes[:n], cum_original_sizes[n:]
            psz, cum_patch_sizes = cum_patch_sizes[:n], cum_patch_sizes[n:]
            data = {k: v[:n] for k, v in cum_data.items()}
            cum_data = {k: v[n:] for k, v in cum_data.items()}
            return self._batch(groups, psz, orig, data)

        for dict_data in dataloader:
            batch = None
            with obs.span("dct.pack.rows"):
                cum_original_sizes += list(dict_data["original_sizes"])
                cum_patch_sizes += list(dict_data["patch_sizes"])
                core = {"patches", "positions", "channels", "original_sizes", "patch_sizes"}
                for k, v in dict_data.items():
                    if k not in core:
                        cum_data.setdefault(k, []).extend(v)

                items = [
                    (np.asarray(p), np.asarray(pos), np.asarray(ch))
                    for p, pos, ch in zip(dict_data["patches"], dict_data["positions"], dict_data["channels"])
                ]
                state = group_patches_by_max_seq_len(items, self.max_seq_len, state)

                if batch_size is None and state.group:
                    state.groups.append(state.group)
                    state.group, state.seq_len = [], 0

                if batch_size is None or len(state.groups) > batch_size:
                    n_take = len(state.groups) if batch_size is None else batch_size
                    groups, rest = state.groups[:n_take], state.groups[n_take:]
                    state = GroupPatchesState(groups=rest, group=state.group, seq_len=state.seq_len)
                    batch = take(groups)
            if batch is not None:  # outside the span: the consumer runs while the generator waits
                yield batch

        if drain and state is not None:
            if state.group:
                state.groups.append(state.group)
                state.group, state.seq_len = [], 0
            while state.groups:
                n_take = batch_size or len(state.groups)
                groups, state.groups = state.groups[:n_take], state.groups[n_take:]
                yield take(groups)

    # ------------------------------------------------------------------ out

    def revert_patching(self, output: DCTPatches) -> List[np.ndarray]:
        """Scatter packed tokens onto zeroed per-image DCT canvases (host).

        Returns one (c, ph*p, pw*p) DCT plane per packed image.  The canvas
        covers the largest patch grid in the batch.
        """
        p, c = self.patch_size, self.channels
        H = max([self.max_patch_h] + [ph for ph, _ in output.patch_sizes])
        W = max([self.max_patch_w] + [pw for _, pw in output.patch_sizes])

        to_np = lambda t: t.detach().cpu().numpy()
        tokens = to_np(output.patches.float())
        ids = to_np(output.batched_image_ids).astype(np.int64)
        pad = to_np(output.key_pad_mask)
        chs = to_np(output.patch_channels).astype(np.int64)
        pos = to_np(output.patch_positions).astype(np.int64)
        b, s, pz = tokens.shape

        # global image index per token: rows contribute images in order
        n_per_row = np.where((~pad).any(axis=1), ids.max(axis=1, where=~pad, initial=0) + 1, 0)
        offsets = np.concatenate([[0], np.cumsum(n_per_row)])
        n_images = int(offsets[-1])
        if n_images != len(output.patch_sizes):
            raise ValueError(f"{n_images} packed images vs {len(output.patch_sizes)} metadata entries")

        gid = offsets[:-1, None] + ids
        flat_idx = ((gid * c + chs) * H + pos[..., 0]) * W + pos[..., 1]
        trash = n_images * c * H * W
        flat_idx = np.where(pad, trash, flat_idx).reshape(-1)

        canvas = np.zeros((n_images * c * H * W + 1, pz), dtype=np.float32)
        canvas[flat_idx] = tokens.reshape(-1, pz)
        canvas = canvas[:-1].reshape(n_images, c, H, W, pz)

        images = []
        for i, (ph, pw) in enumerate(output.patch_sizes):
            img = canvas[i, :, :ph, :pw, :]
            images.append(img.reshape(c, ph, pw, p, p).transpose(0, 1, 3, 2, 4).reshape(c, ph * p, pw * p))
        return images

    def postprocess(self, x: DCTPatches) -> List[np.ndarray]:
        """Packed (un-normalized) DCT patches -> RGB images (c, h, w) at their
        original sizes; images sharing a (canvas, size) go in one call."""
        dct_images = self.revert_patching(x)
        groups: dict = {}
        for i, (img, (h, w)) in enumerate(zip(dct_images, x.original_sizes)):
            groups.setdefault((img.shape[-2], img.shape[-1], h, w), []).append(i)

        images: List[Optional[np.ndarray]] = [None] * len(dct_images)
        for (ih, iw, h, w), idxs in groups.items():
            planes = torch.from_numpy(np.stack([dct_images[i] for i in idxs])).to(self.device)
            out = fused_idct_unpatchify_rgb(planes, h, w).cpu().numpy()
            for j, i in enumerate(idxs):
                images[i] = out[j]
        return images  # type: ignore[return-value]
