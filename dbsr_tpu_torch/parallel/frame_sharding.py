"""The burst-frame axis sharded over processes (port of
``dbsr_tpu/parallel/frame_sharding.py``), the sequence-parallel analog for
long bursts (N >> 14).

Per-frame work (the encoder, the alignment, the merge's weight predictor)
is independent across frames; the only cross-frame computation, the
fusion's softmax-weighted sum over the frames, decomposes into all-reduces
of per-shard statistics over a ``torch.distributed`` process group: MAX of
the local maximum logit, then SUM of the normaliser and of the weighted
sum. No frame is gathered. Where the JAX package uses a ``frame`` mesh axis
inside ``shard_map``, each process here holds its shard and ``group`` is
the axis (``None``: the whole world). Forward only: the collectives carry no
autograd.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist


def _max_(t: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t


def _sum_(t: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(t, group=group)
    return t


def sharded_softmax_fusion(feats: torch.Tensor, logits: torch.Tensor,
                           group=None) -> torch.Tensor:
    """``sum_i softmax_i(logits) * feats`` over the frame axis (dim 1)
    sharded over ``group``: ``feats`` / ``logits`` are this rank's frames
    ``[B, n_local, H, W, C]``; the result ``[B, H, W, C]`` is the same on
    every rank of the group."""
    gmax = _max_(logits.amax(dim=1, keepdim=True), group)
    ex = torch.exp(logits - gmax)
    norm = _sum_(ex.sum(dim=1, keepdim=True), group)
    wsum = _sum_((feats * ex).sum(dim=1, keepdim=True), group)
    return (wsum / norm)[:, 0]


def masked_sharded_softmax_fusion(feats: torch.Tensor, logits: torch.Tensor,
                                  mask: torch.Tensor,
                                  group=None) -> torch.Tensor:
    """:func:`sharded_softmax_fusion` with a validity ``mask`` of the local
    frames (broadcasting against ``logits``, e.g. ``[1, n_local, 1, 1,
    1]``): invalid frames weigh zero. The base frame, replicated on every
    shard, is counted on shard 0 only, and padded frames are masked."""
    neg = torch.full((), float("-inf"), dtype=logits.dtype,
                     device=logits.device)
    gmax = _max_(torch.where(mask > 0, logits, neg).amax(dim=1, keepdim=True),
                 group)
    ex = torch.exp(logits - gmax) * mask.to(logits.dtype)
    norm = _sum_(ex.sum(dim=1, keepdim=True), group)
    wsum = _sum_((feats * ex).sum(dim=1, keepdim=True), group)
    return (wsum / norm)[:, 0]


def make_frame_sharded_fusion(group=None):
    """``fn(feats [B, N, H, W, C], logits [B, N, H, W, C]) -> [B, H, W,
    C]``: every rank passes the whole arrays, fuses its ``N / ranks``
    frames (in rank order) and gets the fusion of all N."""

    def fused(feats: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
        n, r = dist.get_world_size(group), dist.get_rank(group)
        N = feats.shape[1]
        if N % n:
            raise ValueError(f"{N} frames not divisible by the {n} ranks of "
                             "the frame group")
        k = N // n
        return sharded_softmax_fusion(feats[:, r * k:(r + 1) * k],
                                      logits[:, r * k:(r + 1) * k], group)

    return fused


def make_data_frame_groups(n_data: int, n_frame: int) -> Tuple[object, object]:
    """``(frame_group, data_group)`` of this rank in a 2-D data x frame
    layout of ``n_data * n_frame`` ranks, rank ``d * n_frame + f`` at data
    index ``d`` and frame index ``f`` (the JAX package's
    ``make_mesh(n, ("data", "frame"), (n_data, n_frame))``). Every rank
    creates every group, in the same order."""
    if dist.get_world_size() != n_data * n_frame:
        raise ValueError(f"{dist.get_world_size()} ranks, not {n_data} x "
                         f"{n_frame}")
    r = dist.get_rank()
    frame_group = data_group = None
    for d in range(n_data):
        g = dist.new_group([d * n_frame + f for f in range(n_frame)])
        if r // n_frame == d:
            frame_group = g
    for f in range(n_frame):
        g = dist.new_group([d * n_frame + f for d in range(n_data)])
        if r % n_frame == f:
            data_group = g
    return frame_group, data_group


@torch.no_grad()
def dbsr_apply_frame_sharded(net, burst: torch.Tensor, group=None,
                             data_group: Optional[object] = None
                             ) -> torch.Tensor:
    """A ``DBSRNet`` forward with the burst's frames sharded over
    ``group``: numerically the dense ``net(burst)[0]``.

    Every rank of the group passes the whole ``burst`` ``[B, N, h, w, 4]``
    and runs the reference frame with its ``ceil((N - 1) / ranks)`` other
    frames (the frame axis zero-padded to a multiple of the ranks) through
    the encoder and the merge's weight predictor; the fusion is
    :func:`masked_sharded_softmax_fusion` (the base frame counted on shard
    0 only, the padded frames masked), and the decoder runs replicated on
    the fused map. With ``data_group`` the batch is also split over that
    group (2-D data x frame; see :func:`make_data_frame_groups`): the
    fusion reduces over ``group`` only, and the rank returns its data
    shard's rows ``[B / data ranks, H, W, 3]``; without it, the whole
    batch's prediction, float32. Requires ``use_base_frame`` and
    ``softmax`` (the mean base would need a cross-shard mean)."""
    merging = net.merging
    assert merging.use_base_frame and merging.softmax, (
        "frame sharding requires use_base_frame=True and softmax=True")
    if data_group is not None:
        nd, di = dist.get_world_size(data_group), dist.get_rank(data_group)
        if burst.shape[0] % nd:
            raise ValueError(f"batch {burst.shape[0]} not divisible by the "
                             f"{nd} ranks of the data group")
        per = burst.shape[0] // nd
        burst = burst[di * per:(di + 1) * per]
    n_shards, sidx = dist.get_world_size(group), dist.get_rank(group)
    B, N = burst.shape[0], burst.shape[1]
    n_oth = N - 1
    k = -(-n_oth // n_shards)  # ceil: local others per shard
    oth = burst[:, 1:]
    pad = k * n_shards - n_oth
    if pad:
        oth = torch.cat([oth, oth.new_zeros((B, pad) + oth.shape[2:])], dim=1)
    local = torch.cat([burst[:, :1], oth[:, sidx * k:(sidx + 1) * k]], dim=1)

    ml = merging(net.encoder(local), return_logits=True)
    all_feat, logits = ml["all_feat"], ml["logits"]
    # validity over the local frames [base, k others]: the base frame
    # counted on shard 0 only, padded others masked everywhere
    oth_idx = sidx * k + torch.arange(k, device=logits.device)
    valid = torch.cat([torch.tensor([sidx == 0], device=logits.device),
                       oth_idx < n_oth])
    mask = valid.reshape(1, 1 + k, 1, 1, 1).to(logits.dtype)
    fused = masked_sharded_softmax_fusion(all_feat, logits, mask, group)
    return net.decoder(fused).float()
