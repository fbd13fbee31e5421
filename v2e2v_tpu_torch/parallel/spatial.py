"""The spatial axis: the image width sharded over ranks (the port of what XLA
does for the JAX package's ``P(None, "data", None, "spatial", None)``
batches, ``v2e2v_tpu/parallel/mesh.py:47-52``).

Each rank of a spatial group holds a contiguous block of columns. An op that
reads across a cut pads its block with a halo of the neighbours' edge
columns (:func:`halo_pad`); at the true image edges it pads by its own rule,
reflect for the convs and replicate for the bilinear upsample, as one
process pads the whole image. Height is not sharded.

Transport: one symmetric ``all_reduce`` (sum) over the spatial group per
exchange. Each rank writes its edge columns into its slot of a zeroed
``[S, 2, ...]`` buffer, and after the sum every slot holds its owner's
columns (adding zeros is exact). It runs on ``nccl`` and ``gloo``, on CUDA
and CPU tensors alike (gloo's point-to-point ops and ``all_gather`` take CPU
tensors only), and every rank issues the same collectives in the same
order: the exchange and its backward are one autograd node each, the same
on every rank, whatever the rank's place, so a backward that recomputes a
step's forward (``remat``) interleaves them identically everywhere.

:func:`gather_cols` puts the blocks back together for the loss, whose SSIM
window and means read the whole image; its backward hands each rank its
own columns of the gradient.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

PAD_MODES = ("reflect", "replicate")


@dataclass(frozen=True)
class Shard:
    """This rank's place on the spatial axis: ``index`` of ``count`` blocks,
    the axis's process ``group``."""

    group: object
    index: int
    count: int

    @property
    def first(self) -> bool:
        return self.index == 0

    @property
    def last(self) -> bool:
        return self.index == self.count - 1

    def all_reduce(self, buf: torch.Tensor) -> None:
        """The sum over the group, in place: every exchange's one collective."""
        dist.all_reduce(buf, group=self.group)


def block_width(width: int, count: int) -> int:
    """The width of each of ``count`` equal blocks of ``width`` columns.
    Raises ``ValueError`` unless the width divides into ``2 * count`` equal
    blocks with at least 2 columns each: a rank's full-resolution block must
    be even (W0's stride-2 conv) and its half-resolution block must reflect
    at the true edges."""
    if width % (2 * count) or width // (2 * count) < 2:
        raise ValueError(f"a width of {width} does not divide over the spatial axis ({count}): "
                         f"it needs {2 * count} equal blocks of at least 2 columns (the port "
                         "shards no uneven width)")
    return width // count


def _edge(x: torch.Tensor, p: int, mode: str, dim: int, left: bool) -> torch.Tensor:
    """The ``p`` columns one process pads beyond this edge of ``x``."""
    w = x.shape[dim]
    if mode == "reflect":
        start = 1 if left else w - 1 - p
        return x.narrow(dim, start, p).flip(dim)
    col = x.narrow(dim, 0 if left else w - 1, 1)
    return col.expand(*x.shape[:dim], p, *x.shape[dim + 1:])


def _fold_edge(gx: torch.Tensor, g: torch.Tensor, p: int, mode: str, dim: int,
               left: bool) -> None:
    """Add the gradient ``g`` of the padding ``_edge`` made into ``gx``."""
    w = gx.shape[dim]
    if mode == "reflect":
        start = 1 if left else w - 1 - p
        gx.narrow(dim, start, p).add_(g.flip(dim))
    else:
        gx.narrow(dim, 0 if left else w - 1, 1).add_(g.sum(dim, keepdim=True))


class _HaloPad(torch.autograd.Function):
    """``x`` padded by ``p`` columns on each side along ``dim``: the
    neighbours' edge columns at inner cuts, ``mode``'s padding at the true
    edges. Backward sends each halo's gradient to the rank that owns those
    columns, which adds it into its edge columns."""

    @staticmethod
    def forward(ctx, x, p, mode, dim, shard):
        ctx.p, ctx.mode, ctx.dim, ctx.shard = p, mode, dim, shard
        i = shard.index
        buf = x.new_zeros((shard.count, 2) + tuple(x.narrow(dim, 0, p).shape))
        buf[i, 0] = x.narrow(dim, 0, p)
        buf[i, 1] = x.narrow(dim, x.shape[dim] - p, p)
        shard.all_reduce(buf)
        left = _edge(x, p, mode, dim, True) if shard.first else buf[i - 1, 1]
        right = _edge(x, p, mode, dim, False) if shard.last else buf[i + 1, 0]
        return torch.cat([left, x, right], dim)

    @staticmethod
    def backward(ctx, g):
        p, mode, dim, shard = ctx.p, ctx.mode, ctx.dim, ctx.shard
        i, w = shard.index, g.shape[dim] - 2 * p
        g_left, g_right = g.narrow(dim, 0, p), g.narrow(dim, p + w, p)
        gx = g.narrow(dim, p, w).clone()
        buf = g.new_zeros((shard.count, 2) + tuple(g_left.shape))
        if not shard.first:
            buf[i - 1, 1] = g_left
        if not shard.last:
            buf[i + 1, 0] = g_right
        shard.all_reduce(buf)
        if shard.first:
            _fold_edge(gx, g_left, p, mode, dim, True)
        else:
            gx.narrow(dim, 0, p).add_(buf[i, 0])
        if shard.last:
            _fold_edge(gx, g_right, p, mode, dim, False)
        else:
            gx.narrow(dim, w - p, p).add_(buf[i, 1])
        return gx, None, None, None, None


def halo_pad(x: torch.Tensor, p: int, mode: str, shard: Shard, dim: int = 2) -> torch.Tensor:
    """This rank's block ``x`` padded by ``p`` columns on each side along
    ``dim`` (2 for NHWC, 3 for NCHW): the neighbours' columns at inner cuts,
    ``mode`` (``"reflect"`` or ``"replicate"``) at the image's edges, exactly
    the columns one process's padding of the whole image puts there."""
    if mode not in PAD_MODES:
        raise ValueError(f"mode must be one of {PAD_MODES}, got {mode!r}")
    if not 0 < p < x.shape[dim]:
        raise ValueError(f"a halo of {p} columns needs a block wider than it, got "
                         f"{x.shape[dim]}")
    return _HaloPad.apply(x, p, mode, dim, shard)


class _GatherCols(torch.autograd.Function):
    """Every rank's block along ``dim``, in order; backward keeps this
    rank's columns of the gradient (every rank computes the same function of
    the whole, so its own columns' gradient is the whole's)."""

    @staticmethod
    def forward(ctx, x, dim, shard):
        ctx.dim, ctx.shard, ctx.w = dim, shard, x.shape[dim]
        buf = x.new_zeros((shard.count,) + tuple(x.shape))
        buf[shard.index] = x
        shard.all_reduce(buf)
        return torch.cat(buf.unbind(0), dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.shard.index * ctx.w, ctx.w).contiguous(), None, None


def gather_cols(x: torch.Tensor, shard: Shard, dim: int = 2) -> torch.Tensor:
    """The whole image from every rank's block ``x`` along ``dim`` (the
    same on every rank of the group)."""
    return _GatherCols.apply(x, dim, shard)
