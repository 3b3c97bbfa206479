"""Width sharding: the "space" axis of the JAX package's ("data", "space")
mesh (diffmvs_tpu/parallel/mesh.py), written out by hand.

Under JAX's GSPMD the image width is sharded over "space" and XLA inserts
the convolutions' halo exchanges, the gathers and the reductions itself.
Here each of them is explicit:

  * the column split (split_columns): W in blocks of 32 columns (the
    model takes W to 1/32 in CostRegNet), spread over the S ranks of a
    space group as evenly as possible, the first ranks taking one block
    more: DTU's 1600 over 4 gives 416 / 416 / 384 / 384. A map at stride
    f holds this rank's columns divided by f;
  * Shard: one forward's layout, every rank's width (all-gathered once
    from the local widths, so the model takes any 32-aligned split) and
    this rank's column range at every stride;
  * halo / halo_conv: the columns a convolution reads beyond its shard,
    taken from the neighbours, zeros at the global edges (what the
    convolution's own padding gave there), and the convolution over them,
    which keeps only the shard and its halo for the backward; the
    backward adds each halo's gradient back into the neighbour's edge
    columns;
  * Shard.gather: a map at full width; its backward is the sum of every
    rank's gradient over the space group, sliced to this rank's columns;
  * group_norm: GroupNorm whose moments are summed over the space group.

The collectives are all_gather and all_reduce only, so the same code runs
on NCCL (one card per rank) and on gloo, with CPU or CUDA tensors (two
ranks on one card). shard_width converts a model's convolutions and
GroupNorms in place (nn/layers.py, nn/unet.py: same parameters, same
state_dict keys); the model then takes this rank's columns of each map.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

ALIGN = 32           # columns per block: the model's coarsest stride


def split_columns(width: int, parts: int) -> List[Tuple[int, int]]:
    """[(start, stop)] of each of `parts` ranks' columns of a map `width`
    wide: whole blocks of ALIGN columns, as even as possible, the first
    ranks taking one block more."""
    if width % ALIGN:
        raise ValueError(f"width {width} is not a multiple of {ALIGN}")
    blocks, extra = divmod(width // ALIGN, parts)
    if blocks == 0:
        raise ValueError(f"width {width} has fewer than {parts} blocks of "
                         f"{ALIGN} columns")
    out, start = [], 0
    for r in range(parts):
        stop = start + ALIGN * (blocks + (r < extra))
        out.append((start, stop))
        start = stop
    return out


def column_slice(batch, rank: int, size: int):
    """This space rank's columns of a batch (numpy arrays or tensors):
    "imgs" [B, V, H, W, 3] along W, every map of the "depth" and "mask"
    dicts [B, h, w] along w at its own stride; the projections, the depth
    values and the file names whole (the warp's column offset carries the
    shift)."""
    if size == 1:
        return batch
    width = batch["imgs"].shape[3]
    start, stop = split_columns(width, size)[rank]
    out = dict(batch)
    out["imgs"] = batch["imgs"][:, :, :, start:stop]
    for key in ("depth", "mask"):
        if key in batch:
            out[key] = {}
            for k, v in batch[key].items():
                f = width // v.shape[2]
                out[key][k] = v[:, :, start // f:stop // f]
    return out


@dataclasses.dataclass(frozen=True)
class SpaceGroup:
    """This rank's place on the space axis: the process group of the S
    ranks that share its rows (None for S = 1), its index among them."""

    group: object
    rank: int
    size: int

    def shard(self, local_width: int, device) -> "Shard":
        """The layout of a forward whose maps are local_width columns wide
        here (full resolution): every rank's width, all-gathered."""
        w = torch.tensor([local_width], dtype=torch.int64, device=device)
        widths = tuple(int(t) for t in torch.cat(all_gather(w, self)))
        return Shard(self, widths)


@dataclasses.dataclass(frozen=True)
class Shard:
    """One forward's column layout: `widths` at full resolution, rank by
    rank."""

    space: SpaceGroup
    widths: Tuple[int, ...]

    def __post_init__(self):
        if any(w <= 0 or w % ALIGN for w in self.widths):
            raise ValueError(f"shard widths {self.widths}: each must be a "
                             f"positive multiple of {ALIGN}")

    @property
    def width(self) -> int:
        return sum(self.widths)

    def at(self, stride: int) -> "Columns":
        """This rank's columns of a map at 1/stride resolution."""
        r = self.space.rank
        start = sum(self.widths[:r]) // stride
        return Columns(start, start + self.widths[r] // stride,
                       self.width // stride)

    def gather(self, x, dim: int, stride: int = 1):
        """x (this rank's columns along dim, at 1/stride resolution) at
        full width, differentiable."""
        return _GatherWidth.apply(x, dim,
                                  tuple(w // stride for w in self.widths),
                                  self.space)


@dataclasses.dataclass(frozen=True)
class Columns:
    """Columns [start, stop) of a map `width` wide."""

    start: int
    stop: int
    width: int

    def take(self, x):
        """The columns of x [..., width] (a tensor or a numpy array)."""
        return x[..., self.start:self.stop]


def all_gather(t, space: SpaceGroup) -> List[torch.Tensor]:
    """Every space rank's t (same shape on each), in rank order."""
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(space.size)]
    dist.all_gather(out, t, group=space.group)
    return out


def all_reduce(t, space: SpaceGroup):
    """t summed over the space group, in place; returns t."""
    dist.all_reduce(t, group=space.group)
    return t


def halo(x, left: int, right: int, space: SpaceGroup):
    """x [..., w] with `left` columns of the left neighbour and `right` of
    the right neighbour around it (zeros at the global edges):
    [..., left + w + right], differentiable."""
    if left == 0 and right == 0:
        return x
    return _Halo.apply(x, left, right, space)


def _exchange(x, left, right, space):
    """(lo, hi): the left neighbour's last `left` columns and the right
    neighbour's first `right` (zeros at the global edges), by one
    all_gather of every rank's edges."""
    w = x.shape[-1]
    if w < max(left, right):
        raise ValueError(f"a halo of {left}/{right} columns from a shard "
                         f"{w} wide")
    if left == 0 and right == 0:
        return x[..., :0], x[..., :0]
    s, n = space.rank, space.size
    edges = all_gather(torch.cat([x[..., :right], x[..., w - left:]], -1),
                       space)
    lo = (edges[s - 1][..., right:] if s > 0
          else x.new_zeros(x.shape[:-1] + (left,)))
    hi = (edges[s + 1][..., :right] if s < n - 1
          else x.new_zeros(x.shape[:-1] + (right,)))
    return lo, hi


def _join(lo, x, hi):
    """cat([lo, x, hi], -1) in x's memory format (an empty piece would
    make cat's result contiguous): a convolution over channels-last input
    sums in another order than over contiguous input."""
    if not lo.shape[-1] and not hi.shape[-1]:
        return x
    fmt = _memory_format(x)
    return torch.cat([t.contiguous(memory_format=fmt)
                      for t in (lo, x, hi) if t.shape[-1]], -1)


def _return_halo_grads(g, w, left, right, space):
    """The gradient of x from that of [lo, x, hi]: each halo's gradient
    added into the neighbour's columns it came from, by one all_gather."""
    if left == 0 and right == 0:
        return g
    s, n = space.rank, space.size
    grads = all_gather(torch.cat([g[..., :left], g[..., left + w:]], -1),
                       space)
    dx = g[..., left:left + w].clone()
    if s < n - 1 and left:            # my last columns: right rank's halo
        dx[..., w - left:] += grads[s + 1][..., :left]
    if s > 0 and right:               # my first columns: left rank's halo
        dx[..., :right] += grads[s - 1][..., left:]
    return dx


class _Halo(torch.autograd.Function):
    """Forward: one all_gather of every rank's edges. Backward: one
    all_gather of every rank's halo gradients, each added into the
    columns it came from."""

    @staticmethod
    def forward(ctx, x, left, right, space):
        ctx.dims = (x.shape[-1], left, right)
        ctx.space = space
        lo, hi = _exchange(x, left, right, space)
        return _join(lo, x, hi)

    @staticmethod
    def backward(ctx, g):
        w, left, right = ctx.dims
        return (_return_halo_grads(g, w, left, right, ctx.space), None,
                None, None)


def halo_conv(x, weight, bias, conv, left: int, right: int, start: int,
              width: int, space: SpaceGroup):
    """aten.convolution(x with its halo, weight, bias, *conv) along W,
    columns [start, start + width) of the result, differentiable in x,
    weight and bias. conv: (stride, padding, dilation, transposed,
    output_padding, groups), the padding zero along W."""
    return _HaloConv.apply(x, weight, bias, conv, left, right, start, width,
                           space)


class _HaloConv(torch.autograd.Function):
    """A convolution (or transposed convolution) of a width shard and its
    halo that keeps the shard and the halo columns for the backward, not
    the joined copy, and joins them again there: the layer before already
    keeps the shard, so a joined copy kept here would hold each conv's
    input twice. The backward is aten's, then the halo gradients go back
    to the neighbours."""

    @staticmethod
    def forward(ctx, x, weight, bias, conv, left, right, start, width,
                space):
        lo, hi = _exchange(x, left, right, space)
        out = torch.ops.aten.convolution(_join(lo, x, hi), weight, bias,
                                         *conv)
        ctx.save_for_backward(x, weight, lo, hi)
        ctx.args = (conv, left, right, start, out.shape[-1],
                    None if bias is None else list(bias.shape), space)
        return out[..., start:start + width]

    @staticmethod
    def backward(ctx, g):
        x, weight, lo, hi = ctx.saved_tensors
        conv, left, right, start, full, bias_shape, space = ctx.args
        if g.shape[-1] != full:
            g = torch.nn.functional.pad(
                g, (start, full - start - g.shape[-1]))
        need = list(ctx.needs_input_grad[:3])
        need[2] = need[2] and bias_shape is not None
        dx, dw, db = torch.ops.aten.convolution_backward(
            g, _join(lo, x, hi), weight, bias_shape, *conv, need)
        if need[0]:
            dx = _return_halo_grads(dx, x.shape[-1], left, right, space)
        return (dx, dw, db) + (None,) * 6


def _memory_format(x):
    """The memory format a convolution over x computes in: channels-last
    (2-D or 3-D) where the channels are x's innermost dim (a channels-last
    map, or a channel slice of one), else contiguous."""
    if x.dim() in (4, 5) and x.shape[1] > 1 and x.stride(1) == 1:
        return (torch.channels_last if x.dim() == 4
                else torch.channels_last_3d)
    return torch.contiguous_format


class _GatherWidth(torch.autograd.Function):
    """Forward: the shards, padded to the widest, all-gathered and joined
    along dim. Backward: the full-width gradient summed over the space
    group (one all_reduce), this rank's columns of it."""

    @staticmethod
    def forward(ctx, x, dim, widths: Sequence[int], space):
        dim = dim % x.dim()
        if x.shape[dim] != widths[space.rank]:
            raise ValueError(f"shard of width {x.shape[dim]} along dim {dim}"
                             f", layout {widths}")
        pad = max(widths) - x.shape[dim]
        if pad:
            shape = list(x.shape)
            shape[dim] = pad
            x = torch.cat([x, x.new_zeros(shape)], dim)
        parts = all_gather(x, space)
        ctx.dim, ctx.widths, ctx.space = dim, tuple(widths), space
        return torch.cat([p.narrow(dim, 0, w)
                          for p, w in zip(parts, widths)], dim)

    @staticmethod
    def backward(ctx, g):
        r = ctx.space.rank
        g = all_reduce(g.contiguous().clone(), ctx.space)
        start = sum(ctx.widths[:r])
        return (g.narrow(ctx.dim, start, ctx.widths[r]), None, None, None)


class _SpaceGroupNorm(torch.autograd.Function):
    """GroupNorm over the whole width of a sharded map.

    Forward: per (sample, group) the sum, the sum of squares and the count
    of the shard, in float64, summed over the space group by one
    all_reduce, give the mean and the biased variance; the normalization
    runs in float32 and the result takes the input's dtype. Backward: the
    per-group sums of dy * w and of dy * w * xhat, in float64, summed by
    one all_reduce; the affine gradients are this shard's sums (the
    data-parallel gradient sum adds the other shards'). Written out, as
    parallel/distributed._SyncBatchNormFn is, so that the backward keeps
    the input alone rather than its float64 copy."""

    @staticmethod
    def forward(ctx, x, num_groups, weight, bias, eps, space):
        n, c = x.shape[:2]
        xg = x.double().reshape(n, num_groups, -1)
        moments = all_reduce(torch.cat([
            xg.sum(-1), (xg * xg).sum(-1),
            xg.new_full((n, num_groups), xg.shape[-1])], 1), space)
        del xg
        cnt = moments[:, 2 * num_groups:]
        mean = moments[:, :num_groups] / cnt
        var = (moments[:, num_groups:2 * num_groups] / cnt
               - mean * mean).clamp_min(0.0)
        invstd = torch.rsqrt(var + eps).float()
        mean = mean.float()
        ctx.save_for_backward(x, weight, mean, invstd, cnt)
        ctx.num_groups, ctx.space = num_groups, space
        y = _normalize(x, mean, invstd, num_groups)
        shape = (1, c) + (1,) * (x.dim() - 2)
        return (y * weight.view(shape) + bias.view(shape)).to(x.dtype)

    @staticmethod
    def backward(ctx, gy):
        x, weight, mean, invstd, cnt = ctx.saved_tensors
        g = ctx.num_groups
        n, c = x.shape[:2]
        shape = (1, c) + (1,) * (x.dim() - 2)
        xhat = _normalize(x, mean, invstd, g)
        gy = gy.float()
        gx = gy * weight.view(shape)
        sums = all_reduce(torch.cat([
            gx.double().reshape(n, g, -1).sum(-1),
            (gx.double() * xhat.double()).reshape(n, g, -1).sum(-1)], 1),
            ctx.space)
        mean_gx = (sums[:, :g] / cnt).float()
        mean_gxx = (sums[:, g:] / cnt).float()
        gxg = gx.reshape(n, g, -1)
        xg = xhat.reshape(n, g, -1)
        dx = (gxg - mean_gx[..., None] - xg * mean_gxx[..., None]) \
            * invstd[..., None]
        dims = [0] + list(range(2, x.dim()))
        dw = (gy.double() * xhat.double()).sum(dims).float()
        db = gy.double().sum(dims).float()
        return (dx.reshape(x.shape).to(x.dtype), None, dw, db, None, None)


def _normalize(x, mean, invstd, num_groups):
    """(x - mean) * invstd per (sample, group), float32, x's shape."""
    n = x.shape[0]
    xg = x.float().reshape(n, num_groups, -1)
    return ((xg - mean[..., None]) * invstd[..., None]).reshape(x.shape)


def group_norm(x, num_groups, weight, bias, eps, space: SpaceGroup):
    """F.group_norm of the full-width map whose columns x holds, computed
    in float32 (float64 moments) and returned in x's dtype."""
    return _SpaceGroupNorm.apply(x, num_groups, weight, bias, eps, space)


def shard_width(model, space: SpaceGroup):
    """Converts the model's convolutions and GroupNorms, in place, into
    their width-sharded forms over `space` (the same module objects, so
    the parameters, an optimizer over them and the state_dict keys carry
    over) and sets model.space. Raises on a convolution or norm it has no
    sharded form for. Returns the model."""
    import torch.nn as nn

    from diffmvs_tpu_torch.nn import layers, unet

    forms = {layers.Conv2d: layers.SpaceConv2d,
             layers.Conv3d: layers.SpaceConv3d,
             layers.ConvTranspose3d: layers.SpaceConvTranspose3d,
             unet.WSConv: unet.SpaceWSConv,
             unet.GroupNorm: unet.SpaceGroupNorm}
    sharded = tuple(forms.values())
    for name, m in model.named_modules():
        form = forms.get(type(m))
        if form is not None:
            form.check(m)
            m.__class__ = form
            m.space = space
        elif (isinstance(m, (nn.modules.conv._ConvNd, nn.GroupNorm,
                             nn.LayerNorm, nn.InstanceNorm2d))
              and not isinstance(m, sharded)):
            raise TypeError(f"{name}: no width-sharded form of "
                            f"{type(m).__name__}")
    model.space = space
    return model
