"""Plain reference of DiffMVS / CasDiffMVS: forward (export and training
branches), loss, in float32 with no kernels, no batching tricks and no
sharding.

It follows the published model (arXiv:2509.15220, github.com/cvg/diffmvs)
as the port under test implements it, and holds the same state-dict key
names, so the benchmark hands one set of weights to both. It imports
torch, numpy and the standard library only: nothing of the program under
test and nothing of JAX.

Departures from a literal float32 reading of the published code, each
deliberate:
  * the weight-standardized convs' eps is the configuration's: the
    published rule is 1e-5 for a float32 input and 1e-3 for any other,
    so a configuration whose conv stacks compute in bfloat16 defines the
    model with 1e-3 (`ws_eps`). The reference computes that model in
    float32.
  * `fp8=True` (the control, never the reference) rounds the input and
    the weight of every conv and linear layer of the conv stacks to
    float8 e4m3 with one scale per tensor (amax to 448) and accumulates
    in float32: the step below the bfloat16 the configuration states.
    PixelViewWeight stays float32, as the configuration states it.

Noise: the caller draws it (draw_eval_noise / draw_train_noise) with a
torch.Generator seeded as the program's is; the draws follow the model's
order, so equal seeds give equal noise on one device.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

F8_MAX = 448.0


def _fp8(x):
    """x rounded to float8 e4m3 with a per-tensor scale, back in float32."""
    scale = F8_MAX / x.detach().abs().amax().clamp_min(1e-12)
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def _bf16(x):
    return x.to(torch.bfloat16).float()


# a conv stack's precision: how its operands are rounded, and whether its
# output is rounded to bfloat16 (the output of a bfloat16 or a float8
# convolution); the arithmetic is float32 throughout
PRECISIONS = {"float32": (None, False), "bfloat16": (_bf16, True),
              "float8": (_fp8, True)}


class _Quant:
    precision = "float32"

    def operands(self, x, w):
        rnd, _ = PRECISIONS[self.precision]
        x, w = x.float(), w.float()
        return (rnd(x), rnd(w)) if rnd else (x, w)

    def result(self, y):
        return _bf16(y) if PRECISIONS[self.precision][1] else y


class Conv2d(_Quant, nn.Conv2d):
    def forward(self, x):
        x, w = self.operands(x, self.weight)
        return self.result(self._conv_forward(x, w, self.bias))


class Conv3d(_Quant, nn.Conv3d):
    def forward(self, x):
        x, w = self.operands(x, self.weight)
        return self.result(self._conv_forward(x, w, self.bias))


class ConvTranspose3d(_Quant, nn.ConvTranspose3d):
    def forward(self, x):
        x, w = self.operands(x, self.weight)
        return self.result(F.conv_transpose3d(
            x, w, self.bias, self.stride, self.padding, self.output_padding,
            self.groups, self.dilation))


class Linear(_Quant, nn.Linear):
    def forward(self, x):
        x, w = self.operands(x, self.weight)
        return self.result(F.linear(x, w, self.bias))


def set_precision(model: nn.Module, precision: str):
    """Every conv and linear layer of the conv stacks (PixelViewWeight
    excepted, which the configurations state in float32) computes at
    `precision`, a key of PRECISIONS."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: one of {list(PRECISIONS)}")
    for name, mod in model.named_modules():
        if isinstance(mod, _Quant) and "pixel_view_weight" not in name:
            mod.precision = precision


class ConvBnAct(nn.Module):
    def __init__(self, ci, co, k=3, s=1, p=0, relu=True):
        super().__init__()
        self.conv = Conv2d(ci, co, k, stride=s, padding=p, bias=False)
        self.bn = nn.BatchNorm2d(co)
        self.relu = relu

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.relu else x


class Conv3dBnAct(nn.Module):
    def __init__(self, ci, co, k=3, s=1, p=1, deconv=False):
        super().__init__()
        self.conv = (ConvTranspose3d(ci, co, 3, stride=2, padding=1,
                                     output_padding=1, bias=False)
                     if deconv else
                     Conv3d(ci, co, k, stride=s, padding=p, bias=False))
        self.bn = nn.BatchNorm3d(co)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class ResidualBlock(nn.Module):
    def __init__(self, ci, co, stride=1):
        super().__init__()
        self.conv1 = ConvBnAct(ci, co, 3, stride, 1)
        self.conv2 = ConvBnAct(co, co, 3, 1, 1, relu=False)
        self.downsample = (ConvBnAct(ci, co, 3, stride, 1, relu=False)
                           if stride != 1 else None)

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class FeatureNet(nn.Module):
    def __init__(self, bc, out):
        super().__init__()
        specs = {0: [(3, bc, 3, 1, 1), (bc, bc, 3, 1, 1)]}
        for lvl in (1, 2, 3):
            ci, co = bc * 2 ** (lvl - 1), bc * 2 ** lvl
            specs[lvl] = [(ci, co, 5, 2, 2), (co, co, 3, 1, 1),
                          (co, co, 3, 1, 1)]
        for lvl, layers in specs.items():
            setattr(self, f"conv{lvl}", nn.Sequential(
                *[ConvBnAct(*spec) for spec in layers]))
        self.out1 = Conv2d(8 * bc, out[0], 1, bias=False)
        self.inner1 = Conv2d(4 * bc, 8 * bc, 1)
        self.out2 = Conv2d(8 * bc, out[1], 3, padding=1, bias=False)
        self.cascade = out[2] > 0
        if self.cascade:
            self.inner2 = Conv2d(2 * bc, 8 * bc, 1)
            self.out3 = Conv2d(8 * bc, out[2], 3, padding=1, bias=False)

    def forward(self, x):
        c1 = self.conv1(self.conv0(x))
        c2 = self.conv2(c1)
        c3 = self.conv3(c2)
        out = {"stage1": self.out1(c3)}
        intra = F.interpolate(c3, scale_factor=2.0) + self.inner1(c2)
        out["stage2"] = self.out2(intra)
        if self.cascade:
            intra = F.interpolate(intra, scale_factor=2.0) + self.inner2(c1)
            out["stage3"] = self.out3(intra)
        return out


class ContextNet(nn.Module):
    def __init__(self, out):
        super().__init__()
        self.conv1 = ConvBnAct(3, 8, 3, 1, 1)
        dims = [8, 16, 32, 48]
        for lvl in (1, 2, 3):
            setattr(self, f"layer{lvl}", nn.Sequential(
                ResidualBlock(dims[lvl - 1], dims[lvl], 2),
                ResidualBlock(dims[lvl], dims[lvl], 1)))
        self.output1 = Conv2d(48, out[0], 3, padding=1)
        self.output2 = Conv2d(32, out[1], 3, padding=1)
        self.cascade = out[2] > 0
        if self.cascade:
            self.output3 = Conv2d(16, out[2], 3, padding=1)

    def forward(self, x):
        ctx = {}
        x = self.layer1(self.conv1(x))
        if self.cascade:
            ctx["stage3"] = self.output3(x)
        x = self.layer2(x)
        ctx["stage2"] = self.output2(x)
        ctx["stage1"] = self.output1(self.layer3(x))
        return ctx


class CostRegNet(nn.Module):
    def __init__(self, g, bc=8):
        super().__init__()
        chans = [(g, bc, 1), (bc, bc, 1), (bc, 2 * bc, 2), (2 * bc, 2 * bc, 1),
                 (2 * bc, 4 * bc, 2), (4 * bc, 4 * bc, 1)]
        for i, (ci, co, s) in enumerate(chans):
            setattr(self, f"conv{i}", Conv3dBnAct(ci, co, 3, s, 1))
        self.conv6 = Conv3dBnAct(4 * bc, 2 * bc, deconv=True)
        self.conv7 = Conv3dBnAct(2 * bc, bc, deconv=True)
        self.prob = Conv3d(bc, 1, 3, padding=1, bias=False)

    def forward(self, x):
        c1 = self.conv1(self.conv0(x))
        c3 = self.conv3(self.conv2(c1))
        c5 = self.conv5(self.conv4(c3))
        x = c1 + self.conv7(c3 + self.conv6(c5))
        return self.prob(x)[:, 0]


class PixelViewWeight(nn.Module):
    def __init__(self, g):
        super().__init__()
        self.conv = nn.Sequential(Conv3dBnAct(g, 8), Conv3d(8, 1, 3, padding=1))

    def forward(self, cor):
        return torch.sigmoid(self.conv(cor)[:, 0]).amax(dim=1)


class MaskHead(nn.Sequential):
    def __init__(self, ci, ratio):
        super().__init__(Conv2d(ci, 64, 3, padding=1), nn.ReLU(),
                         Conv2d(64, ratio * ratio * 9, 1))

    def forward(self, x):
        return 0.25 * super().forward(x)


# ---- geometry: plane-sweep warp and group correlation ----

def relative_projection(src_pair, ref_pair):
    """(rot [B, 3, 3], trans [B, 3]) of src <- ref from (extrinsic,
    intrinsic) pairs [B, 2, 4, 4], in float64 (exact inverses)."""
    def compose(p):
        m = p[:, 0].double().clone()
        m[:, :3, :4] = p[:, 1, :3, :3].double() @ m[:, :3, :4]
        return m
    rel = compose(src_pair) @ torch.linalg.inv(compose(ref_pair))
    return rel[:, :3, :3], rel[:, :3, 3]


def warp_correlate(src, ref, src_pair, ref_pair, depth, groups):
    """src / ref [B, C, H, W]; depth [B, D, H, W] metric. Bilinear sample
    of src at the projection of every ref pixel and depth (zero outside
    the image, corner by corner), then the mean over each channel group
    of the products with ref. Returns [B, G, D, H, W]."""
    b, c, h, w = src.shape
    d = depth.shape[1]
    rot, trans = relative_projection(src_pair, ref_pair)
    ys, xs = torch.meshgrid(torch.arange(h, device=src.device),
                            torch.arange(w, device=src.device),
                            indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)]).double().reshape(3, -1)
    ray = rot @ pix                                        # [B, 3, HW]
    pts = (ray[:, :, None] * depth.double().reshape(b, 1, d, h * w)
           + trans[:, :, None, None])                      # [B, 3, D, HW]
    z = torch.where(pts[:, 2] == 0, torch.full_like(pts[:, 2], 1e-8),
                    pts[:, 2])
    x, y = (pts[:, 0] / z).float(), (pts[:, 1] / z).float()
    x = torch.where(torch.isfinite(x), x, torch.full_like(x, -2.0))
    y = torch.where(torch.isfinite(y), y, torch.full_like(y, -2.0))
    x, y = x.clamp(-2.0, float(w)), y.clamp(-2.0, float(h))
    x0, y0 = x.floor(), y.floor()
    fx, fy = (x - x0)[:, None], (y - y0)[:, None]
    flat = src.float().reshape(b, c, h * w)

    def corner(xi, yi):
        ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
        vals = torch.gather(flat, 2, idx.reshape(b, 1, -1).expand(b, c, -1))
        return vals.reshape(b, c, d, h * w) * ok[:, None]

    top = corner(x0, y0) * (1 - fx) + corner(x0 + 1, y0) * fx
    bot = corner(x0, y0 + 1) * (1 - fx) + corner(x0 + 1, y0 + 1) * fx
    warped = top * (1 - fy) + bot * fy                     # [B, C, D, HW]
    prod = warped * ref.float().reshape(b, c, 1, h * w)
    return prod.reshape(b, groups, c // groups, d, h, w).mean(2)


def aggregate(cors, weights):
    """cors: V-1 of [B, G, D, H, W]; weights: V-1 of [B, H, W]."""
    num = sum(c * wt[:, None, None] for c, wt in zip(cors, weights))
    return num / (sum(weights)[:, None, None] + 1e-8)


def soft_argmax(logits):
    """[B, D, H, W] -> (normalized inverse depth, photometric confidence:
    the mass of the 4 bins around the expected index)."""
    d = logits.shape[1]
    prob = logits.float().softmax(1)
    idx = torch.arange(d, device=prob.device, dtype=prob.dtype)
    index = (prob * idx.reshape(1, d, 1, 1)).sum(1)
    with torch.no_grad():
        i0 = index.long().clamp(0, d - 1)
        csum = F.pad(prob.cumsum(1), (0, 0, 0, 0, 1, 0))   # csum[k] = sum<k
        hi = csum.gather(1, ((i0 + 2).clamp(max=d - 1) + 1)[:, None])[:, 0]
        lo = csum.gather(1, (i0 - 2).clamp(min=-1)[:, None] + 1)[:, 0]
        conf = hi - lo
    return index / (d - 1.0), conf


def convex_upsample(x, mask, r):
    """x [B, H, W]; mask logits [B, 9*r*r, H, W] -> [B, H*r, W*r]."""
    b, h, w = x.shape
    m = mask.float().reshape(b, 9, r * r, h, w).softmax(1)
    patches = F.unfold(x[:, None], 3, padding=1).reshape(b, 9, 1, h, w)
    up = (m * patches).sum(1).reshape(b, r, r, h, w)
    return up.permute(0, 3, 1, 4, 2).reshape(b, h * r, w * r)


def up_nearest(x, s):
    return x.repeat_interleave(s, -2).repeat_interleave(s, -1)


# ---- diffusion refinement ----

def cosine_alphas_cumprod(timesteps, s=0.008):
    """float64 cumulative alphas of the cosine schedule (betas clipped to
    0.999 and rounded to float32, as published)."""
    x = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64)
    ac = np.cos(((x / timesteps) + s) / (1 + s) * np.pi * 0.5) ** 2
    ac = ac / ac[0]
    betas = np.clip(1 - ac[1:] / ac[:-1], 0, 0.999).astype(np.float32)
    return np.cumprod(1.0 - betas.astype(np.float64))


class Block(nn.Module):
    def __init__(self, ci, co, groups, ws_eps):
        super().__init__()
        self.proj = Conv2d(ci, co, 3, padding=1)
        self.norm = nn.GroupNorm(groups, co)
        self.ws_eps = ws_eps

    def forward(self, x, ss=None):
        w = self.proj.weight
        w = (w - w.mean((1, 2, 3), keepdim=True)) * torch.rsqrt(
            w.var((1, 2, 3), unbiased=False, keepdim=True) + self.ws_eps)
        x, w = self.proj.operands(x, w)
        x = self.norm(self.proj.result(F.conv2d(x, w, self.proj.bias,
                                                padding=1)))
        if ss is not None:
            x = x * (ss[0] + 1.0) + ss[1]
        return F.silu(x)


class ResnetBlock(nn.Module):
    def __init__(self, ci, co, tdim, groups, ws_eps):
        super().__init__()
        self.mlp = (nn.Sequential(nn.SiLU(), Linear(tdim, co * 2))
                    if tdim else None)
        self.block1 = Block(ci, co, groups, ws_eps)
        self.block2 = Block(co, co, groups, ws_eps)
        self.res_conv = Conv2d(ci, co, 1) if ci != co else nn.Identity()

    def forward(self, x, temb=None):
        ss = None
        if self.mlp is not None and temb is not None:
            ss = self.mlp(temb)[:, :, None, None].chunk(2, 1)
        return self.block2(self.block1(x, ss)) + self.res_conv(x)


class SepConvGRU(nn.Module):
    def __init__(self, hd, xd):
        super().__init__()
        for tag, k, p in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for gate in "zrq":
                setattr(self, f"conv{gate}{tag}",
                        Conv2d(hd + xd, hd, k, padding=p))

    def forward(self, h, x):
        for tag in "12":
            hx = torch.cat([h, x], 1)
            z = torch.sigmoid(getattr(self, f"convz{tag}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{tag}")(hx))
            q = torch.tanh(getattr(self, f"convq{tag}")(
                torch.cat([r * h, x], 1)))
            h = (1 - z) * h + z * q
        return h


class TimeEmb(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.dim = dim

    def forward(self, t):
        half = self.dim // 2
        f = torch.exp(torch.arange(half, device=t.device, dtype=torch.float32)
                      * (-math.log(10000.0) / (half - 1)))
        a = t.float()[:, None] * f[None]
        return torch.cat([a.sin(), a.cos()], -1)


class UNet(nn.Module):
    def __init__(self, dim, hd, ind, mults, ws_eps, g=4):
        super().__init__()
        dims = [dim] + [dim * m for m in mults]
        io = list(zip(dims[:-1], dims[1:]))
        td = dim * 4
        self.init_conv = Conv2d(ind, dim, 7, padding=3)
        self.time_mlp = nn.Sequential(TimeEmb(dim), Linear(dim, td),
                                      nn.GELU(), Linear(td, td))
        self.downs = nn.ModuleList()
        for i, (a, b) in enumerate(io):
            down = (Conv2d(a, b, 3, padding=1) if i == len(io) - 1 else
                    nn.Sequential(nn.PixelUnshuffle(2), Conv2d(a * 4, b, 1)))
            self.downs.append(nn.ModuleList(
                [ResnetBlock(a, a, td, g, ws_eps), down]))
        self.gru = SepConvGRU(hd, dims[-1])
        self.mid = ResnetBlock(hd, dims[-1], None, g, ws_eps)
        self.ups = nn.ModuleList()
        for i, (a, b) in enumerate(reversed(io)):
            up = (Conv2d(b, a, 3, padding=1) if i == len(io) - 1 else
                  nn.Sequential(nn.Upsample(scale_factor=2.0),
                                Conv2d(b, a, 3, padding=1)))
            self.ups.append(nn.ModuleList(
                [ResnetBlock(b + a, b, td, g, ws_eps), up]))
        self.final_res_block = ResnetBlock(dim * 2, dim, td, g, ws_eps)
        self.final_conv = Conv2d(dim, 1, 1)
        self.conf = Conv2d(dim, 1, 1)

    def forward(self, x, hidden, t):
        temb = self.time_mlp(t)
        x = r = self.init_conv(x)
        skips = []
        for block, down in self.downs:
            x = block(x, temb)
            skips.append(x)
            x = down(x)
        hidden = self.gru(hidden, x)
        x = self.mid(hidden)
        for block, up in self.ups:
            x = up(block(torch.cat([x, skips.pop()], 1), temb))
        x = self.final_res_block(torch.cat([x, r], 1), temb)
        return hidden, self.final_conv(x)[:, 0], torch.sigmoid(
            self.conf(x)[:, 0])


class Encoder(nn.Module):
    def __init__(self, cost_dim, ns, hd, out):
        super().__init__()
        self.convc1 = Conv2d(cost_dim, hd, 3, padding=1)
        self.convc2 = Conv2d(hd, hd, 3, padding=1)
        self.convd1 = Conv2d(ns, hd, 3, padding=1)
        self.convd2 = Conv2d(hd, hd, 3, padding=1)
        self.output = Conv2d(2 * hd, out - 1, 3, padding=1)

    def forward(self, depth, samples, cost):
        c = F.relu(self.convc2(F.relu(self.convc1(cost))))
        d = F.relu(self.convd2(F.relu(self.convd1(samples))))
        out = F.relu(self.output(torch.cat([c, d], 1)))
        return torch.cat([out, depth], 1)


class Refinement(nn.Module):
    """One refinement stage (its iterations, DDIM or the training
    branch)."""

    def __init__(self, cfg, s, ws_eps):
        super().__init__()
        ns, g = cfg["cost_num"][s], cfg["cost_dim_stage"][s]
        self.ns, self.g, self.iters = ns, g, cfg["stage_iters"][s]
        self.interval = cfg["depth_intervals_ratio"][s] / cfg["numdepth"]
        self.rmin, self.rmax = cfg["min_radius"], cfg["max_radius"]
        self.scale, self.eta = cfg["scale"][s], cfg["ddim_eta"][s]
        self.timesteps = cfg["timesteps"][s]
        self.sampling = cfg["sampling_timesteps"][s]
        cd = cfg["context_dim"][s]
        self.encoder = Encoder(g * ns, ns, cd, cd)
        self.unet = UNet(cfg["unet_dim"][s], cfg["hidden_dim"][s], 2 * cd,
                         UNET_MULTS[s], ws_eps)
        self.mask = MaskHead(cd, 2 if cfg["stage_iters"][2] else 4)

    def iterate(self, hidden, inv, delta, conf, use_conf, ctx, t, inv0, feats,
                projs, dmin, dmax, vws):
        inv, delta, conf = inv.detach(), delta.detach(), conf.detach()
        r0 = (self.ns // 2) * self.interval
        lo_r, hi_r = self.rmin * r0, self.rmax * r0
        radius = lo_r + (1.0 - conf) * (hi_r - lo_r) if use_conf else r0
        lo, hi = inv - radius, inv + radius
        k = torch.arange(self.ns, device=inv.device, dtype=inv.dtype)
        samples = (lo[:, None] + k.reshape(1, -1, 1, 1)
                   * ((hi - lo) / (self.ns - 1))[:, None]).clamp(0, 1)
        dmin, dmax = dmin[:, None], dmax[:, None]          # [B, 1, 1, 1]
        depth = 1.0 / (1 / dmax + (1 / dmin - 1 / dmax) * samples).clamp_min(
            1e-6)
        cors = [warp_correlate(f, feats[0], projs[:, i + 1], projs[:, 0],
                               depth, self.g)
                for i, f in enumerate(feats[1:])]
        agg = aggregate(cors, vws)                         # [B, G, D, H, W]
        b, _, _, h, w = agg.shape
        cost = agg.reshape(b, -1, h, w)
        x = torch.cat([ctx, self.encoder(inv[:, None], samples, cost)], 1)
        hidden, upd, conf = self.unet(x, hidden, t)
        inv_new = (inv0 + (delta + upd)).clamp(0, 1)
        return hidden, inv_new, inv_new - inv0, conf

    def forward(self, inv0, hidden, ctx, feats, projs, dmin, dmax, vws,
                noise, t=None, gt=None):
        """noise: the stage's draws ([B, H, W] each, scale applied); t and
        gt (normalized inverse GT) select the training branch."""
        ac = cosine_alphas_cumprod(self.timesteps)
        args = (ctx,)
        seq = []
        if gt is not None:
            a = torch.from_numpy(np.sqrt(ac).astype(np.float32)).to(t.device)
            o = torch.from_numpy(np.sqrt(1 - ac).astype(np.float32)).to(
                t.device)
            gd = (gt - inv0).detach()
            delta = a[t][:, None, None] * gd + o[t][:, None, None] * noise[0]
            inv = (inv0 + delta).clamp(0, 1)
            delta, conf, h = inv - inv0, torch.zeros_like(inv0), hidden
            for i in range(self.iters):
                h, inv, delta, conf = self.iterate(
                    h, inv, delta, conf, i > 0, *args, t, inv0, feats, projs,
                    dmin, dmax, vws)
                seq.append((inv, conf))
            return self.mask(ctx), seq
        times = np.linspace(-1, self.timesteps - 1, self.sampling + 1)
        times = list(reversed(times.astype(int).tolist()))
        img, draws = noise[0], iter(noise[1:])
        for time, tnext in zip(times[:-1], times[1:]):
            tt = torch.full((inv0.shape[0],), time, device=inv0.device)
            inv = (inv0 + img).clamp(0, 1)
            delta = img = inv - inv0
            conf, h, seq = torch.zeros_like(inv0), hidden, []
            for i in range(self.iters):
                h, inv, delta, conf = self.iterate(
                    h, inv, delta, conf, i > 0, *args, tt, inv0, feats, projs,
                    dmin, dmax, vws)
                seq.append((inv, conf))
            if tnext < 0:
                continue
            a, an = ac[time], ac[tnext]
            eps = ((np.float32(np.sqrt(1 / a)) * img - delta)
                   / np.float32(np.sqrt(1 / a - 1)))
            sigma = self.eta * np.sqrt((1 - a / an) * (1 - an) / (1 - a))
            c = np.sqrt(1 - an - sigma ** 2)
            img = (delta * float(np.float32(np.sqrt(an))) + float(
                np.float32(c)) * eps + float(np.float32(sigma)) * next(draws))
        return self.mask(ctx), seq


UNET_MULTS = {1: (1, 2), 2: (1, 2, 4)}


class HiddenInit(nn.Sequential):
    def __init__(self, hd, num_down):
        super().__init__(*[ConvBnAct(hd if i == 0 else 32, 32, 3, 2, 1)
                           for i in range(num_down)],
                         Conv2d(32, hd, 3, padding=1, bias=False))


class Reference(nn.Module):
    """The whole model. cfg: the configuration file's "model" dict."""

    def __init__(self, cfg: Dict, ws_eps: float):
        super().__init__()
        self.cfg = cfg
        cas = cfg["stage_iters"][2] > 0
        bc = cfg["base_channels"]
        ctx_out = [h + c for h, c in zip(cfg["hidden_dim"],
                                         cfg["context_dim"])]
        self.feature = FeatureNet(bc, (48, 32, 16) if cas else (48, 32, 0))
        self.context = ContextNet(ctx_out)
        self.depthnet = nn.Module()
        g0 = cfg["cost_dim_stage"][0]
        self.depthnet.pixel_view_weight = PixelViewWeight(g0)
        self.depthnet.cost_regularization = CostRegNet(g0)
        self.depthnet.mask = MaskHead(ctx_out[0], 2)
        inits = []
        for s in (1, 2):
            if cfg["stage_iters"][s]:
                inits.append(HiddenInit(cfg["hidden_dim"][s], s))
                setattr(self, f"update_block_depth{s + 1}",
                        Refinement(cfg, s, ws_eps))
        self.hidden_init = nn.ModuleList(inits)

    def stages(self):
        return [s for s in (1, 2) if self.cfg["stage_iters"][s]]

    def forward(self, imgs, projs, depth_values, noise, t=None, gt=None):
        """imgs [B, V, H, W, 3] in [0, 1]; projs {stage1..4: [B, V, 2, 4,
        4]}; depth_values [B, ND]; noise {stage: [draws]} (draw_*_noise);
        t {stage: [B]} and gt {stage1..4: [B, Hs, Ws] metric} for the
        training branch. Returns {"depth": [...], "conf": [...],
        "photometric_confidence": [...]}: with gt, every depth and
        iteration confidence the loss reads; without, the export outputs
        (final depth, full-resolution confidences)."""
        cfg = self.cfg
        train = gt is not None
        b, v, hh, ww, _ = imgs.shape
        dmax = (1.0 / depth_values[:, 0].float()).reshape(b, 1, 1)
        dmin = (1.0 / depth_values[:, -1].float()).reshape(b, 1, 1)

        def to_depth(n):
            return 1.0 / (1 / dmax + (1 / dmin - 1 / dmax) * n).clamp_min(1e-6)

        def to_disp(d):
            return (1.0 / d - 1 / dmax) / (1 / dmin - 1 / dmax)

        x = imgs.float().permute(0, 1, 4, 2, 3)
        fm = self.feature(x.reshape(b * v, 3, hh, ww))
        feats = {k: list(f.reshape(b, v, *f.shape[1:]).unbind(1))
                 for k, f in fm.items()}
        ctxs = self.context(x[:, 0])

        # stage 0: the plane sweep at 1/8 resolution
        f0, p0 = feats["stage1"], projs["stage1"].float()
        h, w = f0[0].shape[-2:]
        nd = cfg["numdepth_initial"]
        dmin4, dmax4 = dmin[:, :, :, None], dmax[:, :, :, None]
        hyp = 1.0 / (1 / dmax4 + (1 / dmin4 - 1 / dmax4) * (
            torch.arange(nd, device=x.device, dtype=torch.float32)
            / (nd - 1.0)).reshape(1, nd, 1, 1)).clamp_min(1e-6)
        hyp = hyp.expand(b, nd, h, w)
        cors = [warp_correlate(f, f0[0], p0[:, i + 1], p0[:, 0], hyp,
                               cfg["cost_dim_stage"][0])
                for i, f in enumerate(f0[1:])]
        dn = self.depthnet
        vws = [dn.pixel_view_weight(c) for c in cors]
        inv, conf = soft_argmax(dn.cost_regularization(aggregate(cors, vws)))
        mask = dn.mask(F.relu(ctxs["stage1"]))
        depths = [to_depth(inv)]
        confs, photo = [], [up_nearest(conf, 8)]
        depths.append(to_depth(convex_upsample(inv, mask, 2)))

        for k, s in enumerate(self.stages()):
            key = f"stage{s + 1}"
            hd = cfg["hidden_dim"][s]
            inv0 = to_disp(depths[-1].detach())
            vw = [up_nearest(v_.detach(), 2 ** s) for v_ in vws]
            ctx = ctxs[key]
            hidden = torch.tanh(self.hidden_init[k](ctx[:, :hd]))
            block = getattr(self, f"update_block_depth{s + 1}")
            gt_inv = None
            if train:
                init = to_disp(up_nearest(depths[0], 2 ** s)).detach()
                gt_inv = to_disp(gt[key])
                gt_inv = torch.where(torch.isinf(gt_inv), init, gt_inv)
            mask, seq = block(inv0, hidden, F.relu(ctx[:, hd:]), feats[key],
                              projs[key].float(), dmin, dmax, vw, noise[s],
                              None if t is None else t[s], gt_inv)
            if train:
                depths += [to_depth(i) for i, _ in seq]
                confs += [c for _, c in seq]
            else:
                depths.append(to_depth(seq[-1][0]))
                photo.append(up_nearest(seq[-1][1], 2 ** (3 - s)))
            depths.append(to_depth(convex_upsample(
                seq[-1][0], mask, 2 if cfg["stage_iters"][2] else 4)))
        return {"depth": depths, "conf": confs,
                "photometric_confidence": photo}


def draw_eval_noise(cfg: Dict, b: int, h: int, w: int,
                    generator: torch.Generator) -> Dict[int, List]:
    """{stage: [draws]} of DDIM inference on b images of h x w, in the
    model's order: per refinement stage its start, then one per further
    time pair; [B, Hs, Ws] zeros, and no draw, where the scale is 0."""
    out = {}
    for s in (1, 2):
        if not cfg["stage_iters"][s]:
            continue
        shape = (b, h // 2 ** (3 - s), w // 2 ** (3 - s))
        scale = cfg["scale"][s]
        n = cfg["sampling_timesteps"][s]
        out[s] = [scale * torch.randn(shape, generator=generator,
                                      device=generator.device)
                  if scale else torch.zeros(shape, device=generator.device)
                  for _ in range(n)]
    return out


def draw_train_noise(cfg: Dict, b: int, h: int, w: int,
                     generator: torch.Generator):
    """({stage: t [B]}, {stage: [noise [B, Hs, Ws]]}) of the training
    branch, in the model's order: per stage the timesteps, then the
    noise (zeros, and no draw, where the scale is 0)."""
    ts, noise = {}, {}
    dev = generator.device
    for s in (1, 2):
        if not cfg["stage_iters"][s]:
            continue
        shape = (b, h // 2 ** (3 - s), w // 2 ** (3 - s))
        ts[s] = torch.randint(0, cfg["timesteps"][s], (b,),
                              generator=generator, device=dev)
        scale = cfg["scale"][s]
        noise[s] = [scale * torch.randn(shape, generator=generator,
                                        device=dev)
                    if scale else torch.zeros(shape, device=dev)]
    return ts, noise


def loss_layout(stage_iters: Sequence[int]):
    """Per prediction: (its GT stage, whether it carries a confidence)."""
    i0, i1, i2 = stage_iters
    out = [(1, False)] * i0 + [(2, False)]
    out += [(2, True)] * i1
    if i2:
        out += [(3, False)] + [(3, True)] * i2
    return out + [(4, False)]


def loss(out, gt, mask, depth_values, stage_iters, rate=0.9, conf_w=0.05):
    """The published loss: per prediction the masked mean of |error| in
    normalized inverse depth (|e| / (1 - c) + conf_w log(1 - c) where a
    confidence c comes with it), weighted rate^(n - i - 1)."""
    b = depth_values.shape[0]
    dmax = (1.0 / depth_values[:, 0]).reshape(b, 1, 1)
    dmin = (1.0 / depth_values[:, -1]).reshape(b, 1, 1)

    def to_disp(d):
        return (1.0 / d - 1 / dmax) / (1 / dmin - 1 / dmax)

    layout = loss_layout(stage_iters)
    total, confs = 0.0, iter(out["conf"])
    n = len(layout)
    for i, ((s, has_conf), est) in enumerate(zip(layout, out["depth"])):
        g = gt[f"stage{s}"]
        g = to_disp(torch.where(g > 1e-4, g, dmax.expand_as(g)))
        m = (mask[f"stage{s}"] > 0.5).float()
        err = (to_disp(est) - g).abs()
        if has_conf:
            u = (1.0 - next(confs)).clamp_min(1e-6)
            err = err / u + conf_w * torch.log(u)
        total = total + rate ** (n - i - 1) * (err * m).sum() / m.sum(
        ).clamp_min(1.0)
    return total
