"""Carry weights from the JAX package into the port.

`state_dict_from_jax(variables, cfg)` takes the JAX package's
{"params", "batch_stats"} tree (nested dicts of arrays) and returns the
port's state_dict under the reference's key names. It is the inverse of
the JAX package's torch-checkpoint importer:
  * conv kernels HWIO -> OIHW, DHWIO -> OIDHW;
  * the transposed-conv kernel: the JAX side stores the equivalent forward
    conv over the dilated input (IO-swapped, spatially flipped taps), so
    it is flipped back to ConvTranspose3d's [I, O, kd, kh, kw];
  * dense [I, O] -> Linear [O, I];
  * BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var
    (+ num_batches_tracked = 0), GroupNorm scale/bias -> weight/bias.

`optimizer_state_from_jax(opt_state, cfg, model, optimizer)` carries the
JAX package's optax state (train/state.py: clip_by_global_norm, then
adamw) into torch.optim.AdamW's: each parameter's first and second
moments (mu, nu -> exp_avg, exp_avg_sq) through the same block map and
layout transforms as the parameter itself, and the update count (count ->
step).

Only numpy and torch are imported. The block functions are public so
tests can carry one block's weights at a time (tkey "" = no prefix); a
module tree other than CasDiffMVS's passes its own block map as `emit`.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch


def _j(*parts: str) -> str:
    return ".".join(p for p in parts if p)


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)).copy())


class Emitter:
    """Reads JAX variables by path, writes torch tensors by key.
    params_only: emit the parameters alone (a tree shaped like params,
    e.g. an optimizer moment), without the BatchNorm buffers. strict=False
    skips each tensor whose path the variables lack (a partial
    checkpoint); `used` collects the paths read, so the caller can name
    the variables no tensor took."""

    def __init__(self, variables: Dict, params_only: bool = False,
                 strict: bool = True):
        self.params = variables["params"]
        self.stats = variables.get("batch_stats", {})
        self.params_only = params_only
        self.strict = strict
        self.used = set()
        self.sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def _get(self, col: str, path: Tuple[str, ...]):
        """The array at `path` of "params" or "batch_stats" (None if it is
        missing and strict is off)."""
        node = self.params if col == "params" else self.stats
        for k in path:
            if not self.strict and (not isinstance(node, dict)
                                    or k not in node):
                return None
            node = node[k]
        self.used.add((col,) + path)
        return np.asarray(node)

    def _put(self, key: str, col: str, path, fn=lambda a: a):
        a = self._get(col, path)
        if a is not None:
            self.sd[key] = _tensor(fn(a))

    def _has(self, path: Tuple[str, ...]) -> bool:
        node = self.params
        for k in path:
            if not isinstance(node, dict) or k not in node:
                return False
            node = node[k]
        return True

    def _bias(self, tkey, path):
        if self._has(path + ("bias",)):
            self._put(_j(tkey, "bias"), "params", path + ("bias",))

    def conv2d(self, tkey: str, *path: str):
        self._put(_j(tkey, "weight"), "params", path + ("kernel",),
                  lambda k: np.transpose(k, (3, 2, 0, 1)))
        self._bias(tkey, path)

    def conv3d(self, tkey: str, *path: str):
        self._put(_j(tkey, "weight"), "params", path + ("kernel",),
                  lambda k: np.transpose(k, (4, 3, 0, 1, 2)))
        self._bias(tkey, path)

    def deconv3d(self, tkey: str, *path: str):
        self._put(_j(tkey, "weight"), "params", path + ("kernel",),
                  lambda k: np.transpose(k, (3, 4, 0, 1, 2))
                  [:, :, ::-1, ::-1, ::-1])

    def linear(self, tkey: str, *path: str):
        self._put(_j(tkey, "weight"), "params", path + ("kernel",),
                  lambda k: k.T)
        self._bias(tkey, path)

    def bn(self, tkey: str, *path: str):
        self._put(_j(tkey, "weight"), "params", path + ("scale",))
        self._put(_j(tkey, "bias"), "params", path + ("bias",))
        if self.params_only:
            return
        self._put(_j(tkey, "running_mean"), "batch_stats", path + ("mean",))
        self._put(_j(tkey, "running_var"), "batch_stats", path + ("var",))
        if _j(tkey, "running_mean") in self.sd:
            self.sd[_j(tkey, "num_batches_tracked")] = torch.tensor(0)

    def groupnorm(self, tkey: str, *path: str):
        self._put(_j(tkey, "weight"), "params", path + ("scale",))
        self._put(_j(tkey, "bias"), "params", path + ("bias",))

    def conv_bn(self, tkey: str, *path: str):
        """A .conv + .bn wrapper (2D or 3D by kernel rank)."""
        k = self._get("params", path + ("conv", "kernel"))
        if k is not None:
            conv = self.conv2d if k.ndim == 4 else self.conv3d
            conv(_j(tkey, "conv"), *path, "conv")
        self.bn(_j(tkey, "bn"), *path, "bn")

    def unused(self):
        """The leaf paths of the variables that no tensor took."""
        out = []
        for col, tree in (("params", self.params),
                          ("batch_stats", self.stats)):
            if col == "batch_stats" and self.params_only:
                continue
            out += [(col,) + p for p in _leaf_paths(tree)
                    if (col,) + p not in self.used]
        return out


def _leaf_paths(tree, path=()):
    if not isinstance(tree, dict):
        return [path]
    return [p for k, v in tree.items() for p in _leaf_paths(v, path + (k,))]


# ---------------------------------------------------------------------------
# block maps (reference key <- JAX path)
# ---------------------------------------------------------------------------

def featurenet(e: Emitter, cascade: bool, tkey="feature", path=("feature",)):
    for lvl, n in {0: 2, 1: 3, 2: 3, 3: 3}.items():
        for j in range(n):
            e.conv_bn(_j(tkey, f"conv{lvl}.{j}"), *path, f"conv{lvl}_{j}")
    heads = ["out1", "inner1", "out2"] + (["inner2", "out3"] if cascade
                                          else [])
    for name in heads:
        e.conv2d(_j(tkey, name), *path, name)


def residual_block(e: Emitter, tkey: str, *path: str, downsample: bool):
    names = ["conv1", "conv2"] + (["downsample"] if downsample else [])
    for name in names:
        e.conv_bn(_j(tkey, name), *path, name)


def contextnet(e: Emitter, cascade: bool, tkey="context", path=("context",)):
    e.conv_bn(_j(tkey, "conv1"), *path, "conv1")
    for lvl in (1, 2, 3):
        residual_block(e, _j(tkey, f"layer{lvl}.0"), *path, f"layer{lvl}_0",
                       downsample=True)
        residual_block(e, _j(tkey, f"layer{lvl}.1"), *path, f"layer{lvl}_1",
                       downsample=False)
    for name in ["output1", "output2"] + (["output3"] if cascade else []):
        e.conv2d(_j(tkey, name), *path, name)


def costreg(e: Emitter, tkey: str, *path: str):
    for i in range(6):
        e.conv_bn(_j(tkey, f"conv{i}"), *path, f"conv{i}")
    for i in (6, 7):
        e.deconv3d(_j(tkey, f"conv{i}.conv"), *path, f"conv{i}")
        e.bn(_j(tkey, f"conv{i}.bn"), *path, f"conv{i}", "bn")
    e.conv3d(_j(tkey, "prob"), *path, "prob")


def pixel_view_weight(e: Emitter, tkey: str, *path: str):
    e.conv_bn(_j(tkey, "conv.0"), *path, "conv0")
    e.conv3d(_j(tkey, "conv.1"), *path, "conv1")


def mask_head(e: Emitter, tkey: str, *path: str):
    e.conv2d(_j(tkey, "0"), *path, "conv1")
    e.conv2d(_j(tkey, "2"), *path, "conv2")


def gru(e: Emitter, tkey: str, *path: str):
    for name in ("convz1", "convr1", "convq1", "convz2", "convr2", "convq2"):
        e.conv2d(_j(tkey, name), *path, name)


def resnet_block(e: Emitter, tkey: str, *path: str, time_mlp: bool,
                 res_conv: bool):
    if time_mlp:
        e.linear(_j(tkey, "mlp.1"), *path, "mlp", "linear")
    for b in ("block1", "block2"):
        e.conv2d(_j(tkey, b, "proj"), *path, b, "proj")
        e.groupnorm(_j(tkey, b, "norm"), *path, b, "norm")
    if res_conv:
        e.conv2d(_j(tkey, "res_conv"), *path, "res_conv")


def unet(e: Emitter, tkey: str, path: Tuple[str, ...], dim: int,
         hidden_dim: int, dim_mults):
    dims = [dim] + [dim * m for m in dim_mults]
    in_out = list(zip(dims[:-1], dims[1:]))
    e.conv2d(_j(tkey, "init_conv"), *path, "init_conv")
    e.linear(_j(tkey, "time_mlp.1"), *path, "time_mlp_1", "linear")
    e.linear(_j(tkey, "time_mlp.3"), *path, "time_mlp_2", "linear")
    for ind in range(len(in_out)):
        is_last = ind >= len(in_out) - 1
        resnet_block(e, _j(tkey, f"downs.{ind}.0"), *path,
                     f"down_{ind}_block", time_mlp=True, res_conv=False)
        if is_last:
            e.conv2d(_j(tkey, f"downs.{ind}.1"), *path, f"down_{ind}_conv")
        else:
            e.conv2d(_j(tkey, f"downs.{ind}.1.1"), *path, f"down_{ind}_ds",
                     "conv")
    gru(e, _j(tkey, "gru"), *path, "gru")
    resnet_block(e, _j(tkey, "mid"), *path, "mid", time_mlp=False,
                 res_conv=hidden_dim != dims[-1])
    for ind in range(len(in_out)):
        is_last = ind == len(in_out) - 1
        resnet_block(e, _j(tkey, f"ups.{ind}.0"), *path, f"up_{ind}_block",
                     time_mlp=True, res_conv=True)
        if is_last:
            e.conv2d(_j(tkey, f"ups.{ind}.1"), *path, f"up_{ind}_conv")
        else:
            e.conv2d(_j(tkey, f"ups.{ind}.1.1"), *path, f"up_{ind}_us",
                     "conv")
    resnet_block(e, _j(tkey, "final_res_block"), *path, "final_res_block",
                 time_mlp=True, res_conv=True)
    e.conv2d(_j(tkey, "final_conv"), *path, "final_conv")
    e.conv2d(_j(tkey, "conf"), *path, "conf")


def condition_encoder(e: Emitter, tkey: str, *path: str):
    for name in ("convc1", "convc2", "convd1", "convd2", "output"):
        e.conv2d(_j(tkey, name), *path, name)


def emit_casdiffmvs(e: Emitter, cfg):
    """The block map of CasDiffMVS(cfg) (both variants)."""
    cascade = cfg.is_cascade
    featurenet(e, cascade)
    contextnet(e, cascade)
    pixel_view_weight(e, "depthnet.pixel_view_weight", "depthnet",
                      "pixel_view_weight")
    costreg(e, "depthnet.cost_regularization", "depthnet",
            "cost_regularization")
    mask_head(e, "depthnet.mask", "depthnet", "mask")

    e.conv_bn("hidden_init.0.0", "hidden_init1", "down0")
    e.conv2d("hidden_init.0.1", "hidden_init1", "out")
    if cascade:
        e.conv_bn("hidden_init.1.0", "hidden_init2", "down0")
        e.conv_bn("hidden_init.1.1", "hidden_init2", "down1")
        e.conv2d("hidden_init.1.2", "hidden_init2", "out")

    for s in (1, 2):
        if cfg.stage_iters[s] == 0:
            continue
        tkey, path = f"update_block_depth{s + 1}", (f"update_block{s}",)
        condition_encoder(e, _j(tkey, "encoder"), *path, "cell", "encoder")
        mask_head(e, _j(tkey, "mask"), *path, "mask")
        unet(e, _j(tkey, "unet"), path + ("cell", "unet"), cfg.unet_dim[s],
             cfg.hidden_dim[s], cfg.unet_dim_mults[s])


def _block_map(cfg, emit):
    return emit if emit is not None else (lambda e: emit_casdiffmvs(e, cfg))


def state_dict_from_jax(variables: Dict, cfg,
                        emit: Optional[Callable[[Emitter], None]] = None
                        ) -> "OrderedDict[str, torch.Tensor]":
    """The port's state_dict for CasDiffMVS(cfg) from JAX variables (or,
    with `emit`, for the module tree that block map describes)."""
    e = Emitter(variables)
    _block_map(cfg, emit)(e)
    return e.sd


def partial_state_dict_from_jax(
        variables: Dict, cfg,
        emit: Optional[Callable[[Emitter], None]] = None
) -> Tuple["OrderedDict[str, torch.Tensor]", list]:
    """state_dict_from_jax over variables that may lack some of the
    model's tensors and hold others (DiffMVS weights for a CasDiffMVS
    finetune): (the tensors found, the leaf paths of the variables that no
    tensor took)."""
    e = Emitter(variables, strict=False)
    _block_map(cfg, emit)(e)
    return e.sd, e.unused()


def _find_states(node, path=()):
    """(key path, node) of every dict in an optax state tree (orbax gives
    its namedtuples back as dicts, its tuples as lists)."""
    if isinstance(node, dict):
        yield path, node
        items = node.items()
    elif isinstance(node, (list, tuple)):
        items = enumerate(node)
    else:
        return
    for k, v in items:
        yield from _find_states(v, path + (str(k),))


def adam_state(opt_state) -> Tuple[Dict, Dict, int, int]:
    """(mu, nu, Adam's count, the schedule's count) of the JAX package's
    optax chain (clip_by_global_norm, then adamw with a schedule), found
    by their names: the one state holding "mu", "nu" and "count" (optax's
    ScaleByAdamState) and the one holding "count" alone
    (ScaleByScheduleState). Raises ValueError naming what differs."""
    adam, sched = [], []
    for path, node in _find_states(opt_state, ("opt_state",)):
        if {"mu", "nu", "count"} <= set(node):
            adam.append((path, node))
        elif set(node) == {"count"}:
            sched.append((path, node))
    if len(adam) != 1:
        raise ValueError(
            f"opt_state: {len(adam)} states hold mu, nu and count "
            f"({[p for p, _ in adam]}); the JAX package's optimizer "
            f"(clip_by_global_norm, then adamw) has one")
    if len(sched) != 1:
        raise ValueError(
            f"opt_state: {len(sched)} states hold a count alone "
            f"({[p for p, _ in sched]}); adamw's learning-rate schedule "
            f"has one")
    (_, a), (_, s) = adam[0], sched[0]
    return a["mu"], a["nu"], int(np.asarray(a["count"])), \
        int(np.asarray(s["count"]))


def optimizer_state_from_jax(opt_state, cfg, model: torch.nn.Module,
                             optimizer: torch.optim.Optimizer,
                             emit: Optional[Callable[[Emitter], None]] = None
                             ) -> int:
    """Load the JAX package's optax state into `optimizer` (an AdamW over
    model.parameters()): per parameter exp_avg = mu, exp_avg_sq = nu (each
    through its parameter's block map and layout transform) and step =
    Adam's count. cfg: the model's ModelConfig (or `emit`, the block map
    of another module tree). Raises ValueError if a parameter has no
    moment or a moment no parameter. Returns the schedule's count (the
    learning-rate schedule's position)."""
    mu, nu, count, sched_count = adam_state(opt_state)
    moments = []
    for tree in (mu, nu):
        e = Emitter({"params": tree}, params_only=True)
        _block_map(cfg, emit)(e)
        moments.append(e.sd)
    names = {id(p): k for k, p in model.named_parameters()}
    missing = sorted(set(names.values()) - set(moments[0]))
    extra = sorted(set(moments[0]) - set(names.values()))
    if missing or extra:
        raise ValueError(f"opt_state: moments without a parameter {extra}, "
                         f"parameters without a moment {missing}")
    sd = optimizer.state_dict()
    order = [p for g in optimizer.param_groups for p in g["params"]]
    for i, p in enumerate(order):
        key = names[id(p)]
        m, v = moments[0][key], moments[1][key]
        if m.shape != p.shape or v.shape != p.shape:
            raise ValueError(f"opt_state: {key}: moments {tuple(m.shape)} / "
                             f"{tuple(v.shape)}, parameter {tuple(p.shape)}")
        sd["state"][i] = {"step": torch.tensor(float(count)),
                          "exp_avg": m, "exp_avg_sq": v}
    optimizer.load_state_dict(sd)
    return sched_count
