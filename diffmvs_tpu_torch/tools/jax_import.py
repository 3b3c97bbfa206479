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

Only numpy and torch are imported. The block functions are public so
tests can carry one block's weights at a time (tkey "" = no prefix).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Tuple

import numpy as np
import torch


def _j(*parts: str) -> str:
    return ".".join(p for p in parts if p)


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)).copy())


class Emitter:
    """Reads JAX variables by path, writes torch tensors by key."""

    def __init__(self, variables: Dict):
        self.params = variables["params"]
        self.stats = variables.get("batch_stats", {})
        self.sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    @staticmethod
    def _get(tree, path: Tuple[str, ...]):
        for k in path:
            tree = tree[k]
        return np.asarray(tree)

    def _has(self, path: Tuple[str, ...]) -> bool:
        node = self.params
        for k in path:
            if not isinstance(node, dict) or k not in node:
                return False
            node = node[k]
        return True

    def _bias(self, tkey, path):
        if self._has(path + ("bias",)):
            self.sd[_j(tkey, "bias")] = _tensor(
                self._get(self.params, path + ("bias",)))

    def conv2d(self, tkey: str, *path: str):
        k = self._get(self.params, path + ("kernel",))
        self.sd[_j(tkey, "weight")] = _tensor(np.transpose(k, (3, 2, 0, 1)))
        self._bias(tkey, path)

    def conv3d(self, tkey: str, *path: str):
        k = self._get(self.params, path + ("kernel",))
        self.sd[_j(tkey, "weight")] = _tensor(
            np.transpose(k, (4, 3, 0, 1, 2)))
        self._bias(tkey, path)

    def deconv3d(self, tkey: str, *path: str):
        k = self._get(self.params, path + ("kernel",))
        w = np.transpose(k, (3, 4, 0, 1, 2))[:, :, ::-1, ::-1, ::-1]
        self.sd[_j(tkey, "weight")] = _tensor(w)

    def linear(self, tkey: str, *path: str):
        k = self._get(self.params, path + ("kernel",))
        self.sd[_j(tkey, "weight")] = _tensor(k.T)
        self._bias(tkey, path)

    def bn(self, tkey: str, *path: str):
        self.sd[_j(tkey, "weight")] = _tensor(
            self._get(self.params, path + ("scale",)))
        self.sd[_j(tkey, "bias")] = _tensor(
            self._get(self.params, path + ("bias",)))
        self.sd[_j(tkey, "running_mean")] = _tensor(
            self._get(self.stats, path + ("mean",)))
        self.sd[_j(tkey, "running_var")] = _tensor(
            self._get(self.stats, path + ("var",)))
        self.sd[_j(tkey, "num_batches_tracked")] = torch.tensor(0)

    def groupnorm(self, tkey: str, *path: str):
        self.sd[_j(tkey, "weight")] = _tensor(
            self._get(self.params, path + ("scale",)))
        self.sd[_j(tkey, "bias")] = _tensor(
            self._get(self.params, path + ("bias",)))

    def conv_bn(self, tkey: str, *path: str):
        """A .conv + .bn wrapper (2D or 3D by kernel rank)."""
        k = self._get(self.params, path + ("conv", "kernel"))
        conv = self.conv2d if k.ndim == 4 else self.conv3d
        conv(_j(tkey, "conv"), *path, "conv")
        self.bn(_j(tkey, "bn"), *path, "bn")


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


def state_dict_from_jax(variables: Dict, cfg) -> "OrderedDict[str, torch.Tensor]":
    """The port's state_dict for CasDiffMVS(cfg) from JAX variables."""
    e = Emitter(variables)
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
    return e.sd
