"""PyTorch port: the weight bridge, reference key names, checkpoint
cleaning and the package's independence from JAX."""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import jax
import pytest
import torch

from diffmvs_tpu.config import CASDIFFMVS, DIFFMVS
from diffmvs_tpu.models.casdiffmvs import CasDiffMVS as JaxCasDiffMVS
from diffmvs_tpu.tools.torch_import import import_torch_state_dict

import diffmvs_tpu_torch
import diffmvs_tpu_torch.config as tconfig
from diffmvs_tpu_torch import api
from diffmvs_tpu_torch.models.casdiffmvs import CasDiffMVS
from diffmvs_tpu_torch.tools.jax_import import state_dict_from_jax

from helpers import make_batch
from torch_oracle import CasDiffMVSOracle

SMALL = dict(numdepth_initial=8, numdepth=32)
PRESETS = {"casdiffmvs": CASDIFFMVS, "diffmvs": DIFFMVS}
PKG = pathlib.Path(diffmvs_tpu_torch.__file__).resolve().parent


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


@pytest.mark.parametrize("name", ["casdiffmvs", "diffmvs"])
def test_bridge_round_trip_is_exact(name):
    """JAX variables -> port state_dict -> the JAX package's own importer
    gives the same variables back, bit for bit; the port loads the
    state_dict with strict=True."""
    cfg = dataclasses.replace(PRESETS[name], **SMALL)
    b = make_batch(np.random.RandomState(0), 1, 3, 64, 96, numdepth=32)
    variables = jax.device_get(JaxCasDiffMVS(cfg).init(
        jax.random.PRNGKey(0), b["imgs"], b["proj_matrices"],
        b["depth_values"], rng=None, train=False, export=True))
    sd = state_dict_from_jax(variables, cfg)
    back = import_torch_state_dict(sd, cfg)
    for col in ("params", "batch_stats"):
        want, got = _flatten(variables[col]), _flatten(back[col])
        assert sorted(got) == sorted(want)
        for path, v in want.items():
            np.testing.assert_array_equal(got[path], v, err_msg=str(path))
    tcfg = dataclasses.replace(tconfig.MODEL_PRESETS[name], **SMALL)
    CasDiffMVS(tcfg).load_state_dict(sd, strict=True)


@pytest.mark.parametrize("name", ["casdiffmvs", "diffmvs"])
def test_reference_key_names_load_strict(name):
    """The test oracle carries the reference's state_dict key names."""
    cfg = dataclasses.replace(PRESETS[name], **SMALL)
    tcfg = dataclasses.replace(tconfig.MODEL_PRESETS[name], **SMALL)
    port = CasDiffMVS(tcfg)
    oracle_sd = CasDiffMVSOracle(cfg).state_dict()
    port.load_state_dict(oracle_sd, strict=True)
    assert sorted(port.state_dict()) == sorted(oracle_sd)


def test_checkpoint_aliases_and_schedule_buffers_are_dropped(tmp_path):
    """A released checkpoint also names each refinement block by its
    ModuleList alias (update_block.{i}.*) and carries its schedule
    buffers; the loader drops both, after checking the aliases."""
    tcfg = dataclasses.replace(tconfig.CASDIFFMVS, **SMALL)
    sd = dict(CasDiffMVS(tcfg).state_dict())
    ckpt = dict(sd)
    for k, v in sd.items():
        for i, attr in enumerate(("update_block_depth2.",
                                  "update_block_depth3.")):
            if k.startswith(attr):
                ckpt[f"update_block.{i}." + k[len(attr):]] = v.clone()
    ckpt["update_block_depth2.betas"] = torch.zeros(1000)
    ckpt["update_block_depth3.posterior_variance"] = torch.zeros(1000)

    cleaned = api.clean_reference_state_dict(ckpt)
    assert sorted(cleaned) == sorted(sd)
    path = tmp_path / "casdiffmvs.ckpt"
    torch.save({"model": ckpt, "epoch": 15}, path)
    runner = api.DepthRunner.from_checkpoint(str(path), "casdiffmvs",
                                             device="cpu", **SMALL)
    for k, v in runner.model.state_dict().items():
        assert torch.equal(v, sd[k]), k

    key = "update_block.1.unet.final_conv.weight"
    ckpt[key] = ckpt[key] + 1.0
    with pytest.raises(ValueError, match="differs"):
        api.clean_reference_state_dict(ckpt)


def test_import_loads_no_jax():
    code = (
        "import sys\n"
        "import diffmvs_tpu_torch, diffmvs_tpu_torch.api, "
        "diffmvs_tpu_torch.models.casdiffmvs, "
        "diffmvs_tpu_torch.tools.jax_import, "
        "diffmvs_tpu_torch.utils.synthetic, diffmvs_tpu_torch.train.loop, "
        "diffmvs_tpu_torch.train.checkpoint, "
        "diffmvs_tpu_torch.train.orbax_read, diffmvs_tpu_torch.data.mvs, "
        "diffmvs_tpu_torch.data.pipeline, diffmvs_tpu_torch.fusion.fuse, "
        "diffmvs_tpu_torch.fusion.metrics, diffmvs_tpu_torch.cli.test, "
        "diffmvs_tpu_torch.cli.eval_dtu, "
        "diffmvs_tpu_torch.tools.kernel_times, "
        "diffmvs_tpu_torch.data.dtu, diffmvs_tpu_torch.data.blend, "
        "diffmvs_tpu_torch.data.registry, "
        "diffmvs_tpu_torch.data.scene_lists, diffmvs_tpu_torch.cli.train, "
        "diffmvs_tpu_torch.parallel.distributed, "
        "diffmvs_tpu_torch.utils.profiling, "
        "diffmvs_tpu_torch.tools.retrieval, diffmvs_tpu_torch.tools.colmap, "
        "diffmvs_tpu_torch.bench, diffmvs_tpu_torch.tools.chain_spread\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'diffmvs_tpu')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=str(PKG.parent))


def test_sources_import_nothing_of_jax():
    for path in sorted(PKG.rglob("*.py")):
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                root = n.split(".")[0]
                assert root not in ("jax", "jaxlib", "flax", "diffmvs_tpu"), \
                    f"{path}: imports {n}"
