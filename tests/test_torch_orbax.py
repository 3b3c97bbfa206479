"""PyTorch port: the JAX package's orbax checkpoints, read without JAX
(train/orbax_read.py) and carried into serving, finetuning and resuming
(train/checkpoint.py, tools/jax_import.optimizer_state_from_jax,
cli/test.py, cli/train.py, api.DepthRunner.from_checkpoint).

tests/data/orbax_state/ is what write_fixture below wrote (from the
repository's root, `PYTHONPATH=. python tests/test_torch_orbax.py` writes
it again): a toy train state's checkpoint saved by the JAX package's
save_checkpoint, an orbax checkpoint of arrays split into several zarr
chunks, and expected.npz, the leaves of both.

Tolerances, with their reasons:
  * the reader against orbax's restore: bit for bit, leaf for leaf, with
    the same tree (dicts, lists, empty nodes, Python scalars);
  * serving from a JAX checkpoint: rtol 5e-3 / atol 5e-3, the full-model
    tolerance of tests/test_full_parity.py::test_full_model_parity (zero
    diffusion noise on both sides);
  * one training step after resuming from a JAX checkpoint: the
    gradient-parity gates of tests/test_torch_train.py's train_parity
    (tests/test_gradients.py), held by the parameters' updates and the
    AdamW moments: global cosine > 0.9999, per-leaf cosine > 0.999 and
    norms within 2 % for every leaf whose JAX gradient is not numerically
    dead; the learning rate rtol 1e-6, the schedules' tolerance.
"""

import dataclasses
import os
import shutil
import sys

import numpy as np
import jax
import jax.numpy as jnp
import optax
import orbax.checkpoint as ocp
import pytest
import torch

from diffmvs_tpu.config import CASDIFFMVS, DIFFMVS
from diffmvs_tpu.config import TrainConfig as JaxTrainConfig
from diffmvs_tpu.models import loss as jloss
from diffmvs_tpu.models.casdiffmvs import CasDiffMVS as JaxCasDiffMVS
from diffmvs_tpu.tools.torch_import import import_torch_state_dict
from diffmvs_tpu.train import checkpoint as jcheckpoint
from diffmvs_tpu.train.schedules import make_lr_schedule
from diffmvs_tpu.train.state import MVSTrainState, make_optimizer

import diffmvs_tpu_torch.config as tconfig
from diffmvs_tpu_torch import api
from diffmvs_tpu_torch.cli import test as tcli
from diffmvs_tpu_torch.cli import train as ttrain
from diffmvs_tpu_torch.models.casdiffmvs import CasDiffMVS
from diffmvs_tpu_torch.tools.jax_import import (Emitter,
                                                optimizer_state_from_jax,
                                                state_dict_from_jax)
from diffmvs_tpu_torch.train import checkpoint, orbax_read
from diffmvs_tpu_torch.train.orbax_read import OcdbtStore, read_orbax
from diffmvs_tpu_torch.train.state import create_train_state
from diffmvs_tpu_torch.train.step import train_step
from diffmvs_tpu_torch.utils.synthetic import synthetic_train_overrides

from helpers import make_batch
from test_cli_e2e import _make_scene
from test_torch_train_cli import _argv, _make_blend_scene

FIXTURE = os.path.join(os.path.dirname(__file__), "data", "orbax_state")
FIXTURE_DIRS = ("model_000001", "chunked")
SMALL = dict(numdepth_initial=8, numdepth=32)
JAX_PRESETS = {"casdiffmvs": CASDIFFMVS, "diffmvs": DIFFMVS}
TOL = dict(rtol=5e-3, atol=5e-3)


# ---------------------------------------------------------------------------
# the committed fixture
# ---------------------------------------------------------------------------

class ToyNet(torch.nn.Module):
    """The torch module whose weights the fixture's toy train state holds
    (emit_toy maps one onto the other)."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 8, 3)
        self.bn = torch.nn.BatchNorm2d(8)
        self.head = torch.nn.Conv3d(8, 2, 3)
        self.dense = torch.nn.Linear(8, 4)


def emit_toy(e: Emitter):
    e.conv2d("conv", "conv")
    e.bn("bn", "bn")
    e.conv3d("head", "head")
    e.linear("dense", "dense")


def _toy_state():
    """A JAX train state of ToyNet's layout after two optimizer updates
    (clip_by_global_norm, then adamw on the onecycle schedule of 2 epochs
    of 4 steps): conv, 3-D conv, dense and BatchNorm leaves, batch_stats,
    the optax chain's state with its empty nodes, step and epoch."""
    rng = np.random.RandomState(0)

    def arr(*shape):
        return rng.randn(*shape).astype(np.float32)

    params = {"conv": {"kernel": arr(3, 3, 3, 8), "bias": arr(8)},
              "bn": {"scale": arr(8), "bias": arr(8)},
              "head": {"kernel": arr(3, 3, 3, 8, 2), "bias": arr(2)},
              "dense": {"kernel": arr(8, 4), "bias": arr(4)}}
    stats = {"bn": {"mean": arr(8), "var": np.abs(arr(8)) + 0.5}}
    cfg = JaxTrainConfig(epochs=2)
    tx = make_optimizer(make_lr_schedule(cfg, 4), cfg.weight_decay,
                        cfg.grad_clip)
    state = MVSTrainState.create(apply_fn=None, params=params,
                                 batch_stats=stats, tx=tx)
    for scale in (3.0, 0.5):
        grads = jax.tree.map(lambda p: scale * arr(*p.shape), params)
        state = state.apply_gradients(grads=grads)
    return jax.device_get(state.replace(epoch=1))


def _chunked_tree():
    """Arrays orbax splits into several zarr chunks (edge chunks partial),
    of every dtype a train state could hold, and a scalar."""
    rng = np.random.RandomState(1)
    return {"state": {
        "w": rng.randn(10, 7).astype(np.float32),
        "n": rng.randint(-9, 9, (5, 3, 4)).astype(np.int32),
        "h": rng.randn(33).astype(np.float16),
        "b": rng.rand(6, 6) > 0.5,
        "u": rng.randint(0, 255, (40,)).astype(np.uint8),
        "d": rng.randn(3, 5).astype(np.float64),
        "count": np.int64(7), "lr": 0.25}}


def flatten(tree, prefix=""):
    """{path: leaf} of a restored tree; None / {} / [] leaves kept."""
    if isinstance(tree, dict) and tree:
        items = tree.items()
    elif isinstance(tree, list) and tree:
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def expected_arrays(trees):
    """expected.npz's contents from {dir name: restored tree}: each array
    or scalar leaf under "<dir>:<path>", and "__empty__" listing the empty
    leaves as "<dir>:<path>=<None|dict|list>"."""
    out, empty = {}, []
    for name, tree in trees.items():
        for path, leaf in flatten(tree).items():
            if leaf is None or (isinstance(leaf, (dict, list)) and not leaf):
                empty.append(f"{name}:{path}={type(leaf).__name__}")
            else:
                out[f"{name}:{path}"] = np.asarray(leaf)
    out["__empty__"] = np.array(sorted(empty))
    return out


def write_fixture(root):
    """Write tests/data/orbax_state/ into root: model_000001/ by
    jcheckpoint.save_checkpoint; chunked/ by orbax's StandardCheckpointer
    with SaveArgs(chunk_byte_size=48), since save_checkpoint passes no
    save args and orbax 0.11.32 then chunks an array only above its
    2 GiB target data file size; expected.npz, their leaves as orbax
    restores them."""
    os.makedirs(root, exist_ok=True)
    jcheckpoint.save_checkpoint(root, _toy_state(), 1)
    tree = _chunked_tree()
    save_args = jax.tree.map(lambda _: ocp.SaveArgs(chunk_byte_size=48),
                             tree)
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(os.path.join(os.path.abspath(root), "chunked"), tree,
               save_args=save_args, force=True)
    ckptr.wait_until_finished()
    restored = {name: ocp.PyTreeCheckpointer().restore(
        os.path.join(os.path.abspath(root), name)) for name in FIXTURE_DIRS}
    np.savez(os.path.join(root, "expected.npz"),
             **expected_arrays(restored))


def assert_same_tree(got, want, path="."):
    """Equal trees: the same dicts, lists and empty nodes, arrays of the
    same dtype, shape and bytes, scalars of the same type and value."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_tree(g, w, f"{path}/{i}")
    elif isinstance(want, (np.ndarray, jax.Array)):
        want = np.asarray(want)
        assert isinstance(got, np.ndarray), (path, type(got))
        assert (got.dtype, got.shape) == (want.dtype, want.shape), path
        assert got.tobytes() == want.tobytes(), path
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def test_fixture_is_small_and_has_a_train_state_layout():
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(FIXTURE) for f in files)
    assert size <= 256 * 1024, size
    tree = read_orbax(os.path.join(FIXTURE, "model_000001"))["state"]
    assert sorted(tree) == ["batch_stats", "epoch", "opt_state", "params",
                            "step"]
    clip, (adam, decay, sched) = tree["opt_state"]
    assert clip is None and decay is None
    assert sorted(adam) == ["count", "mu", "nu"] and sorted(sched) == \
        ["count"]
    assert int(adam["count"]) == int(sched["count"]) == tree["step"] == 2
    store = OcdbtStore(os.path.join(FIXTURE, "chunked"))
    assert sum(k.startswith(b"state.w/") for k in store.keys()) > 3


def test_fixture_is_what_write_fixture_writes(tmp_path):
    """The committed files and a fresh write_fixture restore to the same
    leaves (orbax's files hold timestamps and ids, not the same bytes)."""
    write_fixture(str(tmp_path))
    for name in FIXTURE_DIRS:
        assert_same_tree(
            ocp.PyTreeCheckpointer().restore(str(tmp_path / name)),
            ocp.PyTreeCheckpointer().restore(os.path.join(FIXTURE, name)))


@pytest.mark.parametrize("name", FIXTURE_DIRS)
def test_read_orbax_equals_orbax_restore_on_the_fixture(name):
    path = os.path.join(FIXTURE, name)
    got = read_orbax(path)
    assert_same_tree(got, ocp.PyTreeCheckpointer().restore(path))
    want = np.load(os.path.join(FIXTURE, "expected.npz"))
    mine = expected_arrays({name: got})
    keys = [k for k in want.files if k.startswith(name + ":")]
    assert sorted(k for k in mine if k != "__empty__") == sorted(keys)
    for k in keys:
        assert mine[k].dtype == want[k].dtype and \
            mine[k].tobytes() == want[k].tobytes(), k
    assert [e for e in want["__empty__"] if e.startswith(name + ":")] == \
        list(mine["__empty__"])


def test_ocdbt_interior_nodes_and_indirect_values_against_tensorstore(
        tmp_path):
    """A store of several B+tree levels and values in data files (small
    node and inline limits) reads as tensorstore reads it."""
    import tensorstore as ts

    kv = ts.KvStore.open({
        "driver": "ocdbt", "base": f"file://{tmp_path}",
        "config": {"max_decoded_node_bytes": 200,
                   "max_inline_value_bytes": 8}}).result()
    with ts.Transaction() as txn:
        for i in range(60):
            kv.with_transaction(txn).write(
                f"k/{i % 7}/{i:03d}", bytes([i]) * (1 + i % 13)).result()
    store = OcdbtStore(str(tmp_path))
    keys = kv.list().result()
    assert store.keys() == sorted(keys) and len(keys) == 60
    for k in keys:
        assert store[k.decode()] == kv.read(k).result().value, k


# ---------------------------------------------------------------------------
# full-width train states written by the JAX package
# ---------------------------------------------------------------------------

def jax_train_state(name, seed=0, steps_per_epoch=4, moments=True):
    """(JAX train state, JAX ModelConfig, port ModelConfig): the
    full-width model's weights from the port's init (seed) carried over
    by the JAX package's importer, randomized BatchNorm statistics, the
    JAX package's optimizer; with `moments`, random AdamW moments at
    count 3, as after three updates."""
    cfg_j = dataclasses.replace(JAX_PRESETS[name], **SMALL)
    cfg_t = dataclasses.replace(tconfig.MODEL_PRESETS[name], **SMALL)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        sd = CasDiffMVS(cfg_t).state_dict()
    variables = import_torch_state_dict(sd, cfg_j)
    rng = np.random.RandomState(seed + 1)
    stats = jax.tree.map(lambda v: rng.uniform(0.5, 1.5, np.shape(v))
                         .astype(np.float32), variables["batch_stats"])
    tcfg = JaxTrainConfig(model=cfg_j, epochs=2)
    tx = make_optimizer(make_lr_schedule(tcfg, steps_per_epoch),
                        tcfg.weight_decay, tcfg.grad_clip)
    state = MVSTrainState.create(apply_fn=None,
                                 params=variables["params"],
                                 batch_stats=stats, tx=tx)
    if moments:
        clip, (adam, decay, sched) = state.opt_state

        def rand(scale):
            return jax.tree.map(lambda p: (scale * np.abs(
                rng.randn(*np.shape(p)))).astype(np.float32),
                variables["params"])
        state = state.replace(step=3, opt_state=(clip, (
            adam._replace(count=jnp.int32(3), mu=rand(1e-3),
                          nu=rand(1e-6)),
            decay, sched._replace(count=jnp.int32(3)))))
    return jax.device_get(state), cfg_j, cfg_t


@pytest.fixture(scope="module")
def jax_logdirs(tmp_path_factory):
    """{preset: logdir} of full-width CasDiffMVS and DiffMVS train states
    saved by the JAX package's save_checkpoint as epoch 0."""
    out = {}
    for name in JAX_PRESETS:
        logdir = str(tmp_path_factory.mktemp(name))
        jcheckpoint.save_checkpoint(logdir, jax_train_state(name)[0], 0)
        out[name] = logdir
    return out


@pytest.mark.parametrize("name", list(JAX_PRESETS))
def test_read_orbax_equals_orbax_restore_on_full_train_states(
        jax_logdirs, name):
    path = os.path.join(jax_logdirs[name], "model_000000")
    tree = read_orbax(path)
    assert_same_tree(tree, ocp.PyTreeCheckpointer().restore(path))
    n_params = len(jax.tree.leaves(tree["state"]["params"]))
    assert n_params == {"casdiffmvs": 383, "diffmvs": 235}[name]


@pytest.mark.parametrize("name", list(JAX_PRESETS))
def test_load_variables_equals_the_jax_package_carried_over(jax_logdirs,
                                                            name):
    """checkpoint.load_variables of a logdir and of its model_NNNNNN/ give
    the JAX package's load_variables through state_dict_from_jax; the
    port loads it strictly."""
    cfg_t = dataclasses.replace(tconfig.MODEL_PRESETS[name], **SMALL)
    want = state_dict_from_jax(jcheckpoint.load_variables(jax_logdirs[name]),
                               cfg_t)
    for path in (jax_logdirs[name],
                 os.path.join(jax_logdirs[name], "model_000000")):
        got = checkpoint.load_variables(path, cfg_t)
        assert list(got) == list(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), k
    CasDiffMVS(cfg_t).load_state_dict(got, strict=True)


def test_serving_from_a_jax_checkpoint_matches_jax(jax_logdirs, tmp_path):
    """DepthRunner.from_checkpoint(JAX logdir) against the JAX package's
    load_variables + export forward at 64x96, zero noise on both sides;
    cli.test --device cpu --loadckpt <JAX logdir> exports the scene with
    the same weights."""
    logdir = jax_logdirs["casdiffmvs"]
    cfg_j = dataclasses.replace(CASDIFFMVS, **SMALL)
    batch = make_batch(np.random.RandomState(0), 1, 3, 64, 96, numdepth=32)
    variables = jcheckpoint.load_variables(logdir)
    want = jax.jit(lambda v, b: JaxCasDiffMVS(cfg_j).apply(
        v, b["imgs"], b["proj_matrices"], b["depth_values"], rng=None,
        train=False, export=True))(variables, batch)
    runner = api.DepthRunner.from_checkpoint(
        logdir, "casdiffmvs", device="cpu", scale=(0.0, 0.0, 0.0), **SMALL)
    depth, confs = runner(batch["imgs"], batch["proj_matrices"],
                          batch["depth_values"])
    np.testing.assert_allclose(depth.numpy(), np.asarray(want["depth"][-1]),
                               **TOL)
    assert len(confs) == len(want["photometric_confidence"])
    for c, w in zip(confs, want["photometric_confidence"]):
        np.testing.assert_allclose(c.numpy(), np.asarray(w), **TOL)

    _make_scene(tmp_path / "scene", h=32, w=64)
    sd = tcli.load_state_dict(logdir, runner.cfg)
    for k, v in runner.model.state_dict().items():
        assert torch.equal(sd[k], v), k
    with pytest.raises(ValueError, match="ModelConfig"):
        tcli.load_state_dict(logdir)
    res = tcli.main([
        "--dataset", "general", "--method", "casdiffmvs", "--save_depth",
        "--testpath", str(tmp_path / "scene"), "--outdir",
        str(tmp_path / "out"), "--loadckpt", logdir, "--max_h", "32",
        "--max_w", "64", "--workers", "0", "--numdepth_initial", "4",
        "--numdepth", "16", "--geo_mask_thres", "1", "--geo_pixel_thres",
        "8", "--geo_depth_thres", "0.5", "--photo_thres", "0", "0", "0",
        "--device", "cpu"])
    assert res["export"]["views"] == 3
    assert res["points"][str(tmp_path / "out" / "pc.ply")] > 0


def test_load_weights_only_is_jax_merge(tmp_path, capsys):
    """--loadckpt's weights-only path from a partial checkpoint (a
    CasDiffMVS state without its second refinement block, with a tensor
    the model lacks): the tensors both have are the JAX package's
    load_weights_only merge, carried over; the others keep their values
    and are printed as missing / unexpected."""
    src, _, cfg_t = jax_train_state("casdiffmvs", seed=6, moments=False)
    params = dict(src.params, extra={"kernel": np.ones((2, 3), np.float32)})
    del params["update_block2"]
    stats = {k: v for k, v in src.batch_stats.items()
             if k != "update_block2"}
    jcheckpoint.save_checkpoint(str(tmp_path),
                                src.replace(params=params,
                                            batch_stats=stats), 3)
    dst, _, _ = jax_train_state("casdiffmvs", seed=5, moments=False)
    merged = jcheckpoint.load_weights_only(str(tmp_path), dst)
    want = state_dict_from_jax({"params": merged.params,
                                "batch_stats": merged.batch_stats}, cfg_t)
    state = create_train_state(tconfig.TrainConfig(model=cfg_t),
                               device="cpu", seed=5)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    capsys.readouterr()
    checkpoint.load_weights_only(str(tmp_path), state)
    out = capsys.readouterr().out
    after = state.model.state_dict()
    missing = sorted(k for k in after if k.startswith("update_block_depth3."))
    for k, v in after.items():
        assert torch.equal(v, before[k] if k in missing else want[k]), k
    assert f"{len(missing)} missing key(s): " in out
    assert "1 unexpected key(s): params/extra/kernel" in out
    assert not state.optimizer.state


# ---------------------------------------------------------------------------
# resuming
# ---------------------------------------------------------------------------

def _cosine(a, b):
    return float(np.dot(a, b) / max(np.linalg.norm(a) * np.linalg.norm(b),
                                    1e-30))


def _assert_like_gradients(got, ref, live, what):
    """train_parity's gates over the leaves in `live`."""
    keys = sorted(live)
    cos = _cosine(np.concatenate([got[k] for k in keys]),
                  np.concatenate([ref[k] for k in keys]))
    assert cos > 0.9999, (what, cos)
    for k in keys:
        a, r = got[k], ref[k]
        assert _cosine(a, r) > 0.999, (what, k, _cosine(a, r))
        nr = np.linalg.norm(r)
        assert abs(np.linalg.norm(a) - nr) < 0.02 * nr + 1e-12, (what, k)


def test_resume_from_jax_matches_one_jax_step(tmp_path):
    """JAX takes a step and saves; then the JAX package's
    restore_checkpoint + one step against the port's restore_checkpoint +
    one step on the same batch, timesteps and noise: parameters, AdamW
    moments and the learning rate."""
    b, h, w = 1, 32, 64
    state0, cfg_j, cfg_t = jax_train_state("casdiffmvs", seed=2,
                                           moments=False)
    batch = make_batch(np.random.RandomState(0), b, 3, h, w, numdepth=32,
                       with_gt=True)
    for s, arr in batch["depth"].items():
        arr[:, :2, :3] = 0.0
        batch["mask"][s] = (np.random.RandomState(1).rand(*arr.shape)
                            > 0.25).astype(np.float32)
    overrides = synthetic_train_overrides(cfg_t, b, h, w, seed=3)
    model = JaxCasDiffMVS(cfg_j)

    @jax.jit
    def jstep(state):
        def loss_fn(p):
            out, mutated = model.apply(
                {"params": p, "batch_stats": state.batch_stats},
                batch["imgs"], batch["proj_matrices"],
                batch["depth_values"], depth_gt=batch["depth"], rng=None,
                train=True, mutable=["batch_stats"],
                train_overrides={s: (jnp.asarray(t), jnp.asarray(n))
                                 for s, (t, n) in overrides.items()})
            loss, _ = jloss.compute_inverse_loss(
                out["depth"], out["conf"], batch["depth"], batch["mask"],
                batch["depth_values"], cfg_j.stage_iters, 0.9, 0.05)
            return loss, mutated["batch_stats"]
        (_, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params)
        return state.apply_gradients(grads=grads, batch_stats=stats), grads

    logdir = str(tmp_path / "log")
    state1, _ = jstep(state0)
    jcheckpoint.save_checkpoint(logdir, state1, 0)
    restored, epoch = jcheckpoint.restore_checkpoint(logdir, state0)
    assert epoch == 0
    state2, grads2 = jax.device_get(jstep(restored))

    cfg = tconfig.TrainConfig(model=cfg_t, batch_size=b, epochs=2)
    port = create_train_state(cfg, steps_per_epoch=4, device="cpu", seed=9)
    port, epoch = checkpoint.restore_checkpoint(logdir, port)
    assert epoch == 0 and (port.epoch, port.step) == (1, 1)
    schedule = make_lr_schedule(JaxTrainConfig(model=cfg_j, epochs=2), 4)
    np.testing.assert_allclose(port.optimizer.param_groups[0]["lr"],
                               float(schedule(1)), rtol=1e-6)
    before = {k: p.detach().numpy().copy()
              for k, p in port.model.named_parameters()}
    train_step(port, cfg, batch, train_overrides=overrides)
    assert port.step == 2
    np.testing.assert_allclose(port.optimizer.param_groups[0]["lr"],
                               float(schedule(2)), rtol=1e-6)

    def port_keys(tree):
        e = Emitter({"params": tree}, params_only=True)
        from diffmvs_tpu_torch.tools.jax_import import emit_casdiffmvs
        emit_casdiffmvs(e, cfg_t)
        return {k: v.numpy().ravel() for k, v in e.sd.items()}

    g = port_keys(grads2)
    scale = max(float(np.abs(v).max()) for v in g.values())
    live = [k for k, v in g.items() if np.linalg.norm(v) >= 1e-7 * scale]
    assert len(live) > 0.9 * len(g)
    params1 = {k: v.ravel() for k, v in before.items()}
    want_update = {k: v - params1[k]
                   for k, v in port_keys(state2.params).items()}
    got_update = {k: p.detach().numpy().ravel() - params1[k]
                  for k, p in port.model.named_parameters()}
    _assert_like_gradients(got_update, want_update, live, "update")
    mu, nu = state2.opt_state[1][0].mu, state2.opt_state[1][0].nu
    names = {id(p): k for k, p in port.model.named_parameters()}
    for key, tree in (("exp_avg", mu), ("exp_avg_sq", nu)):
        got = {names[id(p)]: s[key].numpy().ravel()
               for p, s in port.optimizer.state.items()}
        _assert_like_gradients(got, port_keys(tree), live, key)
    assert all(int(s["step"]) == 2 for s in port.optimizer.state.values())


def test_train_cli_resumes_a_jax_logdir_and_loads_orbax_weights(tmp_path):
    """cli.train --resume over a logdir the JAX package wrote continues at
    the next epoch with its step count, and --loadckpt <orbax dir> loads
    the weights alone."""
    _make_blend_scene(tmp_path, "synth")
    (tmp_path / "list.txt").write_text("synth\n")
    logdir = tmp_path / "log"
    state, _, cfg_t = jax_train_state("casdiffmvs", seed=4,
                                      steps_per_epoch=2)
    jcheckpoint.save_checkpoint(str(logdir), state, 0)
    res = ttrain.main(_argv(tmp_path, "--resume"))
    assert (res["state"].step, res["state"].epoch) == (5, 2)
    assert checkpoint.latest_epoch(str(logdir)) == 1
    assert os.path.isfile(checkpoint.checkpoint_path(str(logdir), 1))

    res = ttrain.main(_argv(tmp_path, "--mode", "test", "--loadckpt",
                            str(logdir / "model_000000")))
    want = checkpoint.load_variables(str(logdir / "model_000000"), cfg_t)
    for k, v in res["state"].model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_an_epoch_saved_in_both_formats_is_refused(jax_logdirs, tmp_path):
    logdir = tmp_path / "log"
    shutil.copytree(jax_logdirs["casdiffmvs"], logdir)
    torch.save({"model": {}, "epoch": 0}, checkpoint.checkpoint_path(
        str(logdir), 0))
    for fn in (lambda: checkpoint.resolve(str(logdir)),
               lambda: checkpoint.restore_checkpoint(str(logdir), None)):
        with pytest.raises(ValueError, match="epoch 0 is saved twice"):
            fn()
    torch.save({"model": {}, "epoch": 1}, checkpoint.checkpoint_path(
        str(logdir), 1))
    assert checkpoint.resolve(str(logdir)) == \
        checkpoint.checkpoint_path(str(logdir), 1)


# ---------------------------------------------------------------------------
# the AdamW state of the fixture, and what the reader refuses
# ---------------------------------------------------------------------------

def test_optimizer_state_from_the_fixture():
    """The toy state's mu / nu become ToyNet's exp_avg / exp_avg_sq
    through the parameters' layout transforms; count becomes step."""
    tree = read_orbax(os.path.join(FIXTURE, "model_000001"))["state"]
    net = ToyNet()
    net.load_state_dict(state_dict_from_jax(
        {"params": tree["params"], "batch_stats": tree["batch_stats"]},
        None, emit=emit_toy))
    opt = torch.optim.AdamW(net.parameters())
    position = optimizer_state_from_jax(tree["opt_state"], None, net, opt,
                                        emit=emit_toy)
    assert position == 2
    mu = tree["opt_state"][1][0]["mu"]
    s = opt.state[net.conv.weight]
    assert int(s["step"]) == 2
    np.testing.assert_array_equal(
        s["exp_avg"].numpy(), np.transpose(mu["conv"]["kernel"],
                                           (3, 2, 0, 1)))
    np.testing.assert_array_equal(opt.state[net.dense.weight]["exp_avg"]
                                  .numpy(), mu["dense"]["kernel"].T)
    with pytest.raises(ValueError, match="mu, nu and count"):
        optimizer_state_from_jax([None, [{"count": 1}]], None, net, opt,
                                 emit=emit_toy)


def test_missing_libzstd_is_named(monkeypatch):
    monkeypatch.setattr(orbax_read, "LIBZSTD", "libzstd-missing.so.1")
    monkeypatch.setattr(orbax_read, "_zstd_lib", None)
    with pytest.raises(OSError, match="libzstd-missing.so.1"):
        read_orbax(os.path.join(FIXTURE, "model_000001"))


def test_zarr3_checkpoint_is_refused(tmp_path):
    ckptr = ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_zarr3=True))
    ckptr.save(str(tmp_path / "z3"), {"a": np.arange(4.0)})
    with pytest.raises(ValueError, match="use_zarr3"):
        read_orbax(str(tmp_path / "z3"))


def test_data_file_paths_outside_the_store_are_refused():
    for path in (b"../d/x", b"/etc/x", b"d/../../x"):
        table = bytes([1, len(path), 0]) + path
        with pytest.raises(ValueError, match="leaves the store"):
            orbax_read._data_files(orbax_read._Reader(table, "node"))
    table = bytes([1, 4, 0]) + b"d/ab"
    assert orbax_read._data_files(orbax_read._Reader(table, "node")) == \
        ["d/ab"]


@pytest.mark.parametrize("target", ["manifest", "node"])
def test_crc_mismatch_is_refused(tmp_path, target):
    path = tmp_path / "ckpt"
    shutil.copytree(os.path.join(FIXTURE, "model_000001"), path)
    if target == "manifest":
        victim = path / "manifest.ocdbt"
    else:
        victim = next((path / "d").iterdir())
    raw = bytearray(victim.read_bytes())
    raw[20] ^= 0x40
    victim.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match=f"{victim.name}.*crc32c mismatch"):
        read_orbax(str(path))


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    write_fixture(sys.argv[1] if len(sys.argv) > 1 else FIXTURE)
