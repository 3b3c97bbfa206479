"""PyTorch port: data-parallel training (parallel/distributed.py and
train_step's dp) in a 2-process gloo group on the CPU, against the
single-process step on the whole batch.

The ranks run run_rank below, spawned (a fresh interpreter that imports
this module, and no JAX), joined with a timeout and killed on it.

Each rank's step is held against two single-process steps on the whole
batch. Against the same model with SyncBatchNorm (without a group: the
statistics of the local batch, here the whole batch), what the ranks
change is only where the sums are taken, so the tight gates hold:
  * loss rel 1e-6, the other forward scalars rel 1e-5 (float32 sums in
    another order);
  * gradients max abs 1e-5 (measured <= 2.5e-7);
  * BatchNorm running statistics 1e-6.
Against the plain step with nn.BatchNorm, the scalars and statistics keep
those gates (statistics measured 1.7e-7) but the gradients are held by
global cosine > 0.9999 and max abs 2e-3. SyncBatchNorm and nn.BatchNorm
round differently in the last bit (the layer tests below hold them
within 1e-5), and in CasDiffMVS one ReLU input of
context.layer2.1.conv1 (row 1, channel 5) sits at -1.5e-6 with
nn.BatchNorm and +6.7e-7 with SyncBatchNorm: the flip at the kink moves
that convolution's weight gradient by 1.3e-3 (leaf max 1.1e-2), at
cosine 0.99998. The same 1.3e-3 separates the SyncBatchNorm step on one
process from the nn.BatchNorm step, so the ranks add nothing to it.
`python -m tests.test_torch_parallel` prints these figures.

The "shard" mode (the JAX package's shard_map step: per-rank BatchNorm
statistics, per-rank noise and mask counts, statistics and gradients
averaged) is held against JAX's make_train_step_shmap on a two-device CPU
mesh, the noise injected per shard on both sides, at the training-step
gates of tests/test_torch_train.py's train_parity (loss rtol 2e-4,
gradient cosine > 0.9999 globally and > 0.999 per live leaf, norms within
2 %; BatchNorm statistics rtol 1e-4 / atol 1e-6 against JAX's rescaled by
n/(n-1), since torch keeps the unbiased variance); and, with the noise
drawn from each rank's folded generator, against the port's
single-process step run per shard with that rank's generator, the
gradients and statistics averaged (gradients max abs 1e-5, statistics
1e-6, loss rel 1e-6: the same float32 work, summed in another order).
"""

import dataclasses
import multiprocessing as mp
import os
import shutil
import socket
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn as nn

from diffmvs_tpu_torch.config import TrainConfig
from diffmvs_tpu_torch.parallel import distributed
from diffmvs_tpu_torch.parallel.distributed import (SyncBatchNorm,
                                                    convert_sync_batchnorm)
from diffmvs_tpu_torch.train.state import create_train_state

WORLD = 2
PRESETS = ("casdiffmvs", "diffmvs")


# ---------------------------------------------------------------------------
# one rank of the group (spawned: imports torch and the port only)
# ---------------------------------------------------------------------------

def dp_case(preset, world_size):
    """(TrainConfig, global numpy batch, global train_overrides) of the
    data-parallel cases: B = 2 per rank, 3 views, 32x64, 8/32
    hypotheses, invalid GT and masks that differ from row to row."""
    from diffmvs_tpu_torch.config import MODEL_PRESETS, TrainConfig
    from diffmvs_tpu_torch.utils.synthetic import (
        synthetic_train_batch, synthetic_train_overrides)

    b, h, w = 2 * world_size, 32, 64
    model_cfg = dataclasses.replace(MODEL_PRESETS[preset],
                                    numdepth_initial=8, numdepth=32)
    cfg = TrainConfig(model=model_cfg, batch_size=b)
    batch = synthetic_train_batch(b, 3, h, w, 32, seed=4)
    rng = np.random.RandomState(5)
    for i, (s, arr) in enumerate(sorted(batch["depth"].items())):
        arr[:, :1, :2] = 0.0
        keep = 0.2 + 0.6 * np.arange(b)[:, None, None] / b
        batch["mask"][s] = (rng.rand(*arr.shape) < keep).astype(np.float32)
    overrides = synthetic_train_overrides(model_cfg, b, h, w, seed=6)
    return cfg, batch, overrides


def bn_case():
    """A BatchNorm input [4, 6, 5, 7] and its output cotangent."""
    rng = np.random.RandomState(7)
    x = (3.0 + 2.0 * rng.randn(4, 6, 5, 7)).astype(np.float32)
    g = rng.randn(4, 6, 5, 7).astype(np.float32)
    return x, g


def step_results(state, scalars):
    return {"scalars": {k: float(v) for k, v in scalars.items()},
            "grads": {k: p.grad.detach().clone()
                      for k, p in state.model.named_parameters()},
            "buffers": {k: v.detach().clone()
                        for k, v in state.model.named_buffers()}}


def one_step(cfg, batch, overrides=None, generator=None, parallel=None,
             sync_bn=False):
    """step_results of one train_step from a fresh state (seed 0) on
    `batch` (this rank's rows under `parallel`, which makes a
    DataParallel of the state's model; with sync_bn and no `parallel`,
    the model's BatchNorms become SyncBatchNorm over the local batch)."""
    from diffmvs_tpu_torch.parallel.distributed import convert_sync_batchnorm
    from diffmvs_tpu_torch.train.state import create_train_state
    from diffmvs_tpu_torch.train.step import train_step

    state = create_train_state(cfg, steps_per_epoch=10, device="cpu", seed=0)
    if sync_bn:
        convert_sync_batchnorm(state.model)
    dp = None if parallel is None else parallel(state.model)
    scalars, _ = train_step(state, cfg, batch, generator=generator,
                            train_overrides=overrides, dp=dp)
    return step_results(state, scalars)


def run_steps(cfg, batch, overrides, rows, parallel=None, sync_bn=False):
    """Two single steps, each from the same fresh state: the first with the
    global train_overrides, the second drawing them from a generator
    seeded 11. rows: (rank, number of ranks) of the global batch."""
    from diffmvs_tpu_torch.train.step import _split

    local = _split(batch, rows[1], rows[0])
    return [one_step(cfg, local, overrides=overrides, parallel=parallel,
                     sync_bn=sync_bn),
            one_step(cfg, local, parallel=parallel, sync_bn=sync_bn,
                     generator=torch.Generator().manual_seed(11))]


def bn_hooks(model):
    """{BatchNorm module name: (calls, elements per channel)}, filled as
    the model runs."""
    calls = {}

    def hook(name):
        def fn(mod, inputs):
            x = inputs[0]
            calls[name] = (calls.get(name, (0, 0))[0] + 1,
                           x.numel() // x.shape[1])
        return fn

    for name, mod in model.named_modules():
        if isinstance(mod, nn.modules.batchnorm._BatchNorm):
            mod.register_forward_pre_hook(hook(name))
    return calls


def shard_steps(cfg, batch, overrides, rank, world_size):
    """Two "shard"-mode steps from the same fresh state (seed 0) on this
    rank's rows: the first with the global batch's train_overrides (each
    rank keeps its rows), the second drawing from the rank's generator
    (DataParallel.generator(11)). step_results of each, the first with
    its BatchNorm calls and the number of SyncBatchNorms."""
    from diffmvs_tpu_torch.parallel.distributed import (DataParallel,
                                                        SyncBatchNorm)
    from diffmvs_tpu_torch.train.state import create_train_state
    from diffmvs_tpu_torch.train.step import _split, train_step

    local = _split(batch, world_size, rank)
    out = []
    for ov in (overrides, None):
        state = create_train_state(cfg, steps_per_epoch=10, device="cpu",
                                   seed=0)
        dp = DataParallel(state.model, mode="shard")
        calls = bn_hooks(state.model)
        gen = dp.generator(11, "cpu")
        scalars, _ = train_step(state, cfg, local, generator=gen,
                                train_overrides=ov, dp=dp)
        res = step_results(state, scalars)
        res.update(bn_calls=calls, seed=gen.initial_seed(),
                   sync_bn=sum(isinstance(m, SyncBatchNorm)
                               for m in state.model.modules()))
        out.append(res)
    return out


def run_rank(rank, world_size, port, outdir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world_size, rank=rank)
    try:
        from diffmvs_tpu_torch.parallel.distributed import (DataParallel,
                                                            SyncBatchNorm)
        from diffmvs_tpu_torch.train.step import _split

        res = {}
        for preset in ("casdiffmvs", "diffmvs"):
            cfg, batch, overrides = dp_case(preset, world_size)
            res[preset] = run_steps(cfg, batch, overrides,
                                    (rank, world_size), DataParallel)
        cfg, batch, overrides = dp_case("casdiffmvs", world_size)
        res["accum"] = one_step(
            dataclasses.replace(cfg, accum_steps=2),
            _split(batch, world_size, rank), overrides,
            parallel=DataParallel)
        res["shard"] = shard_steps(cfg, batch, overrides, rank, world_size)

        x, g = bn_case()
        for dtype in (torch.float32, torch.bfloat16):
            bn = SyncBatchNorm(6).train()
            with torch.no_grad():
                bn.weight.uniform_(0.5, 1.5, generator=torch.Generator()
                                   .manual_seed(1))
                bn.bias.uniform_(-0.5, 0.5, generator=torch.Generator()
                                 .manual_seed(2))
            xr = torch.from_numpy(x[2 * rank:2 * rank + 2]).to(dtype)
            xr.requires_grad_()
            y = bn(xr)
            y.backward(torch.from_numpy(g[2 * rank:2 * rank + 2]).to(dtype))
            res[f"bn_{dtype}"] = {"y": y.detach(), "dx": xr.grad,
                                  "dw": bn.weight.grad, "db": bn.bias.grad,
                                  "running_mean": bn.running_mean,
                                  "running_var": bn.running_var}
        res["jax_modules"] = sorted(
            m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "flax", "diffmvs_tpu"))
        torch.save(res, os.path.join(outdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(outdir):
    """Both ranks' results: run_rank in WORLD spawned processes, joined
    with a 120 s timeout."""
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=run_rank,
                         args=(r, WORLD, port, str(outdir)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    assert not hung, "a rank of the gloo group did not finish in 120 s"
    assert [p.exitcode for p in procs] == [0] * WORLD
    return [torch.load(os.path.join(outdir, f"rank{r}.pt"),
                       weights_only=False) for r in range(WORLD)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("dp")
    out = spawn_ranks(str(outdir))
    shutil.rmtree(outdir)
    return out


@pytest.fixture(scope="module", params=PRESETS)
def single(request):
    """(preset, the single-process steps on the whole batch with
    SyncBatchNorm, the same with nn.BatchNorm)."""
    cfg, batch, overrides = dp_case(request.param, WORLD)
    return (request.param,
            run_steps(cfg, batch, overrides, (0, 1), sync_bn=True),
            run_steps(cfg, batch, overrides, (0, 1)))


def test_ranks_import_no_jax(ranks):
    for res in ranks:
        assert res["jax_modules"] == []


def _cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()).clamp_min(1e-300))


def _assert_step_matches(got, sync, plain, what):
    """One rank's step_results against the single-process step's with
    SyncBatchNorm (`sync`) and with nn.BatchNorm (`plain`), with the
    module docstring's gates."""
    keys = sorted(sync["grads"])
    for ref, name in ((sync, "sync"), (plain, "plain")):
        assert sorted(got["scalars"]) == sorted(ref["scalars"])
        for k, v in ref["scalars"].items():
            if k != "grad_norm" or ref is sync:
                np.testing.assert_allclose(
                    got["scalars"][k], v,
                    rtol=1e-6 if k == "loss" else 1e-5,
                    err_msg=f"{what} {name} {k}")
        for k, v in ref["buffers"].items():
            torch.testing.assert_close(
                got["buffers"][k], v, rtol=1e-6, atol=1e-6,
                msg=lambda m: f"{what} {name} {k}: {m}")
    for k in keys:
        torch.testing.assert_close(got["grads"][k], sync["grads"][k],
                                   rtol=0, atol=1e-5,
                                   msg=lambda m: f"{what} sync {k}: {m}")
    cos = _cosine(torch.cat([got["grads"][k].flatten() for k in keys]),
                  torch.cat([plain["grads"][k].flatten() for k in keys]))
    assert cos > 0.9999, (what, cos)
    for k in keys:
        torch.testing.assert_close(got["grads"][k], plain["grads"][k],
                                   rtol=0, atol=2e-3,
                                   msg=lambda m: f"{what} plain {k}: {m}")


def test_data_parallel_step_equals_single_process_step(ranks, single):
    """Two single steps from the same fresh state, the first given the
    global batch's overrides, the second drawing them from a seeded
    generator: every rank's scalars, gradients and BatchNorm statistics
    equal the single-process step's on the whole batch; DDP leaves the
    same gradients on every rank."""
    preset, sync, plain = single
    for res in ranks:
        for step in range(2):
            got = res[preset][step]
            _assert_step_matches(got, sync[step], plain[step],
                                 f"{preset} step {step}")
            for k, v in ranks[0][preset][step]["grads"].items():
                assert torch.equal(got["grads"][k], v), k


def test_data_parallel_accumulation(ranks):
    """accum_steps=2 under dp: each rank splits its rows, so microbatch i
    is row i of every rank: the single-process step with accum_steps=2 on
    the batch with its rows in that order (0, 2, 1, 3)."""
    cfg, batch, overrides = dp_case("casdiffmvs", WORLD)
    order = [0, 2, 1, 3]

    def permute(tree):
        if isinstance(tree, dict):
            return {k: permute(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(permute(v) for v in tree)
        return tree[order]

    cfg = dataclasses.replace(cfg, accum_steps=2)
    sync, plain = (one_step(cfg, permute(batch), permute(overrides),
                            sync_bn=sync_bn) for sync_bn in (True, False))
    for res in ranks:
        _assert_step_matches(res["accum"], sync, plain, "accum")


def _reference_bn(x, g, dtype):
    bn = nn.BatchNorm2d(6).train()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=torch.Generator()
                           .manual_seed(1))
        bn.bias.uniform_(-0.5, 0.5, generator=torch.Generator()
                         .manual_seed(2))
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    y = bn(xt)
    y.backward(torch.from_numpy(g).to(dtype))
    return y.detach(), xt.grad, bn


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sync_batchnorm_over_two_ranks_equals_batchnorm(ranks, dtype):
    """SyncBatchNorm with the rows split over the ranks against
    nn.BatchNorm2d on all of them: outputs and input gradients (float32:
    1e-5; bfloat16: one bf16 ulp of the output), the summed affine
    gradients, the running statistics (unbiased variance, n = the global
    count)."""
    x, g = bn_case()
    y, dx, bn = _reference_bn(x, g, dtype)
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
           else dict(rtol=2 ** -7, atol=1e-2))
    got = [r[f"bn_{dtype}"] for r in ranks]
    torch.testing.assert_close(torch.cat([r["y"] for r in got]).float(),
                               y.float(), **tol)
    torch.testing.assert_close(torch.cat([r["dx"] for r in got]).float(),
                               dx.float(), **tol)
    torch.testing.assert_close(sum(r["dw"] for r in got), bn.weight.grad,
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(sum(r["db"] for r in got), bn.bias.grad,
                               rtol=1e-4, atol=1e-4)
    for r in got:
        torch.testing.assert_close(r["running_mean"], bn.running_mean,
                                   rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(r["running_var"], bn.running_var,
                                   rtol=1e-6, atol=1e-6)


def test_sync_batchnorm_alone_is_batchnorm(rng):
    """Without a process group: the local batch's statistics, equal to
    nn.BatchNorm3d in training and eval, and the same state_dict keys."""
    x = torch.from_numpy((1.0 + rng.randn(2, 3, 4, 5, 6)).astype(
        np.float32))
    ref = nn.BatchNorm3d(3)
    sync = SyncBatchNorm(3)
    assert sorted(sync.state_dict()) == sorted(ref.state_dict())
    for _ in range(2):
        torch.testing.assert_close(sync(x), ref(x), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(sync.running_var, ref.running_var,
                               rtol=1e-6, atol=1e-6)
    assert int(sync.num_batches_tracked) == 2
    sync.eval()
    ref.eval()
    torch.testing.assert_close(sync(x), ref(x), rtol=1e-6, atol=1e-6)


def test_convert_keeps_parameters_keys_and_statistics():
    cfg = TrainConfig(model=dataclasses.replace(
        TrainConfig().model, numdepth_initial=8, numdepth=32))
    state = create_train_state(cfg, steps_per_epoch=1, device="cpu")
    before = {k: v for k, v in state.model.state_dict().items()}
    params = {k: p for k, p in state.model.named_parameters()}
    convert_sync_batchnorm(state.model)
    n_sync = sum(isinstance(m, SyncBatchNorm)
                 for m in state.model.modules())
    assert n_sync > 0 and not any(
        type(m) in (nn.BatchNorm2d, nn.BatchNorm3d)
        for m in state.model.modules())
    after = state.model.state_dict()
    assert list(after) == list(before)
    for k, p in state.model.named_parameters():
        assert p is params[k], k
    opt_params = {id(p) for g in state.optimizer.param_groups
                  for p in g["params"]}
    assert opt_params == {id(p) for p in params.values()}


def test_mesh_and_backend_resolution(monkeypatch):
    assert distributed.resolve_mesh(-1, 1, 1) == 1
    assert distributed.resolve_mesh(-1, 1, 4) == 4
    assert distributed.resolve_mesh(2, 1, 2) == 2
    with pytest.raises(ValueError, match="world has 1"):
        distributed.resolve_mesh(2, 1, 1)
    assert distributed.resolve_mesh(-1, 2, 4) == 2
    assert distributed.resolve_mesh(2, 2, 4) == 2
    with pytest.raises(ValueError, match="world has 1 process"):
        distributed.resolve_mesh(1, 2, 1)
    with pytest.raises(ValueError, match="world has 3 process"):
        distributed.resolve_mesh(-1, 2, 3)
    assert distributed.backend_for("cuda") == "nccl"
    assert distributed.backend_for("cuda:1") == "nccl"
    assert distributed.backend_for("cpu") == "gloo"
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert distributed.init_distributed("cpu") == (0, 1,
                                                   torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        distributed.init_distributed()


# ---------------------------------------------------------------------------
# the "shard" mode: JAX's shard_map step
# ---------------------------------------------------------------------------

def _capture_gradients():
    """An optax transformation that keeps the updates it is given (the
    clipped gradients) as its state."""
    import jax
    import jax.numpy as jnp
    import optax

    return optax.GradientTransformation(
        lambda params: {"g": jax.tree.map(jnp.zeros_like, params)},
        lambda updates, state, params=None: (updates, {"g": updates}))


class _Injected:
    """The JAX model with each shard's timesteps and noise taken from the
    batch (proj_matrices["train_overrides"], sharded with the rows), so
    make_train_step_shmap runs unchanged with injected noise."""

    def __init__(self, model):
        self.model = model

    def apply(self, variables, imgs, projs, depth_values, **kw):
        projs = dict(projs)
        ov = {int(s): tuple(v) for s, v in
              projs.pop("train_overrides").items()}
        return self.model.apply(variables, imgs, projs, depth_values,
                                train_overrides=ov, **kw)


@pytest.fixture(scope="module")
def jax_shard_step():
    """make_train_step_shmap of the JAX package on a two-device CPU mesh
    (make_mesh(2, 1) over conftest's CPU devices), from the port's initial
    weights (seed 0) carried over, on dp_case's CasDiffMVS batch with the
    same injected noise: (loss, the clipped pmean'd gradients and the
    pmean'd BatchNorm statistics as port state_dicts)."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from diffmvs_tpu.config import CASDIFFMVS
    from diffmvs_tpu.config import TrainConfig as JaxTrainConfig
    from diffmvs_tpu.models.casdiffmvs import CasDiffMVS as JaxCasDiffMVS
    from diffmvs_tpu.parallel.mesh import make_mesh, replicate
    from diffmvs_tpu.tools.torch_import import import_torch_state_dict
    from diffmvs_tpu.train.state import MVSTrainState
    from diffmvs_tpu.train.step import make_train_step_shmap
    from diffmvs_tpu_torch.tools.jax_import import state_dict_from_jax

    cfg, batch, overrides = dp_case("casdiffmvs", WORLD)
    cfg_j = dataclasses.replace(CASDIFFMVS, numdepth_initial=8, numdepth=32)
    port = create_train_state(cfg, steps_per_epoch=10, device="cpu", seed=0)
    variables = import_torch_state_dict(port.model.state_dict(), cfg_j)
    tx = optax.chain(optax.clip_by_global_norm(cfg.grad_clip),
                     _capture_gradients())
    mesh = make_mesh(WORLD, 1)
    state = replicate(mesh, MVSTrainState.create(
        apply_fn=None, params=variables["params"],
        batch_stats=variables["batch_stats"], tx=tx))
    jbatch = dict(batch, proj_matrices=dict(
        batch["proj_matrices"], train_overrides={
            str(s): [t.astype(np.int32), n]
            for s, (t, n) in overrides.items()}))
    jbatch = jax.device_put(jbatch, NamedSharding(mesh, P("data")))
    step = make_train_step_shmap(
        _Injected(JaxCasDiffMVS(cfg_j)),
        JaxTrainConfig(model=cfg_j, batch_size=cfg.batch_size), mesh,
        donate=False)
    new_state, scalars, _ = jax.device_get(
        step(state, jbatch, jax.random.PRNGKey(1)))
    grads = state_dict_from_jax({"params": new_state.opt_state[1]["g"],
                                 "batch_stats": new_state.batch_stats},
                                cfg.model)
    stats = state_dict_from_jax({"params": new_state.params,
                                 "batch_stats": new_state.batch_stats},
                                cfg.model)
    return float(scalars["loss"]), grads, stats


def test_shard_step_matches_jax_shard_map_step(ranks, jax_shard_step):
    """Every rank's "shard" step (nn.BatchNorm kept, its rows' noise from
    the global overrides) against JAX's shard_map step: the loss, the
    clipped averaged gradients and the averaged BatchNorm statistics."""
    loss_j, grads_j, stats_j = jax_shard_step
    for res in ranks:
        got = res["shard"][0]
        assert got["sync_bn"] == 0
        np.testing.assert_allclose(got["scalars"]["loss"], loss_j,
                                   rtol=2e-4)
        keys = sorted(got["grads"])
        ours = {k: got["grads"][k].double().flatten() for k in keys}
        ref = {k: grads_j[k].double().flatten() for k in keys}
        cos = _cosine(torch.cat([ours[k] for k in keys]),
                      torch.cat([ref[k] for k in keys]))
        assert cos > 0.9999, cos
        scale = max(float(r.abs().max()) for r in ref.values())
        for k in keys:
            nr = float(ref[k].norm())
            if nr < 1e-7 * scale:         # numerically dead leaf
                assert float(ours[k].norm()) < 1e-5 * scale + 1e-12, k
                continue
            assert _cosine(ours[k], ref[k]) > 0.999, k
            assert abs(float(ours[k].norm()) - nr) < 0.02 * nr \
                + 1e-5 * scale, k
        assert got["bn_calls"]
        for name, (calls, n) in got["bn_calls"].items():
            decay = 0.9 ** calls
            torch.testing.assert_close(
                got["buffers"][f"{name}.running_mean"],
                stats_j[f"{name}.running_mean"], rtol=1e-4, atol=1e-6)
            want = decay + (stats_j[f"{name}.running_var"] - decay) \
                * n / (n - 1)
            torch.testing.assert_close(
                got["buffers"][f"{name}.running_var"], want, rtol=1e-4,
                atol=1e-6)
        for k, v in ranks[0]["shard"][0]["grads"].items():
            assert torch.equal(got["grads"][k], v), k


def test_shard_step_is_the_mean_of_per_shard_steps(ranks):
    """The "shard" step drawing its noise from each rank's generator
    (seeded fold_seed(11, rank)) against the port's single-process step on
    each shard's rows with that generator: the ranks' gradients are the
    mean of the shards' (before the clip), their statistics the mean of
    the shards', their scalars the mean of the shards'."""
    from diffmvs_tpu_torch.train.step import (_split, batch_to_device,
                                              compute_gradients)

    cfg, batch, _ = dp_case("casdiffmvs", WORLD)
    seeds = [distributed.fold_seed(11, r) for r in range(WORLD)]
    assert len(set(seeds)) == WORLD and 11 not in seeds
    grads, stats, losses = [], [], []
    for r in range(WORLD):
        state = create_train_state(cfg, steps_per_epoch=10, device="cpu",
                                   seed=0)
        loss, _, _, _ = compute_gradients(
            state.model, cfg, batch_to_device(_split(batch, WORLD, r), "cpu"),
            generator=torch.Generator().manual_seed(seeds[r]))
        grads.append({k: p.grad.clone()
                      for k, p in state.model.named_parameters()})
        stats.append({k: v.clone() for k, v in
                      state.model.named_buffers() if "running_" in k})
        losses.append(float(loss))
    mean = {k: sum(g[k] for g in grads) / WORLD for k in grads[0]}
    norm = torch.cat([g.flatten() for g in mean.values()]).norm()
    clip = min(1.0, cfg.grad_clip / (float(norm) + 1e-6))
    for r, res in enumerate(ranks):
        got = res["shard"][1]
        assert got["seed"] == seeds[r]
        np.testing.assert_allclose(got["scalars"]["loss"],
                                   sum(losses) / WORLD, rtol=1e-6)
        for k, v in mean.items():
            torch.testing.assert_close(got["grads"][k], v * clip, rtol=0,
                                       atol=1e-5)
        for k in stats[0]:
            torch.testing.assert_close(
                got["buffers"][k], sum(s[k] for s in stats) / WORLD,
                rtol=1e-6, atol=1e-6)


def test_shard_mode_refuses_width_sharding():
    class Space:
        size = 2

    with pytest.raises(ValueError, match="'shard'.*sp = 2"):
        distributed.DataParallel(nn.Linear(2, 2), Space(), mode="shard")
    with pytest.raises(ValueError, match="mode 'ring'"):
        distributed.DataParallel(nn.Linear(2, 2), mode="ring")


@pytest.mark.parametrize("dp,sp", [(1, 1), (2, 1), (4, 1), (8, 1), (1, 2),
                                   (2, 2), (1, 4)])
def test_run_training_picks_shard_where_jax_does(tmp_path, monkeypatch,
                                                 dp, sp):
    """The JAX package's run_training, on a (dp, sp) mesh of conftest's
    CPU devices and each warp kernel, builds its shard_map step exactly
    where train/state.data_parallel_mode says "shard", and its GSPMD step
    where it says "global"."""
    import diffmvs_tpu.train.loop as jloop
    import diffmvs_tpu.train.step as jstep
    from diffmvs_tpu.config import CASDIFFMVS
    from diffmvs_tpu.config import TrainConfig as JaxTrainConfig
    from diffmvs_tpu.parallel.mesh import make_mesh

    from diffmvs_tpu_torch.train.state import data_parallel_mode

    built = []
    monkeypatch.setattr(jstep, "make_train_step_shmap",
                        lambda *a, **k: built.append("shard"))
    monkeypatch.setattr(jloop, "make_train_step",
                        lambda *a, **k: built.append("global"))
    monkeypatch.setattr(jloop, "make_eval_step", lambda *a, **k: None)
    for kernel in ("xla", "pallas", "pallas_full"):
        cfg = JaxTrainConfig(model=dataclasses.replace(
            CASDIFFMVS, warp_kernel=kernel), epochs=0)
        jloop.run_training(None, cfg, None, [], [], make_mesh(dp, sp),
                           str(tmp_path))
        assert built.pop() == data_parallel_mode(dp, sp, kernel), \
            (dp, sp, kernel)
    with pytest.raises(ValueError, match="warp_kernel 'auto'"):
        data_parallel_mode(2, 1, "auto")


# ---------------------------------------------------------------------------
# the figures the module docstring quotes:
#   python -m tests.test_torch_parallel     (from the repository's root)
# ---------------------------------------------------------------------------

def _relu_flips(cfg, batch, overrides):
    """The ReLU inputs (ConvBnReLU's BatchNorm outputs) of one
    single-process step whose sign differs between nn.BatchNorm and
    SyncBatchNorm: [(layer, index, with nn.BatchNorm, with SyncBN)]."""
    from diffmvs_tpu_torch.nn.layers import ConvBnAct
    from diffmvs_tpu_torch.parallel.distributed import convert_sync_batchnorm
    from diffmvs_tpu_torch.train.state import create_train_state
    from diffmvs_tpu_torch.train.step import train_step

    outs = []
    for sync_bn in (False, True):
        state = create_train_state(cfg, steps_per_epoch=10, device="cpu",
                                   seed=0)
        if sync_bn:
            convert_sync_batchnorm(state.model)
        seen = {}
        for name, m in state.model.named_modules():
            if isinstance(m, ConvBnAct) and m.relu:
                m.bn.register_forward_hook(
                    lambda mod, i, o, name=name: seen.setdefault(
                        name, []).append(o.detach().clone()) and None)
        train_step(state, cfg, batch, train_overrides=overrides)
        outs.append(seen)
    flips = []
    for name, ys in outs[0].items():
        for a, b in zip(ys, outs[1][name]):
            for idx in ((a > 0) != (b > 0)).nonzero().tolist():
                flips.append((name, idx, a[tuple(idx)].item(),
                              b[tuple(idx)].item()))
    return flips


def report():
    import tempfile

    torch.set_num_threads(4)
    with tempfile.TemporaryDirectory() as outdir:
        ranks = spawn_ranks(outdir)

    def line(what, got, sync, plain):
        keys = sorted(sync["grads"])
        d_sync = max((got["grads"][k] - sync["grads"][k]).abs().max().item()
                     for k in keys)
        d_plain, leaf = max(
            ((got["grads"][k] - plain["grads"][k]).abs().max().item(), k)
            for k in keys)
        cos = _cosine(torch.cat([got["grads"][k].flatten() for k in keys]),
                      torch.cat([plain["grads"][k].flatten() for k in keys]))
        stats = max((got["buffers"][k] - v).abs().max().item()
                    for ref in (sync, plain)
                    for k, v in ref["buffers"].items())
        print(f"{what}: grads max abs vs SyncBN step {d_sync:.2e}, vs "
              f"BatchNorm step {d_plain:.2e} ({leaf}, leaf max "
              f"{plain['grads'][leaf].abs().max().item():.2e}) at cosine "
              f"{cos:.8f}; statistics {stats:.2e}")

    for preset in PRESETS:
        cfg, batch, overrides = dp_case(preset, WORLD)
        sync = run_steps(cfg, batch, overrides, (0, 1), sync_bn=True)
        plain = run_steps(cfg, batch, overrides, (0, 1))
        for step in range(2):
            line(f"{preset} step {step}", ranks[0][preset][step],
                 sync[step], plain[step])
        if preset == "casdiffmvs":
            for flip in _relu_flips(cfg, batch, overrides):
                print("  ReLU input of other sign (layer, index, "
                      "BatchNorm, SyncBN):", flip)


if __name__ == "__main__":
    report()
