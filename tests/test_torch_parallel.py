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
    with pytest.raises(ValueError, match="width sharding"):
        distributed.resolve_mesh(1, 2, 1)
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
