"""PyTorch port: width sharding (parallel/spatial.py, the mesh's "space"
axis, TrainConfig.sp) on the CPU, in gloo groups of spawned ranks.

The ranks run run_rank / run_cli_rank below: spawned (a fresh interpreter
that imports this module, and no JAX), joined with a timeout and killed
on it. Four ranks form the (dp, sp) = (2, 2) mesh (space groups {0, 1}
and {2, 3}) and one space group of four; two more run the training CLI
with --sp 2. The widths split unevenly: 160 columns over 2 ranks are 96 /
64, over 4 ranks 64 / 32 / 32 / 32; the model's 96 over 2 are 64 / 32.

Gates, with their reasons:
  * each sharded module against the unsharded module on the same input
    (outputs and input gradients joined over the ranks, parameter
    gradients summed): rtol 1e-6 / atol 1e-6 for the outputs and 1e-5
    for the gradients. The halo convolutions compute the same sums, but
    the CPU's convolution picks its algorithm by the map's width (a 3x3
    conv over 32 + 2 and over 48 + 2 columns sums in other orders), and
    the sharded GroupNorm takes its moments in float64 where
    F.group_norm takes them in float32;
  * the plain warp with a column offset: bit-equal to the full warp's
    columns (geometry/warp.py);
  * the sharded export forward against the port's unsharded forward:
    the final depth and the confidences rtol 1e-5 / atol 1e-5 (measured:
    final depth max rel 2.1e-6, max abs 1.1e-5 at depths of 5-10), the
    intermediate depths rtol 1e-4 / atol 1e-4, every entry's mean
    relative difference below 1e-5 (measured <= 5.8e-7). Stage 0 agrees
    to 2e-7; the refinement stages' GroupNorms and the convolutions above
    turn those last-bit differences into up to 1.1e-5 relative through
    random weights. Against JAX's sharded forward on a (1, 2) mesh: rtol
    5e-3 / atol 5e-3, the port-vs-JAX model tolerance of
    tests/test_torch_model.py (measured 2.9e-4);
  * a (2, 2) training step against the single-process step on the whole
    batch (nn.BatchNorm): loss rtol 1e-5, gradient cosine > 0.9999,
    BatchNorm running statistics rtol 1e-4 / atol 1e-6 (measured: loss
    2.8e-7, cosine 0.99999995); against the loss of JAX's training
    forward on a (2, 2) mesh: rtol 2e-4 (measured 7.0e-8)
    (tests/test_torch_train.py). JAX's gradient of it is not taken: its
    value_and_grad takes ~55 s to compile on a CPU host, the forward
    ~16 s.
The JAX model takes the port's weights through the JAX package's importer
of reference state_dicts (tools/torch_import.py).
  * the CLI with --sp 2 against the CLI on one process: the first step's
    loss and the validation loss rtol 1e-4.
"""

import dataclasses
import multiprocessing as mp
import os
import socket
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn as nn

from diffmvs_tpu_torch.parallel import spatial

WORLD = 4
MOD_WIDTH = 160
SHAPE = dict(b=2, v=3, h=32, w=96)
SMALL = dict(numdepth_initial=8, numdepth=32)
T = torch.from_numpy


# ---------------------------------------------------------------------------
# cases (numpy and torch only: the ranks import no JAX)
# ---------------------------------------------------------------------------

def module_cases():
    """{name: (module maker, [(input channels / shape head, stride)])}:
    every input [2, C, (D,) 5, MOD_WIDTH / stride]."""
    from diffmvs_tpu_torch.geometry.upsample import upsample_with_mask
    from diffmvs_tpu_torch.nn import layers, unet

    class ConvexUp(nn.Module):
        def forward(self, depth, mask):
            return upsample_with_mask(depth[:, 0], mask, 2,
                                      getattr(self, "space", None))

    return {
        "conv3x3": (lambda: layers.Conv2d(6, 8, 3, padding=1),
                    [((6,), 2)]),
        "conv5x5_s2": (lambda: layers.Conv2d(6, 8, 5, 2, 2, bias=False),
                       [((6,), 1)]),
        "conv3x3_s2": (lambda: layers.Conv2d(6, 8, 3, 2, 1), [((6,), 2)]),
        "conv1x1_s2": (lambda: layers.Conv2d(6, 8, 1, 2), [((6,), 2)]),
        "conv7x7": (lambda: layers.Conv2d(6, 4, 7, padding=3),
                    [((6,), 4)]),
        "sepconv_gru": (lambda: layers.SepConvGRU(4, 6),
                        [((4,), 8), ((6,), 8)]),
        "conv3d": (lambda: layers.Conv3d(4, 6, 3, padding=1, bias=False),
                   [((4, 3), 8)]),
        "conv3d_s2": (lambda: layers.Conv3d(4, 6, 3, 2, 1), [((4, 4), 8)]),
        "deconv3d": (lambda: layers.ConvTranspose3d(
            6, 4, 3, stride=2, padding=1, output_padding=1, bias=False),
            [((6, 2), 32)]),
        "wsconv": (lambda: unet.WSConv(6, 8, 3, padding=1), [((6,), 4)]),
        "groupnorm": (lambda: unet.GroupNorm(4, 8), [((8,), 4)]),
        "convex_upsample": (ConvexUp, [((1,), 8), ((36,), 8)]),
    }


def module_inputs(name):
    """The case's full-width numpy inputs and its output cotangent
    (shaped by the unsharded module's output)."""
    rng = np.random.RandomState(sorted(module_cases()).index(name))
    _, specs = module_cases()[name]
    xs = [rng.randn(2, *head, 5, MOD_WIDTH // f).astype(np.float32)
          for head, f in specs]
    return xs, rng


def make_module(name):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        m = module_cases()[name][0]()
        if isinstance(m, nn.GroupNorm):
            with torch.no_grad():
                m.weight.uniform_(0.5, 1.5)
                m.bias.uniform_(-0.5, 0.5)
    return m


def cols(width, rank, size):
    """This rank's columns of a map `width` wide (MOD_WIDTH's split)."""
    start, stop = spatial.split_columns(MOD_WIDTH, size)[rank]
    f = MOD_WIDTH // width
    return slice(start // f, stop // f)


def module_result(name, rank=0, size=1, space=None):
    """(output, input gradients, parameter gradients) of the case on this
    rank's columns (space None: the whole map)."""
    m = make_module(name)
    if space is not None:
        spatial.shard_width(m, space)
    xs, rng = module_inputs(name)
    ins = [T(np.ascontiguousarray(x[..., cols(x.shape[-1], rank, size)]))
           .requires_grad_() for x in xs]
    out = m(*ins)
    g = rng.randn(*out.shape[:-1], _full_out_width(name)).astype(np.float32)
    out.backward(T(np.ascontiguousarray(
        g[..., cols(g.shape[-1], rank, size)])))
    return (out.detach(), [x.grad for x in ins],
            {k: p.grad for k, p in m.named_parameters()})


def _full_out_width(name):
    with torch.no_grad():
        xs, _ = module_inputs(name)
        return make_module(name)(*[T(x) for x in xs]).shape[-1]


def model_case():
    """(ModelConfig, numpy batch with GT and partial masks, global
    train_overrides) of the forward and step cases."""
    from diffmvs_tpu_torch.config import MODEL_PRESETS
    from diffmvs_tpu_torch.utils.synthetic import (
        synthetic_train_batch, synthetic_train_overrides)

    cfg = dataclasses.replace(MODEL_PRESETS["casdiffmvs"], **SMALL)
    b, v, h, w = SHAPE["b"], SHAPE["v"], SHAPE["h"], SHAPE["w"]
    batch = synthetic_train_batch(b, v, h, w, 32, seed=4)
    rng = np.random.RandomState(5)
    for s, arr in sorted(batch["depth"].items()):
        arr[:, :1, :2] = 0.0
        batch["mask"][s] = (rng.rand(*arr.shape) < 0.7).astype(np.float32)
    return cfg, batch, synthetic_train_overrides(cfg, b, h, w, seed=6)


def port_weights(cfg):
    """{"train": the port's weights (torch's initialization from seed 0),
    "export": the same with random BatchNorm running statistics}."""
    from diffmvs_tpu_torch.models.casdiffmvs import CasDiffMVS

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        train = CasDiffMVS(cfg).state_dict()
    rng = np.random.RandomState(1)
    export = dict(train)
    for k, v in train.items():
        if k.endswith("running_mean"):
            export[k] = T(rng.normal(0.0, 0.5, v.shape).astype(np.float32))
        elif k.endswith("running_var"):
            export[k] = T(rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
    return {"train": train, "export": export}


def local_batch(batch, rows, space):
    """Rows (d, D) and space rank / size (s, S) of a numpy batch."""
    from diffmvs_tpu_torch.train.step import _split

    return spatial.column_slice(_split(batch, rows[1], rows[0]), *space)


def step_results(state, scalars):
    return {"scalars": {k: float(v) for k, v in scalars.items()},
            "grads": {k: p.grad.detach().clone()
                      for k, p in state.model.named_parameters()},
            "buffers": {k: v.detach().clone()
                        for k, v in state.model.named_buffers()}}


def one_step(cfg, state_dict, batch, overrides=None, generator=None,
             space=None):
    """step_results of one train_step from `state_dict` (under `space`, a
    DataParallel with it over the world)."""
    from diffmvs_tpu_torch.config import TrainConfig
    from diffmvs_tpu_torch.parallel.distributed import DataParallel
    from diffmvs_tpu_torch.train.state import create_train_state
    from diffmvs_tpu_torch.train.step import train_step

    tcfg = TrainConfig(model=cfg, batch_size=SHAPE["b"])
    state = create_train_state(tcfg, steps_per_epoch=10, device="cpu",
                               state_dict=state_dict)
    dp = None if space is None else DataParallel(state.model, space)
    scalars, _ = train_step(state, tcfg, batch, generator=generator,
                            train_overrides=overrides, dp=dp)
    return step_results(state, scalars)


def export_forward(model, batch):
    with torch.no_grad():
        return model(T(np.ascontiguousarray(batch["imgs"])),
                     {k: T(v) for k, v in batch["proj_matrices"].items()},
                     T(batch["depth_values"]), export=True)


# ---------------------------------------------------------------------------
# the ranks (spawned: torch and the port only)
# ---------------------------------------------------------------------------

def run_rank(rank, world_size, port, cli_port, outdir, cli_argv):
    """Ranks 0-3: the module cases in space groups of 2 and 4, the export
    forward and two steps on the (2, 2) mesh; then ranks 0 and 1 run the
    training CLI with --sp 2 in a group of their own, as torchrun would
    start them."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world_size, rank=rank)
    try:
        from diffmvs_tpu_torch.models.casdiffmvs import CasDiffMVS
        from diffmvs_tpu_torch.parallel.distributed import space_group

        groups = {2: space_group(2), 4: space_group(4)}
        res = {"modules": {}}
        for name in module_cases():
            res["modules"][name] = {
                size: module_result(name, space.rank, size, space)
                for size, space in groups.items()}

        cfg, batch, overrides = model_case()
        weights = port_weights(cfg)
        space = groups[2]
        mine = local_batch(batch, (rank // 2, 2), (space.rank, 2))
        model = CasDiffMVS(cfg)
        model.load_state_dict(weights["export"], strict=True)
        spatial.shard_width(model.eval(), space)
        res["export"] = export_forward(model, mine)
        res["steps"] = [
            one_step(cfg, weights["train"], mine, overrides=overrides,
                     space=space),
            one_step(cfg, weights["train"], mine, space=space,
                     generator=torch.Generator().manual_seed(11))]
    finally:
        dist.destroy_process_group()
    # before the CLI: its TensorBoard writer may import TensorFlow, which
    # can import JAX
    res["jax_modules"] = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "flax", "diffmvs_tpu"))

    if rank < 2:
        from diffmvs_tpu_torch.cli import train

        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(cli_port),
                          WORLD_SIZE="2", RANK=str(rank),
                          LOCAL_RANK=str(rank))
        out = train.main(cli_argv)
        model = out["state"].model
        res["cli"] = {"space": (model.space.rank, model.space.size),
                      "step": out["state"].step,
                      "weights": model.state_dict()}
    torch.save(res, os.path.join(outdir, f"rank{rank}.pt"))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(outdir, cli_argv):
    ctx = mp.get_context("spawn")
    ports = (_free_port(), _free_port())
    procs = [ctx.Process(target=run_rank,
                         args=(r, WORLD) + ports + (outdir, cli_argv))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    return procs


def join_ranks(procs, outdir, timeout=150):
    """Every rank's results, the ranks joined with a timeout and killed on
    it."""
    for p in procs:
        p.join(timeout=timeout)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    assert not hung, f"a rank did not finish in {timeout} s"
    assert [p.exitcode for p in procs] == [0] * len(procs)
    return [torch.load(os.path.join(outdir, f"rank{r}.pt"),
                       weights_only=False) for r in range(len(procs))]


# ---------------------------------------------------------------------------
# the run: JAX and the single-process references in the parent, while the
# ranks run
# ---------------------------------------------------------------------------

def _cli_argv(root, logdir, *extra):
    return ["--dataset", "blend", "--trainpath", str(root),
            "--trainlist", str(root / "list.txt"),
            "--testlist", str(root / "list.txt"), "--trainviews", "3",
            "--testviews", "3", "--numdepth_initial", "8", "--numdepth",
            "32", "--batch_size", "4", "--epochs", "1", "--summary_freq",
            "1", "--logdir", str(logdir), "--device", "cpu", *extra]


def _jax_mesh_batch(dp, sp, batch):
    from diffmvs_tpu.parallel.mesh import make_mesh, shard_batch

    return shard_batch(make_mesh(dp, sp), batch)


def _jax_references(batch, overrides, weights):
    """JAX's export forward with the width sharded over a (1, 2) mesh and
    its training loss on a (2, 2) mesh (the overrides' noise), from the
    port's weights (the JAX package's importer of reference
    state_dicts): (export lists, loss)."""
    import jax
    import jax.numpy as jnp

    from diffmvs_tpu.config import CASDIFFMVS
    from diffmvs_tpu.models import loss as jloss
    from diffmvs_tpu.models.casdiffmvs import CasDiffMVS as JaxCasDiffMVS
    from diffmvs_tpu.tools.torch_import import import_torch_state_dict

    cfg = dataclasses.replace(CASDIFFMVS, **SMALL)
    model = JaxCasDiffMVS(cfg)
    export_vars, train_vars = (
        import_torch_state_dict({k: v.numpy() for k, v in sd.items()}, cfg)
        for sd in (weights["export"], weights["train"]))
    inputs = {k: batch[k] for k in ("imgs", "proj_matrices",
                                    "depth_values")}
    export = jax.jit(lambda v, b: model.apply(
        v, b["imgs"], b["proj_matrices"], b["depth_values"], rng=None,
        train=False, export=True))(export_vars,
                                   _jax_mesh_batch(1, 2, inputs))
    ov = {s: (jnp.asarray(t), jnp.asarray(n))
          for s, (t, n) in overrides.items()}

    @jax.jit
    def loss(variables, b):
        out, _ = model.apply(
            variables, b["imgs"], b["proj_matrices"], b["depth_values"],
            depth_gt=b["depth"], rng=None, train=True,
            mutable=["batch_stats"], train_overrides=ov)
        return jloss.compute_inverse_loss(
            out["depth"], out["conf"], b["depth"], b["mask"],
            b["depth_values"], cfg.stage_iters, 0.9, 0.05)[0]

    return ({k: [np.asarray(x) for x in export[k]]
             for k in ("depth", "photometric_confidence")},
            float(loss(train_vars, _jax_mesh_batch(2, 2, batch))))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """{"ranks": each rank's results, "jax": (export lists, step loss),
    "single": the port's unsharded export forward and steps, "cli": the
    CLI log directories (one process, two ranks)}."""
    from test_torch_train_cli import _make_blend_scene

    from diffmvs_tpu_torch.cli import train
    from diffmvs_tpu_torch.models.casdiffmvs import CasDiffMVS

    root = tmp_path_factory.mktemp("sp")
    _make_blend_scene(root, "synth")
    (root / "list.txt").write_text("synth\n")
    procs = start_ranks(str(root), _cli_argv(root, root / "log_sp", "--sp",
                                             "2"))
    try:
        cfg, batch, overrides = model_case()
        weights = port_weights(cfg)
        out = {"jax": _jax_references(batch, overrides, weights)}
        model = CasDiffMVS(cfg)
        model.load_state_dict(weights["export"], strict=True)
        out["single"] = {
            "export": export_forward(model.eval(), batch),
            "steps": [one_step(cfg, weights["train"], batch,
                               overrides=overrides),
                      one_step(cfg, weights["train"], batch,
                               generator=torch.Generator().manual_seed(11))]}
        train.main(_cli_argv(root, root / "log_one"))
    finally:
        out["ranks"] = join_ranks(procs, str(root))
    out["cli"] = (root / "log_one", root / "log_sp")
    return out


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def test_ranks_import_no_jax(run):
    for res in run["ranks"]:
        assert res["jax_modules"] == []


def test_split_columns_is_even_and_aligned():
    assert spatial.split_columns(1600, 4) == [(0, 416), (416, 832),
                                              (832, 1216), (1216, 1600)]
    assert spatial.split_columns(96, 2) == [(0, 64), (64, 96)]
    assert spatial.split_columns(MOD_WIDTH, 4) == [(0, 64), (64, 96),
                                                   (96, 128), (128, 160)]
    with pytest.raises(ValueError, match="multiple of 32"):
        spatial.split_columns(100, 2)
    with pytest.raises(ValueError, match="fewer than 4 blocks"):
        spatial.split_columns(96, 4)


@pytest.mark.parametrize("name", sorted(module_cases()))
@pytest.mark.parametrize("size", [2, 4])
def test_sharded_module_equals_unsharded(run, name, size):
    """Outputs and input gradients joined over the space group, parameter
    gradients summed over it, against the module on the whole map."""
    out, dxs, grads = module_result(name)
    group = range(size)
    got = [run["ranks"][r]["modules"][name][size] for r in group]
    torch.testing.assert_close(torch.cat([g[0] for g in got], -1), out,
                               rtol=1e-6, atol=1e-6)
    for i, dx in enumerate(dxs):
        torch.testing.assert_close(torch.cat([g[1][i] for g in got], -1),
                                   dx, **_grad_tol(dx))
    for k, v in grads.items():
        torch.testing.assert_close(sum(g[2][k] for g in got), v,
                                   **_grad_tol(v), msg=lambda m: f"{k}: {m}")


def _grad_tol(ref):
    """rtol 1e-5, atol 1e-6 of the largest element: a gradient sums its
    terms in another order on each shard."""
    return dict(rtol=1e-5, atol=1e-6 * float(ref.abs().max()))


def test_sharded_modules_keep_state_dict_keys():
    """shard_width converts in place: the same parameter objects and
    state_dict keys; an unknown spatial module is refused."""
    from diffmvs_tpu_torch.config import MODEL_PRESETS
    from diffmvs_tpu_torch.models.casdiffmvs import CasDiffMVS
    from diffmvs_tpu_torch.nn import layers, unet

    model = CasDiffMVS(dataclasses.replace(MODEL_PRESETS["casdiffmvs"],
                                           **SMALL))
    keys = list(model.state_dict())
    params = dict(model.named_parameters())
    space = spatial.SpaceGroup(None, 0, 2)
    spatial.shard_width(model, space)
    assert list(model.state_dict()) == keys
    assert all(p is params[k] for k, p in model.named_parameters())
    assert model.space is space
    kinds = {type(m) for m in model.modules()}
    assert not kinds & {layers.Conv2d, layers.Conv3d, layers.ConvTranspose3d,
                        unet.WSConv, unet.GroupNorm}
    assert {layers.SpaceConv2d, layers.SpaceConv3d,
            layers.SpaceConvTranspose3d, unet.SpaceWSConv,
            unet.SpaceGroupNorm} <= kinds
    with pytest.raises(TypeError, match="Conv2d"):
        spatial.shard_width(nn.Sequential(nn.Conv2d(1, 1, 3)), space)


def test_plain_warp_with_offset_is_the_full_warps_columns():
    """A column shard of the depths with its offset, against the whole
    source: bit-equal to the full warp's columns."""
    from diffmvs_tpu_torch.ops.correlation import warp_and_correlate_plain

    from test_torch_ops import _corr_case

    rng = np.random.RandomState(0)
    for case in ("refine", "sweep"):
        src, ref, sp, rp, depths, _ = _corr_case(rng, case)
        full = warp_and_correlate_plain(T(src), T(ref), T(sp), T(rp),
                                        T(depths), 4)
        for start, stop in ((0, 32), (32, 64), (64, 96)):
            got = warp_and_correlate_plain(
                T(src), T(np.ascontiguousarray(ref[:, :, start:stop])),
                T(sp), T(rp),
                T(np.ascontiguousarray(depths[..., start:stop])), 4,
                x_off=start)
            assert torch.equal(got, full[:, :, :, start:stop]), (case,
                                                                 start)


def _joined(ranks, key):
    """A list output of the (2, 2) ranks, each entry joined: columns over
    each space group, rows over the data groups."""
    out = []
    for i in range(len(ranks[0]["export"][key])):
        out.append(torch.cat([
            torch.cat([ranks[2 * d + s]["export"][key][i] for s in range(2)],
                      -1) for d in range(2)], 0))
    return out


def test_sharded_export_forward_equals_unsharded(run):
    """The export forward on the (2, 2) mesh (rows over data ranks, the
    64 / 32 column split over space ranks) against the port's forward on
    the whole batch and against JAX's forward with the width sharded over
    a (1, 2) mesh."""
    want, want_jax = run["single"]["export"], run["jax"][0]
    for key in ("depth", "photometric_confidence"):
        got = _joined(run["ranks"], key)
        assert len(got) == len(want[key]) == len(want_jax[key])
        for i, (g, w, j) in enumerate(zip(got, want[key], want_jax[key])):
            final = key != "depth" or i == len(got) - 1
            tol = 1e-5 if final else 1e-4
            torch.testing.assert_close(g, w, rtol=tol, atol=tol)
            rel = ((g - w).abs() / w.abs().clamp_min(1e-6)).mean().item()
            assert rel < 1e-5, (key, i, rel)
            np.testing.assert_allclose(g.numpy(), j, rtol=5e-3, atol=5e-3)


def _cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()).clamp_min(1e-300))


def test_dp_sp_step_equals_single_process_step(run):
    """Two single steps on the (2, 2) mesh from the same weights, the
    first given the global batch's overrides, the second drawing them
    from a seeded generator: every rank's scalars, gradients and
    BatchNorm statistics against the single-process step on the whole
    batch; the first step's loss against JAX's on a (2, 2) mesh."""
    ranks = run["ranks"]
    for res in ranks:
        for i, (got, want) in enumerate(zip(res["steps"],
                                            run["single"]["steps"])):
            np.testing.assert_allclose(got["scalars"]["loss"],
                                       want["scalars"]["loss"], rtol=1e-5)
            keys = sorted(want["grads"])
            cos = _cosine(torch.cat([got["grads"][k].flatten()
                                     for k in keys]),
                          torch.cat([want["grads"][k].flatten()
                                     for k in keys]))
            assert cos > 0.9999, (i, cos)
            for k, v in want["buffers"].items():
                torch.testing.assert_close(got["buffers"][k], v, rtol=1e-4,
                                           atol=1e-6, msg=lambda m: k)
            for k in keys:      # DDP leaves every rank the same gradients
                assert torch.equal(got["grads"][k],
                                   ranks[0]["steps"][i]["grads"][k]), k
        np.testing.assert_allclose(res["steps"][0]["scalars"]["loss"],
                                   run["jax"][1], rtol=2e-4)


def test_train_cli_with_sp(run):
    """cli/train.py --sp 2 in two gloo ranks (64 / 32 columns of the 96):
    one step of B = 4 and the validation, against the same CLI on one
    process; rank 0 logs and saves, the ranks' weights stay equal."""
    import json

    res = [r["cli"] for r in run["ranks"][:2]]
    assert [r["space"] for r in res] == [(0, 2), (1, 2)]
    assert [r["step"] for r in res] == [1, 1]
    for k, v in res[0]["weights"].items():
        assert torch.equal(v, res[1]["weights"][k]), k

    def records(logdir):
        return [json.loads(line) for line in open(logdir / "scalars.jsonl")]

    one, sp = (records(d) for d in run["cli"])
    assert [(r["mode"], r["step"]) for r in sp] == \
        [(r["mode"], r["step"]) for r in one] == [("train", 0),
                                                  ("full_test", 1)]
    for a, b in zip(sp, one):
        assert np.isfinite(a["loss"])
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
    assert (run["cli"][1] / "model_000000.ckpt").exists()
