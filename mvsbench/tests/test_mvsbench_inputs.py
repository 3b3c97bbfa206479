"""Inputs from the seed: the same seed gives the same values, another
seed others at the same sizes; large seeds; the sample of answers."""

import pytest
import torch

from mvsbench import inputs as I
from mvsbench import manifest
from mvsbench.tests import toy

CONFIG = toy.toy_config("casdiffmvs-dtu")
BIG = 2 ** 31 + 12345


def test_weights_deterministic_and_loadable():
    a = I.make_weights(CONFIG, BIG, "cpu")
    b = I.make_weights(CONFIG, BIG, "cpu")
    c = I.make_weights(CONFIG, BIG + 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)
    ref = I.reference_model(CONFIG, "cpu")
    ref.load_state_dict(a, strict=True)
    w = a["feature.conv0.0.conv.weight"]
    assert w.abs().max() <= 1 / (3 * 9) ** 0.5


def test_viewsets_and_batches():
    a = I.viewsets(CONFIG, 2, BIG, "cpu")
    b = I.viewsets(CONFIG, 2, BIG, "cpu")
    c = I.viewsets(CONFIG, 2, BIG + 7, "cpu")
    assert torch.equal(a[0], b[0]) and not torch.equal(a[0], c[0])
    assert a[0].shape == c[0].shape == (2, 3, 64, 96, 3)
    assert set(a[1]) == {"stage1", "stage2", "stage3", "stage4"}
    traffic = toy.TOY_TRAFFIC["train2"]
    batch = I.train_batch(CONFIG, traffic, BIG, 1, "cpu")
    d = batch["depth"]["stage4"]
    assert d.shape == (2, 64, 96) and 4.0 < d.min() and d.max() < 10.0
    assert batch["depth"]["stage1"].shape == (2, 8, 12)
    share = batch["mask"]["stage4"].mean()
    assert 0.5 < share < 1.0


def test_sample_and_unit_seeds():
    s = I.sample(BIG, 8, 4, 16)
    assert s == I.sample(BIG, 8, 4, 16) and len(set(s)) == 4
    assert all(0 <= u < 8 and 0 <= r < 16 for u, r in s)
    assert len({u for u, _ in s}) == 4
    assert I.unit_seed(BIG, 0) != I.unit_seed(BIG, 1)


@pytest.mark.parametrize("seed", [BIG + k for k in range(40)])
def test_sample_covers_every_quarter_of_the_batch(seed):
    """One answer in each quarter of a batch of 16 rows on every seed, so
    a fault confined to half the batch is compared; one row a request."""
    rows = sorted(r for _, r in I.sample(seed, 8, 4, 16))
    assert [r // 4 for r in rows] == [0, 1, 2, 3]
    req = I.sample(seed, 48, 4, 1)
    assert len({u for u, _ in req}) == 4 and {r for _, r in req} == {0}
    assert 0 <= I.unit_seed(2 ** 40, -3) < 2 ** 63


def test_traffic_files_name_a_kind():
    for path in (manifest.HERE / "traffic").glob("*.json"):
        t = manifest.read_json(path)
        assert t["kind"] in ("batch", "request", "train"), path
        assert t["batch"] >= 1 and t["trace_units"] >= 1
