import torch

from port_bench import traffic
from port_bench.conftest import ROOT

MIX = {"series": 64, "length": 50, "pool": 2, "gap_mean": 1.0, "nan_share": 0.3,
       "label_share": 0.1}


def draw(seed, mix=MIX):
    return traffic.generate(mix, 21, 10, torch.Generator().manual_seed(seed), "cpu")


def test_same_seed_same_batches():
    a, b = draw(2**31 + 7), draw(2**31 + 7)
    for x, y in ((a.x, b.x), (a.static, b.static), (a.labels, b.labels)):
        assert torch.equal(torch.nan_to_num(x, nan=-9.0), torch.nan_to_num(y, nan=-9.0))
        assert torch.equal(torch.isnan(x), torch.isnan(y))


def test_other_seed_other_batches():
    assert not torch.equal(torch.nan_to_num(draw(1).x), torch.nan_to_num(draw(2).x))


def test_series_shape_times_and_holes():
    b = draw(5)
    assert b.x.shape == (2, 64, 50, 21) and b.static.shape == (2, 64, 10)
    assert b.labels.shape == (2, 64, 50)
    times = b.x[..., 0]
    assert not torch.isnan(times).any()
    assert (times[..., 0] == 0).all() and (times.diff(dim=-1) >= 0).all()
    gaps = times.diff(dim=-1)
    assert abs(float(gaps.mean()) - MIX["gap_mean"]) < 0.1
    holes = torch.isnan(b.x[..., 1:]).double().mean()
    assert abs(float(holes) - MIX["nan_share"]) < 0.02
    assert abs(float(b.labels.mean()) - MIX["label_share"]) < 0.02


def test_every_mix_file_loads():
    for path in (ROOT / "port_bench" / "traffic").glob("*.json"):
        params = traffic.load(ROOT, path.stem)
        assert all(params[k] > 0 for k in ("series", "length", "pool"))
