"""Each kernel's logical count at small shapes, and its recorder on the
arguments the port's wrapper takes."""

from types import SimpleNamespace

import pytest
import torch

from portbench.harness import files, merl, peaks

K = files.kernels()


def _dirs(z):
    return torch.tensor([[0.0, 0.0, 1.0] if up else [0.0, 0.0, -1.0] for up in z])


def test_k1_two_halves():
    table = torch.zeros(2, 4, 4, 8, 3)
    wi = _dirs([1, 1, 1, 0])
    wo = _dirs([1, 0, 1, 1])
    wo_b = _dirs([1, 1, 0, 1])
    mask = torch.tensor([True, True, False, True])
    mask_b = torch.tensor([True, False, False, True])
    rec = K["k1"].record((table, wi, wo, None, mask, wo_b, mask_b), {}, None)
    # live: mask 3 + mask_b 2; either half live on lanes 0, 1, 3; evaluate
    # (live, wi and wo up): half a lane 0; half b lane 0 -> 2
    # both evaluating half-lanes look up straight up: theta_h = theta_d = 0
    # clamp to bin 0, phi_d's corners wrap to bins 7 and 0 -> 2 bins
    assert rec == {"lanes": 4, "halves": 2, "either": 3, "live": 5, "evaluates": 2, "bins": 2}
    nbytes, ops = K["k1"].work(rec)
    assert nbytes == 3 * 16 + 5 * 12 + 4 * 2 * 13 + 2 * 12
    assert ops == 2 * 170


def test_k1_one_half_no_mask_reads_at_most_the_table():
    table = torch.zeros(1, 1, 1, 1, 3)
    wi = _dirs([1, 1])
    rec = K["k1"].record((table, wi, wi), {}, None)
    assert rec["evaluates"] == 2 and rec["live"] == 2
    assert K["k1"].work(rec)[0] == 2 * 16 + 2 * 12 + 2 * 13 + 12


def test_corner_bins_touch_eight_bins_inside_the_table():
    table_shape = (3, 90, 90, 180, 3)
    wi = torch.tensor([[0.3, 0.1, 0.9487]])
    wo = torch.tensor([[-0.2, 0.4, 0.8944]])
    bins = merl.corner_bins(table_shape, wi, wo, torch.tensor([2]))
    assert bins.unique().numel() == 8
    assert ((bins >= 2 * 90 * 90 * 180) & (bins < 3 * 90 * 90 * 180)).all()


def test_k1bwd_counts_each_touched_bin_once():
    table = torch.zeros(2, 4, 4, 8, 3)
    wi = _dirs([1, 1, 1, 0])
    wo = _dirs([1, 1, 1, 1])
    g = torch.tensor([[1.0, 0, 0], [0, 0, 0], [0, 2.0, 0], [1.0, 1, 1]])
    slot = torch.tensor([0, 0, 1, 1])
    rec = K["k1bwd"].record((table, g, wi, wo, slot), {}, None)
    # lanes 0-2 evaluate; lane 1's cotangent is 0; lanes 0 and 2 add into
    # slots 0 and 1: 2 bins each
    assert rec == {"lanes": 4, "halves": 1, "either": 4, "live": 4, "evaluates": 3, "bins": 4}
    nbytes, ops = K["k1bwd"].work(rec)
    assert nbytes == 4 * 16 + 4 * 36 + 4 + 4 * 12
    assert ops == 3 * (170 + 72)


def test_k2():
    cdf = torch.zeros(6, 32, 64)
    valid = torch.tensor([True, False, True])
    lanes = [torch.zeros(3)] * 7 + [valid]
    rec = K["k2"].record((cdf, *lanes), {}, None)
    assert rec == {"lanes": 3, "live": 2, "cdf_bytes": cdf.numel() * 4}
    assert K["k2"].work(rec) == (2 * 256 + 2 * 24 + 3 * 17, 2 * 220)


@pytest.mark.parametrize("name,out", [("k3", 16), ("k4", 1)])
def test_k3_k4(name, out):
    ray = SimpleNamespace(o=torch.zeros(5, 3), d=torch.zeros(5, 3),
                          maxt=torch.tensor([1.0, 0.0, float("inf"), 0.0, 2.0]))
    rec = dict(K[name].record((None, ray), {}, None), prims=100)
    assert rec == {"lanes": 5, "live": 3, "prims": 100}
    assert K[name].work(rec) == (5 * (4 + out) + 3 * 24 + 100 * 36, 0)


def test_bound_takes_the_larger_side():
    peak = peaks.of("NVIDIA H100 80GB HBM3")
    assert peaks.bound_s(3.35e12, 0, peak) == pytest.approx(1.0)
    assert peaks.bound_s(0, 67e12, peak) == pytest.approx(1.0)
    assert peaks.of("cpu") is None


def test_every_kernel_file_has_its_parts():
    for name, k in K.items():
        assert isinstance(k.TRACE_NAME, str) and len(k.WRAPPER) == 2, name
        assert callable(k.record) and callable(getattr(k, "work", len))
    # no trace name holds another's: a launch is counted for one kernel
    names = [k.TRACE_NAME for k in K.values()]
    assert not [a for a in names for b in names if a != b and a in b]


@pytest.mark.parametrize("name,kind", [("t1", "delta"), ("t2", "ratio"), ("t1bwd", "delta"),
                                       ("t2bwd", "ratio")])
def test_tracking_kernels_record_their_own_kind(name, kind):
    rays = torch.zeros(7, 3)
    other = "ratio" if kind == "delta" else "delta"
    assert K[name].record((kind, None, None, rays), {}, None) == {"lanes": 7}
    assert K[name].record((other, None, None, rays), {}, None) is None
    assert not hasattr(K[name], "work")
