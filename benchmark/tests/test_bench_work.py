"""The reference's work counts on a frame checked by hand, and the least
times that benchmark/work.py makes of them."""
import types

import pytest
import torch

from benchmark import work
from benchmark.reference import splat


def _frame():
    """One 32x16 tile; five splats on pixel (16, 8), one behind the other
    (depths 1..5), so narrow (sigma 0.1 px) that no other pixel reaches
    alpha 1/255 or the 3-sigma ellipse. Opacity 0.95 each: transmittance
    0.05, 0.0025, 1.25e-4 after the first three; the fourth would take it
    to 6.25e-6 < 1e-4, so it is evaluated and stops the pixel; the fifth
    is never reached."""
    n = 5
    scr = splat.Screen(
        vis=torch.arange(n),
        mean2d=torch.tensor([[16.0, 8.0]] * n),
        depth=torch.arange(1.0, n + 1.0),
        conic=torch.tensor([[100.0, 0.0, 100.0]] * n),
        opacity=torch.full((n,), 0.95),
        color=torch.tensor([[1.0, 0.5, 0.25]] * n),
        rect=torch.tensor([[0, 0, 1, 1]] * n),
    )
    cam = types.SimpleNamespace(width=32, height=16)
    return scr, cam


def test_counts_by_hand():
    scr, cam = _frame()
    bins = splat.Bins(scr, cam)
    w = splat.work_counts()
    rows = splat.render_tiles(scr, bins, torch.zeros(3), 1 << 20, w)
    assert bins.instances == 5
    assert w["power_pairs"] == 4
    assert w["blend_pairs"] == 3
    assert w["needed_instances"] == 3
    # pixel (16, 8): 0.95 * (1 + 0.05 + 0.0025) of the colour
    img = splat.tiles_to_image(rows, bins, cam)
    assert float(img[0, 8, 16]) == pytest.approx(0.95 * 1.0525, rel=1e-6)
    assert float(img.sum()) == pytest.approx(0.95 * 1.0525 * 1.75, rel=1e-6)


def test_least_times():
    w = dict(visible=5, instances=5, needed_instances=3, power_pairs=4, blend_pairs=3)
    pixels = 32 * 16
    k1_bytes = 36 * 5 + 12 * pixels
    assert work.k1_least_s(w, pixels) == max(k1_bytes / 3.35e12, (12 * 4 + 11 * 3) / 67e12, 4 / work.SFU_PER_S)
    k2_bytes = 72 * 5 + 12 * pixels
    assert work.k2_least_s(w, pixels) == max(k2_bytes / 3.35e12, (12 * 4 + 40 * 3) / 67e12, 7 / work.SFU_PER_S)
    assert work.SFU_PER_S == 132 * 16 * 1980e6
    step = work.step_least_s(w, pixels, scene_bytes=1000, param_bytes=800)
    moved = k1_bytes + k2_bytes + 1000 + 7 * 800 + 24 * 3 + 12 * pixels
    assert step == max(moved / 3.35e12, (81 + 168) / 67e12, 11 / work.SFU_PER_S)
    assert work.view_least_s(w, pixels, 1000) == max((k1_bytes + 1000 + 24 * 3) / 3.35e12, 81 / 67e12,
                                                     4 / work.SFU_PER_S)
