"""The benchmark's plain reference against the port's plain path (the CPU
versions of K1/K2) on a tiny scene made by the benchmark's scene maker:
the image, the loss, every parameter's gradient, and three training steps
with Adam, dense and codebook-indexed. The test imports both; the
reference imports nothing of the port."""
import numpy as np
import pytest
import torch

from benchmark import program, scene
from benchmark.reference import splat
from benchmark.tests.small import small_spec
from c3dgs_tpu_torch.config import OptimizationParams
from c3dgs_tpu_torch.render.types import settings_from_intrinsic
from c3dgs_tpu_torch.train import trainer

CELLS = ["train.garden-5m", "finetune.garden-5m-c3dgs"]


def _inputs(name, seed=11):
    spec = small_spec(name, splats=1500, width=96, height=64)
    cfg = spec["cfg"]
    p = scene.make_scene(cfg, seed, "cpu")
    cams = scene.make_cameras(cfg, seed, "cpu")
    return spec, cfg, p, cams


@pytest.mark.parametrize("name", CELLS)
def test_image_loss_and_gradients(name):
    spec, cfg, p, cams = _inputs(name)
    idx = {k: p.get(k) for k in ("feature_indices", "gaussian_indices")}
    ref = splat.Scene({k: p[k] for k in scene.PARAM_FIELDS}, idx, 1 << 16)
    ref.obs = splat.observe(None, ref.p)
    port = program.build_scene({k: v.clone() for k, v in p.items()}, cfg).update_observers()
    settings = settings_from_intrinsic(np.asarray(cams["intrinsic"]))
    bg = torch.zeros(3)
    ev, gt = cams["train_ev"][1], cams["targets"][1]
    with torch.no_grad():
        img_p = trainer.render_scene(port, ev, settings, bg, device="cpu")["render"]
    cam = splat.Camera(ev, cams["intrinsic"], "cpu")
    img_r = ref.render(cam, bg)
    assert float(img_r.mean()) > 0.05
    # the mean: a pixel where two splats' quantized depths tie (the port's
    # sort key) may blend them in the other order
    assert float((img_p - img_r).abs().mean()) < 1e-5
    loss_r, g_r = ref.loss_and_grads(cam, gt, bg, cfg["train"]["lambda_dssim"])
    loss_p, _, g_p, _ = trainer.loss_and_grads(port, ev, gt, settings, bg, OptimizationParams())
    assert abs(float(loss_p) - loss_r) < 1e-5 * loss_r
    med = float(np.median([float(v.norm()) for v in g_r.values()]))
    for k, v in g_r.items():
        assert float((g_p[k] - v).norm()) <= 1e-3 * max(float(v.norm()), med), k


@pytest.mark.parametrize("name", CELLS)
def test_three_steps_follow_the_program(name):
    spec, cfg, p, cams = _inputs(name, seed=5)
    idx = {k: p.get(k) for k in ("feature_indices", "gaussian_indices")}
    p0 = {k: p[k].clone() for k in scene.PARAM_FIELDS}
    first = int(spec["traffic"]["first_step"])
    prog = program.Trainer(program.build_scene({k: v.clone() for k, v in p.items()}, cfg), cfg, cams, first, 0,
                           "cpu")
    prog.probe(cams["train_ev"][0])
    picks = [0, 3, 7]
    losses = []
    for i, c in enumerate(picks):
        losses.append(prog.step(cams["train_ev"][c], cams["targets"][c])["loss"])
        if i == 0:
            g1 = prog.first_grad_norms()
    after = prog.params()
    ref = splat.Scene(p0, idx, 1 << 16)
    res = splat.train_steps(ref, [splat.Camera(cams["train_ev"][c], cams["intrinsic"], "cpu") for c in picks],
                            [cams["targets"][c] for c in picks], torch.zeros(3), cfg["train"], first, cams["extent"])
    for a, b in zip(losses, res["losses"]):
        assert abs(a - b) < 1e-5 * b
    for k, v in res["first_grads"].items():
        assert abs(g1[k] - float(v.norm())) <= 1e-3 * max(float(v.norm()), 1e-12) or float(v.norm()) == 0.0, k
    for k in p0:
        d_p = float((after[k] - p0[k]).norm())
        d_r = float((res["p"][k].detach() - p0[k]).norm())
        if float(res["first_grads"][k].norm()) > 0:
            assert abs(d_p - d_r) <= 0.05 * d_r, k
