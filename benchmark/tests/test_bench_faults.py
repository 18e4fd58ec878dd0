"""A whole run at a CPU size, past the harness's look for a card, with the
timed path broken underneath: `correct` has to come out false for each
fault that the cell can have, and true without one. The cells run on one
chip, so no exchange between chips can be left out."""
import json

import pytest

from benchmark import harness
from benchmark.tests.small import small_spec
from c3dgs_tpu_torch.eval import metrics as port_metrics
from c3dgs_tpu_torch.train import trainer

TRAIN = ["train.garden-5m", "finetune.garden-5m-c3dgs"]
VIEW = ["view.garden-5m-c3dgs", "view.garden-5m"]


def _run(name):
    return harness.run_cell(name, 2 ** 31 + 12345, 0.3, False, "cpu", spec=small_spec(name))


def _state_unchanged(monkeypatch):
    """Adam keeps its moments but the parameters do not move."""
    orig = trainer.adam_update

    def frozen(state, params, grads, schedules, eps=trainer.ADAM_EPS):
        orig(state, {k: v.detach().clone() for k, v in params.items()}, grads, schedules, eps)

    monkeypatch.setattr(trainer, "adam_update", frozen)


def _half_batch(monkeypatch):
    """The loss over the image's top half only: half the pixels left out,
    the mean taken over the rest."""
    orig = trainer.L.photometric_loss

    def half(pred, target, lam=0.2):
        h = pred.shape[-2] // 2
        return orig(pred[..., :h, :], target[..., :h, :], lam)

    monkeypatch.setattr(trainer.L, "photometric_loss", half)


def _gradient_altered(monkeypatch):
    """One field's gradient altered where the backward produces it."""
    orig = trainer.loss_and_grads

    def altered(*a, **k):
        loss, out, grads, vs = orig(*a, **k)
        grads["features_dc"] = grads["features_dc"] * 1.5
        return loss, out, grads, vs

    monkeypatch.setattr(trainer, "loss_and_grads", altered)


def _image_altered(monkeypatch):
    """A served image altered where it is produced: a quarter of its rows
    brightened by 0.05."""
    orig = port_metrics.render_full

    def altered(*a, **k):
        out = orig(*a, **k)
        img = out["render"].clone()
        img[:, : img.shape[1] // 4] += 0.05
        out["render"] = img
        return out

    monkeypatch.setattr(port_metrics, "render_full", altered)


@pytest.mark.parametrize("name", TRAIN + VIEW)
def test_sound_run_is_correct(name):
    r = _run(name)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _gradient_altered], ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", TRAIN)
def test_training_faults(name, fault, monkeypatch):
    fault(monkeypatch)
    assert not _run(name)["correct"]


@pytest.mark.parametrize("name", VIEW)
def test_view_fault(name, monkeypatch):
    _image_altered(monkeypatch)
    assert not _run(name)["correct"]


def test_print_result_puts_checks_last(capsys):
    r = dict(correct=True, attempted=1, failed=0, metrics={}, device={}, checks={"x": {"value": 1.0, "limit": 2.0}})
    harness.print_result(r)
    out, err = capsys.readouterr()
    assert err.strip().splitlines()[-1] == "check x 1.0 limit 2.0"
    last = out.strip().splitlines()[-1]
    assert last.endswith('"checks": {"x": {"value": 1.0, "limit": 2.0}}}')
    assert json.loads(last)["checks"]["x"]["value"] == 1.0
