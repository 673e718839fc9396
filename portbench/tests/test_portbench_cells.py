"""Every training cell at a tiny size through the port's CPU path: sound
runs come out correct, the control and each planted fault come out not
correct."""

import pytest
import torch

import quiver_tpu_torch as qt
from portbench import check, run as prun
from portbench.tests import tiny

@pytest.mark.parametrize("name", tiny.TRAIN)
def test_cell_is_correct(name):
    r = tiny.run(name)
    assert r.correct, r.checks
    assert set(r.checks) == set(r.cell.limits)
    assert r.attempted > 0 and r.failed == 0
    assert r.e2e["setup_s"] > 0 and r.e2e["train_seeds_per_s"] > 0


@pytest.mark.parametrize("name", tiny.TRAIN)
def test_training_control_is_not_correct(name):
    """The reference in the program's place with TF32 matmuls fails."""
    r = tiny.run(name)
    k = r.keep
    ctl = check.reference_train(k["inp"], r.cell.cfg, k["rec"]["feeds"],
                                k["dropout_seed"], r.device, tf32=True)
    got = check.train_readings(ctl, k["ref"], exact=False)
    assert any(got[n] > lim for n, lim in r.cell.limits.items() if n in got)


def _half_loss(logits, labels, mask):
    half = mask.clone()
    half[mask.shape[0] // 2:] = False
    return qt.parallel.train.__dict__["_orig_ce"](logits, labels, half)


def _altered_rows(orig):
    def lookup(self, idx):
        rows = orig(self, idx).clone()
        rows[1] += 1.0
        return rows
    return lookup


FAULTS = {
    # a step that returns its state unchanged
    "state unchanged": [(torch.optim.Adam, "step",
                         lambda orig: lambda self, closure=None: None)],
    # half of the batch left out, the mean taken over the rest
    "half the batch": [(qt.parallel.train, "masked_cross_entropy",
                        lambda orig: _half_loss)],
    # an answer altered where it is produced: a gathered row
    "a row altered": [(qt.Feature, "lookup_device", _altered_rows)],
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", tiny.TRAIN)
def test_training_fault_is_not_correct(name, fault, monkeypatch):
    monkeypatch.setitem(qt.parallel.train.__dict__, "_orig_ce",
                        qt.parallel.train.masked_cross_entropy)
    for owner, attr, make in FAULTS[fault]:
        monkeypatch.setattr(owner, attr, make(getattr(owner, attr)))
    assert not tiny.run(name).correct


def test_no_card_no_result(capsys):
    """Without the card a run exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = prun.main(["--workload", "products-sage.train", "--seed", "1",
                    "--seconds", "1"], 0.0, root=tiny.ROOT)
    assert rc != 0 and capsys.readouterr().out == ""


@pytest.mark.cuda
@pytest.mark.parametrize("name", tiny.TRAIN)
def test_control_on_the_card(name):
    """The control at a small size on the card: the program is correct,
    the reference at TF32 is not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = tiny.run(name, device="cuda")
    assert r.correct, r.checks
    k = r.keep
    ctl = check.reference_train(k["inp"], r.cell.cfg, k["rec"]["feeds"],
                                k["dropout_seed"], r.device, tf32=True)
    got = check.train_readings(ctl, k["ref"], exact=False)
    assert any(got[n] > lim for n, lim in r.cell.limits.items() if n in got)
