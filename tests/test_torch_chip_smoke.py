"""``chip_smoke.py --phases``: the argument names the phases to run, with
those whose results they need, in the order a whole run takes them; no
argument runs every phase; an unknown name exits with code 2.  Nothing
here runs a phase (there is no card on the CPU)."""

import ast
import contextlib
import io
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def test_no_argument_selects_every_phase_in_order():
    assert chip_smoke.select_phases([]) == list(chip_smoke.PHASES)
    assert chip_smoke.PHASES[-1] == "examples"
    assert len(set(chip_smoke.PHASES)) == len(chip_smoke.PHASES)


@pytest.mark.parametrize("arg, want", [
    ("examples", ["examples"]),
    ("serving,kernel", ["kernel", "serving"]),
    ("lint", ["sanitize", "lint"]),
    ("full_graph", ["products", "full_graph"]),
    ("bf16_mmap,examples", ["serving", "bf16_mmap", "examples"]),
    (" dp , examples ", ["dp", "examples"]),
])
def test_named_phases_with_what_they_need(arg, want):
    assert chip_smoke.select_phases(["--phases", arg]) == want


@pytest.mark.parametrize("arg", ["bogus", "examples,bogus", "", ","])
def test_an_unknown_phase_exits_2(arg):
    err = io.StringIO()
    with contextlib.redirect_stderr(err), pytest.raises(SystemExit) as e:
        chip_smoke.select_phases(["--phases", arg])
    assert e.value.code == 2
    assert "phase" in err.getvalue()


def test_main_refuses_an_unknown_phase_before_the_card(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main(["--phases", "bogus"])
    assert e.value.code == 2
    assert capsys.readouterr().out == ""


def test_without_a_card_main_prints_no_result(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main(["--phases", "examples"]) == 2
    assert capsys.readouterr().out == ""


def test_every_phase_is_gated_in_main():
    """Each name of PHASES selects code in ``main``; the data each phase
    family needs is built only when one of them runs."""
    src = ast.get_source_segment(
        (ROOT / "chip_smoke.py").read_text(),
        next(n for n in ast.parse((ROOT / "chip_smoke.py").read_text()).body
             if isinstance(n, ast.FunctionDef) and n.name == "main"))
    for name in chip_smoke.PHASES:
        assert f'"{name}" in want' in src, name
    assert chip_smoke.REDDIT_PHASES | chip_smoke.PRODUCTS_PHASES | {
        "rgat", "lint", "examples"} == set(chip_smoke.PHASES)
    for need in chip_smoke.PHASE_NEEDS.values():
        assert set(need) <= set(chip_smoke.PHASES)


def test_the_child_modes_dispatch_before_the_phases():
    src = (ROOT / "chip_smoke.py").read_text()
    tail = src[src.index('if __name__ == "__main__":'):]
    assert tail.index("--fleet-replica") < tail.index("main(sys.argv[1:])")
    assert tail.index("--sanitize-child") < tail.index("main(sys.argv[1:])")


def test_examples_phase_runs_every_example():
    from quiver_tpu_torch.examples import EXAMPLES

    names = [r[0] for r in chip_smoke.EXAMPLE_RUNS]
    assert set(names) == set(EXAMPLES)
    assert set(chip_smoke.EXAMPLE_SUMMARY) == set(EXAMPLES)
    # one run under the paged store, which must launch B5
    paged = [r for r in chip_smoke.EXAMPLE_RUNS if r[2]]
    assert len(paged) == 1 and "page_gather" in paged[0][3]
    assert paged[0][2]["feature_paged"] == "on"
