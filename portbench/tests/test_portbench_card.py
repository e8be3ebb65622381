"""On a card: each cell's run at a small size is correct, and its control
and faults are not (skips without a card)."""
import pytest

from portbench.core import harness, instrument, manifest


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["germline-wgs35.n1", "somatic-tn60-30.n1"])
@pytest.mark.parametrize("how", ("sound", "control")
                         + instrument.FAULTS[1:])
def test_cell_on_the_card(cell, how):
    _card()
    man = manifest.load()
    c = harness.Cell(man, cell)
    c.config["genome"]["contig_bp"] = 300_000
    c.config["check_share"] = 1.0
    kw = {"control": how == "control"}
    if how not in ("sound", "control"):
        kw["fault"] = how
    r = harness.execute(c, 21, 1.0, False, "cuda", man=man, **kw)
    assert r["correct"] == (how == "sound"), r["checks"]
