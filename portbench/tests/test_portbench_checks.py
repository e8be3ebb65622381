"""The comparison that decides `correct`: sound runs pass, the control
(the reference in bfloat16 in the program's place) and each fault of
the timed path fail. On the CPU the port runs K1's, KG-SB's, KS-G's and
KS-P's plain versions through the same entries the window checks;
KG-H's lanes entry runs only on a card, so its comparison is held here
against the port's plain version of it and on the card by
test_portbench_card.py."""
import gzip

import pytest
import torch

from portbench.core import harness, instrument, manifest, truth
from portbench.reference import compare

SMALL = 60_000


def _execute(cell_name, seed, **kw):
    man = manifest.load()
    cell = harness.Cell(man, cell_name)
    cell.config["genome"]["contig_bp"] = SMALL
    cell.config["check_share"] = 1.0
    # KG-H's lanes entry runs only on a card: no call to compare here
    cell.config["limits"].pop("kgh_gap", None)
    return harness.execute(cell, seed, 0.5, False, "cpu", man=man, **kw)


@pytest.mark.parametrize("cell", ["germline-wgs35.n1", "somatic-tn60-30.n1"])
def test_a_sound_run_is_correct(cell):
    r = _execute(cell, 11)
    assert r["correct"], r["checks"]
    assert all(c["calls"] > 0 for c in r["checks"].values())


def test_the_control_fails():
    r = _execute("somatic-tn60-30.n1", 12, control=True)
    assert not r["correct"]
    for k in ("k1_gap", "ksg_gap", "ksp_gap"):
        assert r["checks"][k]["value"] > r["checks"][k]["limit"], k


@pytest.mark.parametrize("cell", ["germline-wgs35.n1", "somatic-tn60-30.n1"])
@pytest.mark.parametrize("fault", instrument.FAULTS[1:])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    r = _execute(cell, 13, fault=fault)
    assert not r["correct"], (fault, r["checks"])


def _tile(seed, L=400, D=48):
    g = torch.Generator().manual_seed(seed)
    base = torch.randint(-1, 5, (L, D), generator=g).to(torch.int8)
    qual = torch.randint(0, 45, (L, D), generator=g).to(torch.int16)
    mask = torch.rand((L, D), generator=g) < 0.85
    ref = torch.randint(0, 4, (L,), generator=g).to(torch.int32)
    smis = torch.where(torch.rand(L, 4, generator=g) < 0.3,
                       -torch.rand(L, 4, generator=g), torch.zeros(L, 4))
    return base, qual, mask, ref, smis


def _limit(config, number):
    return manifest.config(manifest.load(), config)["limits"][number]


def _broken(got):
    half = got.clone()
    half[len(half) // 2:] = half[:len(half) // 2].mean(dim=0)
    bumped = got.clone()
    bumped.view(-1)[0] += 1.0
    return half, torch.zeros_like(got), bumped


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_kgh_comparison_separates_the_control(seed):
    from strelka_tpu_torch.models import snv_digt as sd
    base, qual, mask, ref, smis = _tile(seed)
    got = sd.call_snv_lanes_tile_plain(base, qual, mask, ref, None, 0.001,
                                       s_mis=smis).lhood
    x = compare._bind("snv_tiles", (base, qual, mask, ref, None, 0.001),
                      {"s_mis": smis}, "cpu")
    limit = _limit("germline-wgs35", "kgh_gap")
    assert compare.kgh_gap(x, got) < limit / 10
    assert compare.kgh_gap(x, got, control=True) > 3 * limit
    for broken in _broken(got):
        assert compare.kgh_gap(x, broken) > limit


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("dep", [False, True])
def test_kgsb_comparison_separates_the_control(seed, dep):
    from strelka_tpu_torch.models import snv_digt as sd
    base, qual, mask, ref, _smis = _tile(seed)
    base = base.clamp(0, 3)
    g = torch.Generator().manual_seed(seed)
    fwd = torch.rand(base.shape, generator=g) < 0.5
    tgt = torch.randint(0, 10, (base.shape[0],), generator=g)
    lt = -torch.rand(base.shape[0], generator=g) * 200
    dd = -torch.rand(base.shape, generator=g) * 0.1 if dep else None
    tile = sd.SnvPileupTile(base, qual.to(torch.int32), fwd, mask, ref)
    got = sd.snv_strand_bias_tile_plain(tile, tgt, lt, dd)
    x = compare._bind("kgsb", (instrument._host(tile), tgt, lt, dd), {},
                      "cpu")
    limit = _limit("germline-wgs35", "kgsb_gap")
    assert compare.kgsb_gap(x, got) < limit / 10
    assert compare.kgsb_gap(x, got, control=True) > 3 * limit
    for broken in _broken(got):
        assert compare.kgsb_gap(x, broken) > limit


def _lhoods(seed, L=500):
    from strelka_tpu_torch.models import somatic_snv as ss
    out = []
    for depth, vaf in ((30, 0.0), (60, 0.3)):
        base, qual, mask, ref, _smis = _tile(seed + depth, L, depth)
        g = torch.Generator().manual_seed(seed + depth)
        alt = (ref + 1) % 4
        som = torch.rand(L, generator=g) < 0.3
        carry = (torch.rand(base.shape, generator=g) < vaf) & som[:, None]
        base = torch.where(carry, alt[:, None].to(torch.int8), ref[:, None]
                           .to(torch.int8))
        fwd = torch.rand(base.shape, generator=g) < 0.5
        qual = qual.clamp(min=2)
        out.append(ss.freq_grid_lhoods_plain(base, qual, mask, fwd, ref))
    return out


@pytest.mark.parametrize("seed", [1, 2])
def test_ksp_comparison_separates_the_control(seed):
    from strelka_tpu_torch.models import somatic_snv as ss
    nl, tl = _lhoods(seed)
    got = ss.somatic_snv_call_plain(nl, tl)
    x = compare._bind("somatic_posterior", (nl, tl), {}, "cpu")
    limit = _limit("somatic-tn60-30", "ksp_gap")
    assert compare.ksp_gap(x, got._asdict()) < limit / 10
    assert compare.ksp_gap(x, got._asdict(), control=True) > limit
    bumped = got._asdict()
    bumped["strand_bias"] = bumped["strand_bias"].clone()
    bumped["strand_bias"][0] += 1.0
    zeros = {k: torch.zeros_like(v) for k, v in got._asdict().items()}
    for broken in (bumped, zeros):
        assert compare.ksp_gap(x, broken) > limit


def _vcf(path, rows):
    with gzip.open(path, "wt") as f:
        f.write("#CHROM\n")
        for r in rows:
            f.write("\t".join(r) + "\n")


def test_gvcf_gap_reads_uncovered_bases_and_lost_variants(tmp_path):
    blocks = [["c", "1", ".", "A", ".", ".", "PASS", "END=4"],
              ["c", "5", ".", "C", "T", "9", "PASS", "."],
              ["c", "6", ".", "G", ".", ".", "PASS", "END=10"]]
    variants = [blocks[1]]
    assert truth.gvcf_gap(blocks, variants, 10) == 0.0
    assert truth.gvcf_gap(blocks[:2], variants, 10) == pytest.approx(0.5)
    assert truth.gvcf_gap([blocks[0], blocks[2]], variants, 10) == 1.0
