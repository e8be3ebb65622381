"""The port's site simulators (strelka_tpu_torch/sim.py) against the
JAX package's (strelka_tpu/sim.py): the same seed gives the same draws
from every simulator, the indel locus caller gives the same genotype and
scores, and tests/test_simulators.py's statistics gates hold on the
port's models (the SNV tiles and the somatic SNV model on
device="cpu"), whose outputs equal the JAX models' on the same draws.
"""
import numpy as np
import pytest
import torch

from strelka_tpu import sim as jsim
from strelka_tpu_torch import sim as tsim
from strelka_tpu_torch.models import digt
from strelka_tpu_torch.models import snv_digt as sd
from strelka_tpu_torch.models import somatic_snv as ss


def _same(a, b):
    """Equal values, dtypes and shapes, recursively through tuples."""
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


def _both(seed, fn):
    """fn(sim module, rng) for each package from the same seed."""
    return (fn(jsim, np.random.default_rng(seed)),
            fn(tsim, np.random.default_rng(seed)))


@pytest.fixture
def qval_file(tmp_path):
    p = tmp_path / "qvals.txt"
    p.write_text("# qval count\n30 90\n20 10\n\n12 3\n")
    return str(p)


def test_qval_distro_draws_equal(qval_file, tmp_path):
    a, b = _both(0, lambda m, rng: m.QvalDistro.from_file(
        qval_file).sample(rng, 20_000))
    _same(a, b)
    assert set(np.unique(b)) == {12, 20, 30}
    a, b = _both(0, lambda m, rng: m.QvalDistro(25).sample(rng, 5))
    _same(a, b)
    empty = tmp_path / "empty.txt"
    empty.write_text("# nothing\n")
    for m in (jsim, tsim):
        with pytest.raises(ValueError, match="empty qval distro"):
            m.QvalDistro.from_file(str(empty))


@pytest.mark.parametrize("alt_freq", [0.0, 0.3, 1.0])
def test_sim_sample_pile_draws_equal(qval_file, alt_freq):
    def draw(m, rng):
        qd = m.QvalDistro.from_file(qval_file)
        return tuple(m.sim_sample_pile(rng, 40, qd, 1, 3, alt_freq)
                     for _ in range(50))
    _same(*_both(1, draw))


def test_germline_site_draws_equal(qval_file):
    for gt in ((0, 0), (0, 1), (2, 2)):
        def draw(m, rng, gt=gt):
            opt = m.SimOptions(depth=30, qscore=30, ref_base=0)
            plain = m.simulate_germline_sites(rng, 40, gt, opt)
            qd = m.QvalDistro.from_file(qval_file)
            site = m.simulate_site_pileup(rng, gt, opt, qd)
            return (*plain, *site)
        _same(*_both(2, draw))


def test_somatic_site_draws_equal(qval_file):
    def draw(m, rng):
        nopt = m.SimOptions(depth=30, qscore=30, ref_base=0)
        topt = m.SimOptions(depth=60, qscore=25, ref_base=0)
        out = []
        for qd in (None, m.QvalDistro.from_file(qval_file)):
            for _ in range(20):
                n, t = m.simulate_somatic_site(rng, (0, 1), 0.3, 2, nopt,
                                               topt, qd)
                out += [*n, *t]
        return tuple(out)
    _same(*_both(3, draw))


@pytest.mark.parametrize("mode", ["RANDOM", "REF", "NOISE", "SOMATIC",
                                  "GERMLINE"])
def test_strelka_site_draws_equal(mode):
    """The per-site state draw and every site's piles and oracle fields
    (RANDOM with elevated priors, so that every state appears)."""
    def draw(m, rng):
        opt = m.StrelkaSimOptions(total_sites=300, ncov=10, tcov=20,
                                  shared_site_error_rate=0.2,
                                  ssnv_prior=0.2, bsnp_diploid_theta=0.2,
                                  normal_purity=0.9, tumor_purity=0.8,
                                  mode=mode, ref_base=2)
        return [(s.mode, s.alt_id, s.normal_alt_freq, s.tumor_alt_freq,
                 *s.normal, *s.tumor)
                for s in m.simulate_strelka_sites(rng, opt)]
    a, b = _both(4, draw)
    assert len(a) == len(b) == 300
    for x, y in zip(a, b):
        assert x[:4] == y[:4]
        _same(tuple(x[4:]), tuple(y[4:]))
    modes = {s[0] for s in b}
    if mode == "RANDOM":
        assert modes == {tsim.SIM_REF, tsim.SIM_NOISE, tsim.SIM_SOMATIC,
                         tsim.SIM_GERMLINE}
    else:
        assert modes == {mode}


@pytest.mark.parametrize("n_alt,err,delete_len,insert_len",
                         [(0, 2e-3, 1, 0), (1, 1e-3, 1, 0), (2, 1e-3, 0, 3),
                          (1, 5e-2, 4, 0)])
def test_indel_locus_draws_and_calls_equal(n_alt, err, delete_len,
                                           insert_len):
    def run(m, rng):
        opt = m.IndelSimOptions(depth=30, error_rate=err, read_len=100,
                                delete_len=delete_len, insert_len=insert_len)
        out = []
        for pattern, repeats in ((1, 1), (2, 5)):
            for _ in range(15):
                lh, rl, na = m.simulate_indel_locus(rng, n_alt, opt)
                called = m.call_simulated_indel_locus(
                    lh, rl, na, opt, pattern_size=pattern,
                    repeat_count=repeats)
                out.append((lh, rl, na, *called))
        return out
    for x, y in zip(*_both(5, run)):
        _same(tuple(x), tuple(y))


def _snv_call(base, qual, fwd, mask):
    n = base.shape[0]
    t = [torch.from_numpy(a) for a in (base, qual, fwd, mask)]
    tile = sd.SnvPileupTile(base_id=t[0], qual=t[1], is_fwd=t[2], mask=t[3],
                            ref_gt=torch.zeros(n, dtype=torch.int32))
    return sd.call_snv_tile(tile)


def test_germline_caller_statistics_on_port():
    """tests/test_simulators.py's germline gates on the port's SNV tiles:
    het rate > 0.97 at het sites, FP rate < 0.01 at Q >= 30 at hom-ref
    sites, on the same draws; the tiles' fields equal the JAX package's
    call_snv_tile on them."""
    import jax.numpy as jnp
    from strelka_tpu.models import snv_digt as jsd
    rng = np.random.default_rng(42)
    opt = tsim.SimOptions(depth=30, qscore=30, ref_base=0)
    het = tsim.simulate_germline_sites(rng, 200, (0, 1), opt)
    homref = tsim.simulate_germline_sites(rng, 300, (0, 0), opt)
    res = _snv_call(*het)
    het_rate = (res.genome_max_gt.numpy() == digt.LABELS.index("AC")).mean()
    assert het_rate > 0.97, het_rate
    res0 = _snv_call(*homref)
    fp = (res0.snv_qphred.numpy() >= 30).mean()
    assert fp < 0.01, fp
    for arrs, got in ((het, res), (homref, res0)):
        b, q, f, m = map(jnp.asarray, arrs)
        want = jsd.call_snv_tile(jsd.SnvPileupTile(
            base_id=b, qual=q, is_fwd=f, mask=m,
            ref_gt=jnp.zeros(b.shape[0], jnp.int32)))
        for fld in ("genome_max_gt", "snv_qphred", "genome_max_gt_qphred",
                    "phred_loghood"):
            assert np.array_equal(getattr(got, fld).numpy(),
                                  np.asarray(getattr(want, fld))), fld


def _tiles(picks, D):
    n = len(picks)
    bb = np.full((n, D), -1, np.int32)
    qq = np.zeros((n, D), np.int32)
    ff = np.zeros((n, D), bool)
    mm = np.zeros((n, D), bool)
    for i, (b, q, f) in enumerate(picks):
        k = min(len(b), D)
        bb[i, :k] = b[:k]
        qq[i, :k] = q[:k]
        ff[i, :k] = f[:k]
        mm[i, :k] = True
    return bb, qq, ff, mm


def _somatic_q(normals, tumors, D=192):
    """Simulated T/N piles through the port's somatic SNV grid model on
    the CPU, and the same through the JAX package's: qphred of each."""
    import jax.numpy as jnp
    from strelka_tpu.models import somatic_snv as jss
    n = len(normals)
    nb, nq, nf, nm = _tiles(normals, D)
    tb, tq, tf, tm = _tiles(tumors, D)
    ref = np.zeros(n, np.int32)

    def lh(mod, conv, b, q, m, f):
        return mod.freq_grid_lhoods(conv(b), conv(q), conv(m), conv(f),
                                    conv(ref))
    got = ss.somatic_snv_call(lh(ss, torch.from_numpy, nb, nq, nm, nf),
                              lh(ss, torch.from_numpy, tb, tq, tm, tf))
    want = jss.somatic_snv_call(lh(jss, jnp.asarray, nb, nq, nm, nf),
                                lh(jss, jnp.asarray, tb, tq, tm, tf))
    q = got.qphred.numpy()
    assert np.array_equal(q, np.asarray(want.qphred))
    return q


def test_somatic_caller_statistics_on_port():
    """tests/test_simulators.py's somatic gates on the port's model:
    30% VAF at 60x calls at Q >= 15 in more than 90% of sites, no tumor
    alt in fewer than 5%."""
    rng = np.random.default_rng(7)
    nopt = tsim.SimOptions(depth=30, qscore=30, ref_base=0)
    topt = tsim.SimOptions(depth=60, qscore=30, ref_base=0)

    def run_pair(freq, n=60):
        pairs = [tsim.simulate_somatic_site(rng, (0, 0), freq, 2, nopt, topt)
                 for _ in range(n)]
        return _somatic_q([p[0] for p in pairs], [p[1] for p in pairs],
                          D=128)
    q_som = run_pair(0.3)
    q_null = run_pair(0.0)
    assert (q_som >= 15).mean() > 0.9
    assert (q_null >= 15).mean() < 0.05


def test_somatic_grid_state_statistics_on_port():
    """The grid-state gates (tests/test_simulators.py): somatic states
    detected, ref and germline rejected, noise visible in the normal
    rejected."""
    rng = np.random.default_rng(8)

    def run(mode, n=40, **kw):
        opt = tsim.StrelkaSimOptions(total_sites=n, ncov=35, tcov=60,
                                     mode=mode, **kw)
        sites = list(tsim.simulate_strelka_sites(rng, opt))
        return sites, _somatic_q([s.normal for s in sites],
                                 [s.tumor for s in sites])
    _, q_som = run(tsim.SIM_SOMATIC, tumor_purity=1.0)
    _, q_ref = run(tsim.SIM_REF)
    _, q_germ = run(tsim.SIM_GERMLINE)
    noise, q_noise = run(tsim.SIM_NOISE, n=60)
    assert (q_som >= 15).mean() > 0.9
    assert (q_ref >= 15).mean() < 0.05
    assert (q_germ >= 15).mean() < 0.05
    hi = np.array([s.normal_alt_freq >= 0.3 for s in noise])
    assert hi.sum() >= 20
    assert (q_noise[hi] >= 15).mean() < 0.1
    assert (q_noise >= 15).mean() < (q_som >= 15).mean() / 2


def test_indel_calibration_on_port():
    """The indel genotyping gates of tests/test_simulators.py on the
    port's models/indel_genotype."""
    rng = np.random.default_rng(5)
    opt = tsim.IndelSimOptions(depth=30, error_rate=1e-3, read_len=100,
                               delete_len=1)
    for true_gt in (0, 1, 2):
        hits = 0
        for _ in range(50):
            lh, rl, na = tsim.simulate_indel_locus(rng, true_gt, opt)
            max_gt, q_ref, _ = tsim.call_simulated_indel_locus(
                lh, rl, na, opt)
            hits += max_gt == true_gt
            if true_gt > 0:
                assert q_ref >= 20
        assert hits / 50 > 0.9, (true_gt, hits)
    opt = tsim.IndelSimOptions(depth=30, error_rate=2e-3, read_len=100,
                               delete_len=1)
    miscalls = 0
    for _ in range(400):
        lh, rl, na = tsim.simulate_indel_locus(rng, 0, opt)
        max_gt, _, q_gt = tsim.call_simulated_indel_locus(lh, rl, na, opt)
        miscalls += max_gt != 0 and q_gt >= 30
    assert miscalls <= 2
