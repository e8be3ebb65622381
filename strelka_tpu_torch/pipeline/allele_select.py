"""Orthogonal variant-allele ranking and ploidy-aware selection.

Faithful port of the reference's indel locus formation
(OrthogonalVariantAlleleCandidateGroupUtil.cpp +
starling_pos_processor.cpp process_pos_indel_digt:1609-1798):

  - alleles starting at one position form a conflict clique by
    definition (getIndelAllelesAtPosition);
  - each sample ranks {ref + alts} by summed naive per-read allele
    posteriors and keeps its top ``callerPloidy`` alleles, with the
    reference allele consuming one slot when it ranks inside the top
    (selectTopOrthogonalAllelesInSample topSize semantics, :262-281);
  - per-sample winners aggregate (ploidy - rank) votes over samples
    into a cross-sample order (selectTopOrthogonalAllelesInAllSamples,
    :286-391);
  - top-ranked conflicting alleles at OTHER positions are greedily
    added while they preserve the clique, then the union is re-ranked
    and re-selected (addAllelesAtOtherPositions, :472-684).

Read-set note: the reference ranks over the intersection of the
alleles' read_path_lnp maps with partial-coverage backfill
(getAlleleLogLhoodFromRead:148-191 — a read missing an allele's score
substitutes its ref score). This engine scores every selected read
against every allele of the locus in one batched launch
(realign_batch.score_loci_batched), so the score matrix is always
complete and the backfill case cannot arise; the read set is the
locus's breakpoint-overlap selection instead of the per-allele map
intersection.

Tie-break note: the reference sorts with std::sort over descending
support (blt_util/sort_util.hh sortIndices), which is unstable — tie
order among equal-support alleles is unspecified there. This port uses
a stable sort (ties keep first-seen / lower-index order) as the
deterministic convention.
"""
from __future__ import annotations

import numpy as np

from .candidates import IndelKey


def indel_conflict(k1: IndelKey, k2: IndelKey) -> bool:
    """is_indel_conflict (indel_util.cpp:29-45): the open ranges
    [pos, right_pos] extended by one (adjacent indels interfere)
    intersect — i.e. the two alleles cannot sit on one haplotype."""
    return k1.pos <= k2.right_pos and k2.pos <= k1.right_pos


def naive_posterior_support(allele_lhoods) -> np.ndarray:
    """Summed naive per-read allele posteriors, ref at column 0
    (rankOrthogonalAllelesInSample:227-237 via
    getAlleleNaivePosteriorFromRead/normalizeLogDistro)."""
    al = np.asarray(allele_lhoods, np.float64)
    alm = al - al.max(axis=1, keepdims=True)
    p = np.exp(alm)
    return (p / p.sum(axis=1, keepdims=True)).sum(axis=0)


def rank_alleles_in_sample(allele_lhoods, n_alt: int):
    """rankOrthogonalAllelesInSample (:209-257): rank the full allele
    list (ref included) by summed naive posterior, descending.

    allele_lhoods: [R, 1+n_alt] or None/empty (no scored reads — all
    supports are zero and the identity order stands, matching the
    empty-readIds case).

    Returns (ranked_alts, ref_rank): alt indices (0-based into the alt
    list) in rank order, and the number of alts ranked above ref.
    """
    if allele_lhoods is None or len(allele_lhoods) == 0:
        return list(range(n_alt)), 0
    sup = naive_posterior_support(allele_lhoods)
    order = np.argsort(-sup, kind="stable")
    ref_rank = int(np.nonzero(order == 0)[0][0])
    return [int(i) - 1 for i in order if i != 0], ref_rank


def select_top_in_all_samples(lhoods_per_sample, caller_ploidy,
                              n_alt: int):
    """selectTopOrthogonalAllelesInAllSamples (:286-391).

    lhoods_per_sample: per sample [R, 1+n_alt] score matrix (or None).
    caller_ploidy: per-sample callerPloidy (0 already mapped to 2).

    Returns (kept, top_per_sample):
      kept           — alt indices in the final cross-sample order
                       (per-sample topSize trim, first-seen
                       accumulation, vote re-rank when >1 sample)
      top_per_sample — per sample, the index INTO ``kept`` of that
                       sample's top-ranked alt (0 when the sample kept
                       nothing or its top was trimmed, :381-390)
    """
    n_samples = len(lhoods_per_sample)
    key_score: dict[int, int] = {}
    order_added: list[int] = []
    top_alt_per_sample: list[int | None] = []
    for s in range(n_samples):
        cp = int(caller_ploidy[s])
        ranked, ref_rank = rank_alleles_in_sample(
            lhoods_per_sample[s], n_alt)
        top_size = cp - (1 if ref_rank < cp else 0)
        kept_s = ranked[:max(top_size, 0)]
        for idx, ai in enumerate(kept_s):
            if ai not in key_score:
                key_score[ai] = 0
                order_added.append(ai)
            # ploidy-adjusted rank vote (:331-333)
            key_score[ai] += cp - idx
        top_alt_per_sample.append(kept_s[0] if kept_s else None)
    kept = list(order_added)
    if n_samples > 1:
        first_seen = {ai: i for i, ai in enumerate(order_added)}
        kept.sort(key=lambda ai: (-key_score[ai], first_seen[ai]))
    top_per_sample = []
    for ai in top_alt_per_sample:
        top_per_sample.append(kept.index(ai) if ai is not None
                              and ai in kept else 0)
    return kept, top_per_sample


def rank_new_alt_alleles(lhoods_per_sample, n_new: int):
    """Cross-sample ranking of the extended-region alt candidates
    (addAllelesAtOtherPositions:554-612).

    lhoods_per_sample: per sample [R, 1+n_new] matrix over {ref + new
    alts only} (the reference ranks wrt the newAltAllele set alone —
    its own TODO notes this). Votes are (N+1) - (rank + refPenalty)
    where refPenalty switches on at the rank the reference allele
    occupies (:572-588). Single-sample keeps the sample's own order.

    Returns new-alt indices in rank order.
    """
    n_samples = len(lhoods_per_sample)
    key_score: dict[int, int] = {}
    order_added: list[int] = []
    for s in range(n_samples):
        ranked, ref_rank = rank_alleles_in_sample(
            lhoods_per_sample[s], n_new)
        ref_penalty = 0
        for idx, ai in enumerate(ranked):
            if ai not in key_score:
                key_score[ai] = 0
                order_added.append(ai)
            if ref_rank == idx:
                ref_penalty = 1
            key_score[ai] += (n_new + 1) - (idx + ref_penalty)
    ranked_all = list(order_added)
    if n_samples > 1:
        first_seen = {ai: i for i, ai in enumerate(order_added)}
        ranked_all.sort(key=lambda ai: (-key_score[ai], first_seen[ai]))
    return ranked_all


def greedy_orthogonal_clique(keys_ranked: list[IndelKey]) -> list[IndelKey]:
    """Test ranked alleles in order, keeping each only if it conflicts
    with every already-kept allele (addAllelesAtOtherPositions:615-632
    — the clique property must survive each addition)."""
    kept: list[IndelKey] = []
    for k in keys_ranked:
        if all(indel_conflict(k, other) for other in kept):
            kept.append(k)
    return kept


def allele_group_alt_repeats(keys: list[IndelKey], ref_codes: np.ndarray,
                             ref_offset: int, decode) -> list[bool]:
    """getAlleleGroupAltRepeats (:417-467): build each allele's ALT
    string as if reported in one record over the group's merged
    reference span; later alleles repeating an earlier ALT are flagged
    (typically an unjoined proximal SNV, :659-666)."""
    begin = min(k.pos for k in keys)
    end = max(k.right_pos for k in keys)
    seen: set[str] = set()
    flags = []
    for k in keys:
        pre = decode(ref_codes[begin - ref_offset:k.pos - ref_offset])
        post = decode(ref_codes[k.right_pos - ref_offset:end - ref_offset])
        alt = pre + k.insert_seq + post
        flags.append(alt in seen)
        seen.add(alt)
    return flags


def extension_candidates(top_keys: list[IndelKey],
                         all_candidates: list[IndelKey],
                         pos: int) -> tuple[list[IndelKey], bool]:
    """The set of candidate alleles at other positions eligible to
    join the locus at ``pos`` (addAllelesAtOtherPositions:492-545):
    start position inside the input group's reference range extended
    by one, not at ``pos`` itself, and conflicting with EVERY input
    allele. (The reference additionally skips alleles already purged
    from its streaming indel buffer, pos < pos - largestTotalIndel-
    RefSpanPerRead — extension candidates always satisfy pos' >= pos
    here since the input range begins at ``pos``, so the retention
    filter cannot exclude anything and is omitted.)

    Returns (new_alts, is_every_alt_orthogonal) — the second mirrors
    the reference's return flag (False when some overlapping allele
    failed the all-input-conflict test).
    """
    rb = min(k.pos for k in top_keys)
    re_ = max(k.right_pos for k in top_keys)
    news: list[IndelKey] = []
    every_orthogonal = True
    # all_candidates is sorted by key (pos-major): bisect to the
    # [rb, re_] window instead of scanning the whole region's list
    import bisect
    lo = bisect.bisect_left(all_candidates, rb,
                            key=lambda k: k.pos)
    for k in all_candidates[lo:]:
        if k.pos > re_:
            break
        if k.pos == pos:
            continue
        if all(indel_conflict(k, t) for t in top_keys):
            news.append(k)
        else:
            every_orthogonal = False
    return news, every_orthogonal
