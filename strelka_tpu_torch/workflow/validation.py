"""Input configuration validation.

Reference: src/python/lib/checkChromSet.py:144-211 (checkChromSet) —
the reference and every alignment file must agree on chromosome names
and lengths; alignment files must additionally agree on chromosome
order. The reference may carry extra chromosomes unless locked.
"""
from __future__ import annotations


class ConfigurationError(ValueError):
    """Raised for inconsistent workflow inputs (chromError analog)."""


def _ordinal(n: int) -> str:
    i = n if n < 14 else n % 10
    return f"{n}{'st' if i == 1 else 'nd' if i == 2 else 'rd' if i == 3 else 'th'}"


def check_chrom_set(ref, headers, labels=None, reference_locked=False):
    """Validate BAM headers against the reference and each other.

    ref: FastaReference; headers: list of BamHeader; labels: display
    names per alignment file. Raises ConfigurationError on mismatch
    (checkChromSet semantics: same chrom set + lengths vs the
    reference, same order among alignment files).
    """
    if not headers:
        return
    if labels is None:
        labels = [f"index{i}" for i in range(len(headers))]
    ref_len = {c: ref.contig_length(c) for c in ref.contig_names}

    first = headers[0]
    first_info = {c: (int(ln), i)
                  for i, (c, ln) in enumerate(zip(first.ref_names,
                                                  first.ref_lengths))}
    for chrom, (length, _order) in first_info.items():
        if chrom not in ref_len:
            raise ConfigurationError(
                "Reference genome mismatch: Reference fasta file is "
                f"missing a chromosome found in the {labels[0]} BAM/CRAM "
                f"file: '{chrom}'")
        if ref_len[chrom] != length:
            raise ConfigurationError(
                "Reference genome mismatch: The length of chromosome "
                f"'{chrom}' is {ref_len[chrom]} in the reference fasta "
                f"file but {length} in the {labels[0]} BAM/CRAM file")
    if reference_locked:
        for chrom in ref_len:
            if chrom not in first_info:
                raise ConfigurationError(
                    f"Reference genome mismatch: {labels[0]} BAM/CRAM "
                    "file is missing a chromosome found in the reference "
                    f"fasta file: '{chrom}'")

    for idx in range(1, len(headers)):
        other = {c: (int(ln), i)
                 for i, (c, ln) in enumerate(zip(headers[idx].ref_names,
                                                 headers[idx].ref_lengths))}
        for chrom, (length, order) in first_info.items():
            if chrom not in other:
                raise ConfigurationError(
                    f"Reference genome mismatch: {labels[idx]} BAM/CRAM "
                    "file is missing a chromosome found in the "
                    f"{labels[0]} BAM/CRAM file: '{chrom}'")
            olength, oorder = other.pop(chrom)
            if length != olength:
                raise ConfigurationError(
                    "Reference genome mismatch: The length of chromosome "
                    f"'{chrom}' is {length} in the {labels[0]} BAM/CRAM "
                    f"file, but {olength} in the {labels[idx]} BAM/CRAM "
                    "file")
            if order != oorder:
                raise ConfigurationError(
                    f"Reference genome mismatch: Chromosome '{chrom}' is "
                    f"ordered {_ordinal(order + 1)} in the {labels[0]} "
                    f"BAM/CRAM file, but {_ordinal(oorder + 1)} in the "
                    f"{labels[idx]} BAM/CRAM file")
        for chrom in other:
            raise ConfigurationError(
                f"Reference genome mismatch: {labels[0]} BAM/CRAM file "
                "is missing a chromosome found in the "
                f"{labels[idx]} BAM/CRAM file: '{chrom}'")
