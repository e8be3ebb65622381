"""VCF reading (candidate indels, forced-GT, noise panels) and writing.

Reference analog: htsapi/vcf_streamer.hh|cpp + vcf_record parsing, plus
the VCF emission helpers spread through the applications. Text handling
stays host-side by design — only likelihood tensors go to device.
"""
from __future__ import annotations

import gzip
from dataclasses import dataclass, field


@dataclass
class VcfRecord:
    chrom: str
    pos: int  # 0-based internal (VCF text is 1-based)
    id: str
    ref: str
    alts: list[str]
    qual: str
    filter: str
    info: str
    samples: list[str] = field(default_factory=list)
    format: str = ""

    def is_indel(self) -> bool:
        return any(len(a) != len(self.ref) for a in self.alts if a not in (".", "<*>"))

    def is_snv(self) -> bool:
        return len(self.ref) == 1 and any(len(a) == 1 and a != "." for a in self.alts)


def identity_header_lines(cmdline: str | None = None,
                          reference_path: str | None = None) -> list[str]:
    """Audit metadata header lines in the reference's order
    (htsapi/vcf_util.cpp vcf_fileDate + write_vcf_audit_info analog:
    fileDate, source, source_version, startTime, cmdline, reference).
    All are in the volatile set the reference's demo diff filters."""
    import os
    import time

    from .. import __version__

    lines = [
        f"##fileDate={time.strftime('%Y%m%d')}",
        "##source=strelka_tpu_torch",
        f"##source_version={__version__}",
        f"##startTime={time.ctime()}",
    ]
    if cmdline:
        lines.append(f"##cmdline={cmdline}")
    if reference_path:
        lines.append(f"##reference=file://{os.path.abspath(reference_path)}")
    return lines


def _open_maybe_gz(path: str):
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rt")
    return open(path)


def read_vcf(path: str, region: tuple[str, int, int] | None = None):
    """Yield VcfRecord from a (optionally bgzipped) VCF file.
    Truncated/corrupt input raises ValueError/EOFError (gzip codec
    errors never leak)."""
    import zlib
    with _open_maybe_gz(path) as f:
        it = iter(f)
        while True:
            try:
                line = next(it)
            except StopIteration:
                return
            except (zlib.error, gzip.BadGzipFile) as e:
                raise ValueError(
                    f"{path}: truncated or corrupt gzip stream "
                    f"({e})") from e
            if line.startswith("#"):
                continue
            fields = line.rstrip("\n").split("\t")
            try:
                chrom, pos1, vid, ref, alt = fields[:5]
                pos = int(pos1) - 1
            except ValueError as e:
                raise ValueError(
                    f"{path}: malformed VCF record line: "
                    f"{line[:80]!r}") from e
            if region is not None:
                rchrom, rbeg, rend = region
                if chrom != rchrom or pos < rbeg or pos >= rend:
                    continue
            rec = VcfRecord(
                chrom=chrom, pos=pos, id=vid, ref=ref,
                alts=alt.split(","),
                qual=fields[5] if len(fields) > 5 else ".",
                filter=fields[6] if len(fields) > 6 else ".",
                info=fields[7] if len(fields) > 7 else ".",
                format=fields[8] if len(fields) > 9 else "",
                samples=fields[9:] if len(fields) > 9 else [],
            )
            yield rec


def format_vcf_line(rec: VcfRecord) -> str:
    cols = [
        rec.chrom, str(rec.pos + 1), rec.id or ".", rec.ref,
        ",".join(rec.alts) if rec.alts else ".",
        rec.qual, rec.filter, rec.info,
    ]
    if rec.samples:
        cols.append(rec.format)
        cols.extend(rec.samples)
    return "\t".join(cols)
