"""Iterative de Bruijn contig assembly for active regions that lack
spanning reads.

Reference: assembly/IterativeAssembler.{hh,cpp} — word-size iteration
with pseudo-read rescue (IterativeAssembler.cpp:860-916), read-tracking
greedy walk with per-step branch rejection and a backward reject scan
(:172-463), Tarjan-SCC repeat-kmer search incl. homopolymer self-loops
(:527-630), and read-support-greedy contig selection (:716-839).
Option defaults: options/IterativeAssemblerOptions.hh.

Host-side by design: assembly triggers only for regions <=250bp with
<=1000 overlapping reads (ActiveRegionProcessor.hh:50-60), so it is
rare and cheap relative to the device hot loop.
"""
from __future__ import annotations

from dataclasses import dataclass, field

ALPHABET = "ACGT"


@dataclass
class AssemblerOptions:
    """IterativeAssemblerOptions.hh:25-60 defaults. The active-region
    caller overrides min/max_word_length and min_coverage
    (ActiveRegionProcessor.cpp:183-195)."""
    min_word_length: int = 41
    max_word_length: int = 76
    word_step_size: int = 5
    min_contig_length: int = 15
    min_coverage: int = 1              # min kmer count for extension
    min_conservative_coverage: int = 2
    min_unused_reads: int = 3          # stop selection below this
    min_support_reads: int = 2         # min new non-pseudo support
    max_assembly_count: int = 10


@dataclass
class AssemblyReadInfo:
    """AssemblyReadInfo.hh: per-input-read assembly outcome."""
    is_used: bool = False
    is_pseudo: bool = False
    contig_ids: list[int] = field(default_factory=list)


@dataclass
class AssembledContig:
    """AssembledContig.hh: contig + read tracking + conservative range."""
    seq: str = ""
    support_reads: set[int] = field(default_factory=set)
    reject_reads: set[int] = field(default_factory=set)
    conservative_begin: int = 0
    conservative_end: int = 0


def _kmer_counts(opt: AssemblerOptions, reads: list[str],
                 read_info: list[AssemblyReadInfo], k: int):
    """k-mer -> occurrence count and k-mer -> supporting read ids
    (IterativeAssembler.cpp:470-520 getKmerCounts). Each read counts a
    k-mer once; pseudo reads count min_coverage times so a contig from
    the previous (smaller-k) iteration can rescue low-coverage spans."""
    word_count: dict[str, int] = {}
    word_reads: dict[str, set[int]] = {}
    for ridx, seq in enumerate(reads):
        if len(seq) < k:
            continue
        words = {seq[j:j + k] for j in range(len(seq) - k + 1)}
        add = opt.min_coverage if read_info[ridx].is_pseudo else 1
        for w in words:
            if "N" in w:
                continue
            word_count[w] = word_count.get(w, 0) + add
            s = word_reads.get(w)
            if s is None:
                word_reads[w] = {ridx}
            else:
                s.add(ridx)
    return word_count, word_reads


def get_repeat_kmers(word_count: dict[str, int],
                     alphabet: str = ALPHABET) -> set[str]:
    """k-mers inside a cycle of the de Bruijn successor graph, plus
    homopolymer self-loops (IterativeAssembler.cpp:527-630
    searchRepeats/getRepeatKmers, Tarjan SCC). Iterative to avoid
    Python's recursion limit on long low-complexity regions."""
    repeat: set[str] = set()
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    stack: list[str] = []
    on_stack: set[str] = set()
    counter = 1

    def successors(w: str) -> list[str]:
        suf = w[1:]
        out = []
        for b in alphabet:
            nxt = suf + b
            if nxt == w:
                repeat.add(w)          # homopolymer: self-circle
            elif nxt in word_count:
                out.append(nxt)
        return out

    succs: dict[str, list[str]] = {}
    for root in word_count:
        if root in index:
            continue
        work: list[tuple[str, int]] = [(root, 0)]
        while work:
            w, ci = work.pop()
            if ci == 0:
                index[w] = low[w] = counter
                counter += 1
                stack.append(w)
                on_stack.add(w)
                succs[w] = successors(w)
            else:
                child = succs[w][ci - 1]
                low[w] = min(low[w], low[child])
            sl = succs[w]
            descended = False
            while ci < len(sl):
                nxt = sl[ci]
                ci += 1
                if nxt not in index:
                    work.append((w, ci))
                    work.append((nxt, 0))
                    descended = True
                    break
                if nxt in on_stack:
                    low[w] = min(low[w], index[nxt])
            if descended:
                continue
            if low[w] == index[w]:
                # SCC root: singletons are not repeats
                if stack[-1] == w:
                    stack.pop()
                    on_stack.discard(w)
                else:
                    while True:
                        x = stack.pop()
                        on_stack.discard(x)
                        repeat.add(x)
                        if x == w:
                            break
    return repeat


def _walk(opt: AssemblerOptions, seed: str, k: int,
          word_count: dict[str, int], word_reads: dict[str, set[int]],
          repeat_words: set[str], unused_words: set[str],
          contig: AssembledContig) -> bool:
    """Greedy bidirectional contig extension with read tracking
    (IterativeAssembler.cpp:172-463 walk). At each step the branch
    sharing the most reads with the contig wins; reads on losing
    branches (and, bug-compatibly, on the reverse-direction branches of
    EVERY step — previousWordReads is scoped inside the while loop at
    :259 so the 'branching point' test at :351 always fires) become
    reject reads. Returns True if a repeat word ended the walk."""
    contig.support_reads = set(word_reads[seed])
    contig.seq = seed
    unused_words.discard(seed)

    if seed in repeat_words:
        contig.conservative_begin = 0
        contig.conservative_end = k
        return True

    # reject reads for the seed from the unselected branches (:204-230)
    tmp_trunk = seed[:k - 1]
    for b in ALPHABET:
        if b == seed[k - 1]:
            continue
        alt_reads = word_reads.get(tmp_trunk + b)
        if alt_reads:
            contig.reject_reads |= alt_reads

    is_repeat_found = False
    # mode 0: extend right (is_end), mode 1: extend left
    for mode in range(2):
        is_end = mode == 0
        conservative_off = 0
        while True:
            if is_end:
                previous_word = contig.seq[-k:]
                trunk = contig.seq[-(k - 1):]
            else:
                previous_word = contig.seq[:k]
                trunk = contig.seq[:k - 1]

            max_base_count = 0
            max_shared_count = 0
            max_base = ""
            max_word = ""
            max_word_reads: set[int] = set()
            max_shared: set[int] = set()
            previous_word_reads: set[int] = set()  # :259 (loop-scoped)
            support_to_remove: set[int] = set()
            rejects_to_add: set[int] = set()

            for b in ALPHABET:
                new_key = trunk + b if is_end else b + trunk
                cnt = word_count.get(new_key)
                if cnt is None:
                    continue
                curr_reads = word_reads[new_key]
                shared = contig.support_reads & curr_reads
                if not shared:
                    continue
                if len(shared) > max_shared_count:
                    # previous winner's reads now support an unselected
                    # branch (:293-310)
                    if max_shared:
                        support_to_remove |= max_shared
                    if max_word_reads:
                        rejects_to_add |= max_word_reads
                    max_word_reads = curr_reads
                    max_shared_count = len(shared)
                    max_shared = shared
                    max_base_count = cnt
                    max_base = b
                    max_word = new_key
                else:
                    support_to_remove |= shared
                    rejects_to_add |= curr_reads

            if max_base_count < opt.min_coverage:
                break

            contig.seq = (contig.seq + max_base if is_end
                          else max_base + contig.seq)
            if conservative_off != 0 or \
                    max_base_count < opt.min_conservative_coverage:
                conservative_off += 1

            # backward reject scan at a branching point (:349-381)
            if max_word_reads != previous_word_reads:
                tmp_symbol = previous_word[0] if is_end \
                    else previous_word[k - 1]
                for b in ALPHABET:
                    if b == tmp_symbol:
                        continue
                    back_key = b + trunk if is_end else trunk + b
                    if back_key == max_word:
                        continue
                    back_reads = word_reads.get(back_key)
                    if back_reads:
                        rejects_to_add |= back_reads

            contig.reject_reads |= rejects_to_add
            for r in max_word_reads:
                if r not in contig.reject_reads:
                    contig.support_reads.add(r)
            contig.support_reads -= support_to_remove

            unused_words.discard(max_word)
            if max_word in repeat_words:
                is_repeat_found = True
                break

        if is_end:
            contig.conservative_end = conservative_off
        else:
            contig.conservative_begin = conservative_off

    contig.conservative_end = len(contig.seq) - contig.conservative_end
    return is_repeat_found


def _build_contigs(opt: AssemblerOptions, reads: list[str],
                   read_info: list[AssemblyReadInfo], k: int):
    """One word-size pass (IterativeAssembler.cpp:633-713 buildContigs):
    repeatedly seed a walk from the highest-count unused k-mer
    (lexicographic-first on ties, matching the std::set scan at
    :680-689). Returns (is_success, contigs); success is false when any
    walk hit a repeat word."""
    word_count, word_reads = _kmer_counts(opt, reads, read_info, k)
    repeat_words = get_repeat_kmers(word_count)
    unused = {w for w, c in word_count.items() if c >= opt.min_coverage}

    contigs: list[AssembledContig] = []
    is_success = True
    while unused:
        seed = min(unused, key=lambda w: (-word_count[w], w))
        contig = AssembledContig()
        if _walk(opt, seed, k, word_count, word_reads, repeat_words,
                 unused, contig):
            is_success = False
        contigs.append(contig)
    return is_success, contigs


def _select_contigs(opt: AssemblerOptions,
                    read_info: list[AssemblyReadInfo],
                    normal_read_count: int,
                    candidates: list[AssembledContig]):
    """Greedy contig selection by new (not previously used) supporting
    reads (IterativeAssembler.cpp:716-839 selectContigs). Pseudo reads
    never count toward support thresholds; ties on new support prefer
    the longer contig."""
    final: list[AssembledContig] = []
    used_reads: set[int] = set()
    used_pseudo: set[int] = set()
    candidates = list(candidates)
    while candidates and len(final) < opt.max_assembly_count:
        used_normal = len(used_reads) - len(used_pseudo)
        if normal_read_count - used_normal < opt.min_unused_reads:
            return final

        to_remove: set[int] = set()
        selected = None
        selected_idx = -1
        max_support = 0
        max_length = 0
        for ci, contig in enumerate(candidates):
            new_support = contig.support_reads - used_reads
            new_normal = sum(1 for r in new_support
                             if not read_info[r].is_pseudo)
            if new_normal < opt.min_support_reads:
                to_remove.add(ci)
                continue
            if (len(new_support) > max_support
                    or (len(new_support) == max_support
                        and len(contig.seq) > max_length)):
                selected = contig
                selected_idx = ci
                max_support = len(new_support)
                max_length = len(contig.seq)

        if max_support == 0:
            break
        final.append(selected)
        to_remove.add(selected_idx)
        for ci in sorted(to_remove, reverse=True):
            del candidates[ci]

        contig_id = len(final) - 1
        for r in selected.support_reads:
            used_reads.add(r)
            ri = read_info[r]
            ri.is_used = True
            ri.contig_ids.append(contig_id)
            if ri.is_pseudo:
                used_pseudo.add(r)
    return final


def run_iterative_assembler(reads: list[str],
                            opt: AssemblerOptions | None = None):
    """Assemble contigs over iterative word sizes
    (IterativeAssembler.cpp:842-934 runIterativeAssembler).

    When a pass hits repeat k-mers, its long contigs are re-injected as
    pseudo reads (weighted min_coverage) for the next, larger word
    size; pseudo reads from earlier passes are dropped first.

    Returns (contigs, read_info); read_info may be longer than the
    input when the final pass kept pseudo reads — callers must ignore
    entries with is_pseudo (ActiveRegionProcessor.cpp does).
    """
    if opt is None:
        opt = AssemblerOptions()
    reads = list(reads)
    normal_read_count = len(reads)
    read_info = [AssemblyReadInfo() for _ in reads]
    iterative_contigs: list[AssembledContig] = []

    for k in range(opt.min_word_length, opt.max_word_length + 1,
                   opt.word_step_size):
        is_success, iterative_contigs = _build_contigs(
            opt, reads, read_info, k)
        if is_success:
            break

        # remove pseudo reads from the previous iteration (:881-893)
        for i, ri in enumerate(read_info):
            if ri.is_pseudo:
                del reads[i:]
                del read_info[i:]
                break
        # add this iteration's long contigs as pseudo reads (:895-912)
        for contig in iterative_contigs:
            if len(contig.seq) > k + opt.word_step_size:
                reads.append(contig.seq)
                read_info.append(AssemblyReadInfo(is_pseudo=True))

    contigs = _select_contigs(opt, read_info, normal_read_count,
                              iterative_contigs)
    return contigs, read_info
