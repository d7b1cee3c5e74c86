"""CNV calls → VCF 4.2: a copy of the JAX package's utils/vcf.py.

Symbolic-allele records (``<DEL>``/``<DUP>`` with END/SVLEN INFO and
per-sample GT:CN:L2FC), one record per distinct (chrom, start, end,
svtype) event with every cohort sample genotyped (non-carriers
``0/0:2:.``), for ``cnv --vcf`` and ``emdepth --vcf``.
"""

from __future__ import annotations

from ..utils.xopen import xopen

_HEADER_LINES = [
    "##ALT=<ID=DEL,Description=\"Deletion relative to the cohort "
    "median depth\">",
    "##ALT=<ID=DUP,Description=\"Duplication relative to the cohort "
    "median depth\">",
    "##INFO=<ID=SVTYPE,Number=1,Type=String,Description=\"CNV type "
    "(DEL or DUP)\">",
    "##INFO=<ID=END,Number=1,Type=Integer,Description=\"End of the "
    "event (1-based inclusive)\">",
    "##INFO=<ID=SVLEN,Number=1,Type=Integer,Description=\"Signed event "
    "length (negative for DEL)\">",
    "##INFO=<ID=NCARRIER,Number=1,Type=Integer,Description=\"Samples "
    "carrying this event\">",
    "##FORMAT=<ID=GT,Number=1,Type=String,Description=\"Genotype "
    "(0/1 het, 1/1 hom-del at CN 0; 0/0 non-carrier)\">",
    "##FORMAT=<ID=CN,Number=1,Type=Integer,Description=\"Median EM "
    "copy number over the event's windows (2 on a carrier marks a "
    "mixed-direction merged run; see L2FC)\">",
    "##FORMAT=<ID=L2FC,Number=1,Type=Float,Description=\"Mean log2 "
    "fold change over the event's windows\">",
]


class _BgzfText:
    """Minimal text façade over the streaming BGZF writer."""

    def __init__(self, path: str):
        from ..io.bgzf import BgzfWriter

        self._raw = open(path, "wb")
        self._w = BgzfWriter(self._raw)

    def write(self, s: str) -> None:
        self._w.write(s.encode("utf-8"))

    def close(self) -> None:
        self._w.close()
        self._raw.close()


def _gt(cn: int) -> str:
    if cn == 0:
        return "1/1"
    return "0/1"  # het del (CN1) and any gain both carry one alt allele


def write_cnv_vcf(path_or_fh, calls, samples, contig_lengths=None,
                  source: str = "goleft-tpu cnv",
                  ref_fasta: str | None = None,
                  ref_fai: str | None = None):
    """Write CNV ``calls`` as a multi-sample VCF.

    ``calls``: iterable of (chrom, start, end, sample, cn, log2fc) —
    exactly what :func:`commands.emdepth_cmd.call_cnvs` returns, with
    0-based half-open [start, end) coordinates. ``samples`` fixes the
    column order (every cohort sample appears, carrier or not).
    ``contig_lengths``: optional {chrom: length} for ##contig headers;
    chroms seen only in calls still get an ID-only ##contig line.
    ``ref_fasta``: when given, symbolic-allele records are anchored per
    the VCF 4.2 padding-base convention — POS is the base preceding the
    event and REF is the actual reference base there; without it, POS
    is the first altered base with REF=N (accepted by bcftools/truvari/
    IGV but flagged by strict validators), and the header records which
    convention is in effect either way. ``ref_fai`` points Faidx at a
    user-supplied index; anchoring is best-effort — an unreadable
    fasta/index downgrades to the no-fasta convention rather than
    failing the write after the whole pipeline has run.
    Returns the number of VCF records written.
    """
    fx = None
    if ref_fasta:
        from ..io.fai import Faidx

        try:
            fx = Faidx(ref_fasta, fai_path=ref_fai)
        except Exception:  # noqa: BLE001 — anchoring is best-effort
            fx = None
    samples = list(samples)
    col = {s: i for i, s in enumerate(samples)}
    # group per-sample calls into events keyed by locus + direction
    events: dict[tuple, list] = {}
    chrom_order: list[str] = []
    for chrom, start, end, sample, cn, fc in calls:
        if chrom not in chrom_order:
            chrom_order.append(chrom)
        # the 30kb merge can blend a sample's DEL and DUP runs into one
        # call whose MEDIAN CN rounds to 2 (models/emdepth.py Cache) —
        # classify those by the fold-change sign instead of mislabeling
        # a depth loss as <DUP>
        if cn < 2 or (cn == 2 and fc < 0):
            svtype = "DEL"
        else:
            svtype = "DUP"
        events.setdefault((chrom, int(start), int(end), svtype),
                          []).append((sample, int(cn), float(fc)))

    own = isinstance(path_or_fh, str)
    if own and path_or_fh.endswith(".gz"):
        # BGZF, not plain gzip: the named consumers (bcftools index,
        # tabix, IGV) require bgzip-compressed .vcf.gz; BGZF is still a
        # valid gzip stream for everything else
        fh = _BgzfText(path_or_fh)
    elif own:
        fh = xopen(path_or_fh, "w")
    else:
        fh = path_or_fh
    try:
        fh.write("##fileformat=VCFv4.2\n")
        fh.write(f"##source={source}\n")
        fh.write("##cnv_pos_convention=" + (
            "padding-base (POS/REF anchor the reference base preceding "
            "the event per VCF 4.2; events without a resolvable "
            "A/C/G/T anchor — telomeric start, contig absent from the "
            "fasta, or an N-gap anchor base — fall back to REF=N at "
            "the first altered base)" if fx else
            "first-altered-base with REF=N (no reference fasta "
            "consulted; bcftools/truvari/IGV accept this, strict "
            "validators may flag REF)") + "\n")
        contigs = dict(contig_lengths or {})
        for c in chrom_order:
            contigs.setdefault(c, None)
        for c, ln in contigs.items():
            if ln:
                fh.write(f"##contig=<ID={c},length={int(ln)}>\n")
            else:
                fh.write(f"##contig=<ID={c}>\n")
        for line in _HEADER_LINES:
            fh.write(line + "\n")
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\t"
                 "FORMAT\t" + "\t".join(samples) + "\n")
        n = 0
        order = {c: i for i, c in enumerate(chrom_order)}
        for key in sorted(events, key=lambda k: (order[k[0]], k[1],
                                                 k[2], k[3])):
            chrom, start, end, svtype = key
            carriers = events[key]
            fields = ["0/0:2:."] * len(samples)
            for sample, cn, fc in carriers:
                fields[col[sample]] = f"{_gt(cn)}:{cn}:{fc:.3f}"
            svlen = end - start
            if svtype == "DEL":
                svlen = -svlen
            # padding-base anchoring when the reference is available
            # (strict validators flag REF=N at the first altered base);
            # END stays the 1-based inclusive event end under both
            # conventions
            pos1, refb = start + 1, "N"
            if fx is not None and start > 0 and chrom in fx.records:
                try:
                    b = fx.fetch(chrom, start - 1, start).decode(
                        "ascii", "replace").upper()
                except OSError:
                    b = ""
                if b in ("A", "C", "G", "T"):
                    pos1, refb = start, b
            fh.write(
                f"{chrom}\t{pos1}\t"
                f"{svtype}_{chrom}_{start + 1}_{end}\t{refb}\t"
                f"<{svtype}>\t"
                f".\tPASS\tSVTYPE={svtype};END={end};SVLEN={svlen};"
                f"NCARRIER={len(carriers)}\tGT:CN:L2FC\t"
                + "\t".join(fields) + "\n"
            )
            n += 1
        return n
    finally:
        if fx is not None:
            fx.close()
        if own:
            fh.close()
