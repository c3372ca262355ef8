"""Predicted genes, translation, and the five output writers.

Mirrors the reference `Gene`/`Genes` behaviour (reference: lib.pyx:2597-3893):
GFF3, GenBank, nucleotide/protein FASTA and the start-score table, with
byte-compatible formatting.
"""

import ctypes
import datetime
import textwrap

import numpy as np

from ._constants import (
    STOP, NODE_TYPE_NAMES, RBS_MOTIF, RBS_SPACER, STOP_CODONS,
    TRANS_TABLE, STOP_TABLE, START_TABLE, LETTERS, COMPLEMENT,
    TRANSLATION_TABLES,
)
from . import _native
from . import __about__


def _mer_text(length, ndx):
    """k-mer index -> ACGT text; first base is in the low bits
    (reference: prodigal/sequence.pxd:43)."""
    letters = "AGCT"
    return "".join(letters[(ndx >> (2 * i)) & 3] for i in range(length))


def translate_span(digits, slen, begin, end, strand, tt,
                   is_init_first, unknown_residue="X", strict=True):
    """Translate codons [begin, end) (step 3) on the given strand.

    Follows `Sequence._amino` (reference: lib.pyx:770-789, _sequence.h:75-115):
    stops render as '*', an initial start codon renders as 'M', codons with
    unknown nucleotides render as `unknown_residue` (in non-strict mode an
    unknown in the wobble position is resolved when unambiguous).
    """
    j = np.arange(begin, end, 3)
    if strand == 1:
        x0 = digits[j].astype(np.int32)
        x1 = digits[j + 1].astype(np.int32)
        x2 = digits[j + 2].astype(np.int32)
    else:
        x0 = (digits[slen - 1 - j].astype(np.int32)) ^ 3
        x1 = (digits[slen - 2 - j].astype(np.int32)) ^ 3
        x2 = (digits[slen - 3 - j].astype(np.int32)) ^ 3

    known = (x0 <= 3) & (x1 <= 3) & (x2 <= 3)
    idx = ((x0 & 3) << 4) | ((x1 & 3) << 2) | (x2 & 3)
    aa = np.where(known, TRANS_TABLE[tt][idx], ord(unknown_residue))

    if not strict:
        # resolve NNx wobble ambiguity when the translation is unambiguous
        wobble = (x0 <= 3) & (x1 <= 3) & (x2 > 3)
        if wobble.any():
            base = ((x0 & 3) << 4) | ((x1 & 3) << 2)
            cand = TRANS_TABLE[tt][base[wobble, None] + np.arange(4)]
            uniq = (cand == cand[:, :1]).all(axis=1)
            res = np.where(uniq, cand[:, 0], ord(unknown_residue))
            aa[wobble] = res

    is_stop = known & (STOP_TABLE[tt][idx] == 1)
    aa = np.where(is_stop, ord("*"), aa)
    if is_init_first and len(aa) > 0:
        if known[0] and not is_stop[0] and START_TABLE[tt][idx[0]]:
            aa[0] = ord("M")
    return aa.astype(np.uint8).tobytes().decode("ascii")


class Gene:
    """A single predicted gene (1-based, end-inclusive coordinates)."""

    __slots__ = ("owner", "_i")

    def __init__(self, owner, i):
        self.owner = owner
        self._i = i

    def __repr__(self):
        ty = type(self)
        return (
            f"<{ty.__module__}.{ty.__name__} begin={self.begin!r} end={self.end!r} "
            f"strand={self.strand:+} start_type={self.start_type!r} "
            f"rbs_motif={self.rbs_motif!r} rbs_spacer={self.rbs_spacer!r}>"
        )

    # --- coordinates ----------------------------------------------------------

    @property
    def begin(self):
        return int(self.owner._begin[self._i])

    @property
    def end(self):
        return int(self.owner._end[self._i])

    @property
    def _start_ndx(self):
        return int(self.owner._start_ndx[self._i])

    @property
    def _stop_ndx(self):
        return int(self.owner._stop_ndx[self._i])

    @property
    def strand(self):
        return int(self.owner.nodes.strand[self._start_ndx])

    @property
    def partial_begin(self):
        if self.strand == 1:
            return bool(self.owner.nodes.edge[self._start_ndx])
        return bool(self.owner.nodes.edge[self._stop_ndx])

    @property
    def partial_end(self):
        if self.strand == 1:
            return bool(self.owner.nodes.edge[self._stop_ndx])
        return bool(self.owner.nodes.edge[self._start_ndx])

    @property
    def start_type(self):
        nodes = self.owner.nodes
        n = self._start_ndx
        t = 3 if nodes.edge[n] else int(nodes.type[n])
        return NODE_TYPE_NAMES[t]

    # --- RBS report (reference: lib.pyx:2694-2751) ----------------------------

    def _rbs_fields(self):
        nodes = self.owner.nodes
        tinf = self.owner.training_info
        n = self._start_ndx
        rbs = [int(nodes.rbs0[n]), int(nodes.rbs1[n])]
        rbs_wt = tinf.rbs_weights
        rbs1 = rbs_wt[rbs[0]] * tinf.start_weight
        rbs2 = rbs_wt[rbs[1]] * tinf.start_weight
        mot_score = float(nodes.mot_score[n])
        no_mot = tinf.missing_motif_weight
        if tinf.uses_sd:
            k = rbs[0 if rbs1 > rbs2 else 1]
            return RBS_MOTIF[k], RBS_SPACER[k]
        if no_mot > -0.5 and rbs1 > rbs2 and rbs1 > mot_score * tinf.start_weight:
            return RBS_MOTIF[rbs[0]], RBS_SPACER[rbs[0]]
        if no_mot > -0.5 and rbs2 >= rbs1 and rbs2 > mot_score * tinf.start_weight:
            return RBS_MOTIF[rbs[1]], RBS_SPACER[rbs[1]]
        if nodes.mot_len[n] == 0:
            return None, None
        return (
            _mer_text(int(nodes.mot_len[n]), int(nodes.mot_ndx[n])),
            f"{int(nodes.mot_spacer[n])}bp",
        )

    @property
    def rbs_motif(self):
        return self._rbs_fields()[0]

    @property
    def rbs_spacer(self):
        return self._rbs_fields()[1]

    # --- scores ---------------------------------------------------------------

    @property
    def gc_cont(self):
        return float(self.owner.nodes.gc_cont[self._start_ndx])

    @property
    def translation_table(self):
        return self.owner.training_info.translation_table

    @property
    def cscore(self):
        return float(self.owner.nodes.cscore[self._start_ndx])

    @property
    def rscore(self):
        return float(self.owner.nodes.rscore[self._start_ndx])

    @property
    def sscore(self):
        return float(self.owner.nodes.sscore[self._start_ndx])

    @property
    def tscore(self):
        return float(self.owner.nodes.tscore[self._start_ndx])

    @property
    def uscore(self):
        return float(self.owner.nodes.uscore[self._start_ndx])

    @property
    def score(self):
        return self.cscore + self.sscore

    @property
    def start_node(self):
        return self.owner.nodes[self._start_ndx]

    @property
    def stop_node(self):
        return self.owner.nodes[self._stop_ndx]

    def confidence(self):
        """(reference: lib.pyx:2861-2872; Prodigal gene.c)"""
        return _native.lib.rc_calculate_confidence(
            self.cscore + self.sscore, self.owner.training_info.start_weight
        )

    # --- sequence / translation ----------------------------------------------

    def sequence(self):
        """Nucleotide sequence, reverse-complemented for reverse-strand genes."""
        seq = self.owner.sequence
        digits = seq.digits
        slen = seq.slen
        if self.strand == 1:
            sub = digits[self.begin - 1:self.end]
            return LETTERS[sub].tobytes().decode("ascii")
        sub = digits[self.begin - 1:self.end][::-1]
        return LETTERS[COMPLEMENT[sub]].tobytes().decode("ascii")

    def translate(self, translation_table=None, unknown_residue="X",
                  include_stop=True, strict=True):
        """Protein sequence (reference: lib.pyx:2932-3047)."""
        import warnings

        owner_table = self.owner.training_info.translation_table
        if translation_table is None:
            tt = owner_table
        elif translation_table not in STOP_CODONS:
            raise ValueError(
                f"{translation_table} is not a valid translation table index"
            )
        else:
            if STOP_CODONS[translation_table] != STOP_CODONS[owner_table]:
                warnings.warn(
                    f"requested translation table ({translation_table!r}) has "
                    f"different STOP codons than the one these genes were called "
                    f"with ({owner_table!r}), consider calling genes with the "
                    "proper translation table instead. This may become an error "
                    "in the future.",
                    stacklevel=2,
                )
            tt = translation_table

        seq = self.owner.sequence
        slen = seq.slen
        nodes = self.owner.nodes
        start_edge = bool(nodes.edge[self._start_ndx])
        stop_edge = bool(nodes.edge[self._stop_ndx])
        strand = self.strand

        if strand == 1:
            begin = self.begin - 1
            end = self.end - 1
        else:
            begin = slen - self.end
            end = slen - self.begin

        if not stop_edge and not include_stop:
            end -= 3

        return translate_span(
            seq.digits, slen, begin, end, strand, tt,
            is_init_first=not start_edge,
            unknown_residue=unknown_residue, strict=strict,
        )

    # --- metadata strings -----------------------------------------------------

    def _gene_data(self, sequence_id):
        return (
            "ID={}_{};partial={}{};start_type={};rbs_motif={};rbs_spacer={};"
            "gc_cont={:.3f}".format(
                sequence_id,
                self._i + 1,
                int(self.partial_begin),
                int(self.partial_end),
                self.start_type,
                self.rbs_motif,
                self.rbs_spacer,
                self.gc_cont,
            )
        )

    def _score_data(self):
        return (
            "conf={:.2f};score={:.2f};cscore={:.2f};sscore={:.2f};"
            "rscore={:.2f};uscore={:.2f};tscore={:.2f};".format(
                self.confidence(), self.score, self.cscore, self.sscore,
                self.rscore, self.uscore, self.tscore,
            )
        )


class Genes:
    """All genes found in a single sequence."""

    def __init__(self):
        self._begin = np.zeros(0, dtype=np.int32)
        self._end = np.zeros(0, dtype=np.int32)
        self._start_ndx = np.zeros(0, dtype=np.int32)
        self._stop_ndx = np.zeros(0, dtype=np.int32)
        self.nodes = None
        self.sequence = None
        self.training_info = None
        self.meta = False
        self.metagenomic_bin = None
        self.ipath = -1
        self._num_seq = 1

    def __bool__(self):
        return len(self) > 0

    def __len__(self):
        return len(self._begin)

    def __getitem__(self, index):
        n = len(self)
        if index < 0:
            index += n
        if index >= n or index < 0:
            raise IndexError("genes index out of range")
        return Gene(self, index)

    def __iter__(self):
        for i in range(len(self)):
            yield Gene(self, i)

    def __reversed__(self):
        for i in reversed(range(len(self))):
            yield Gene(self, i)

    @property
    def score(self):
        """Total score of the gene path (reference: lib.pyx:3171-3184)."""
        if self.ipath < 0:
            return 0.0
        return float(self.nodes.score[self.ipath])

    # --- pickling (reference: lib.pyx:3107-3167) ------------------------------

    def __getstate__(self):
        state = {
            "_num_seq": self._num_seq,
            "meta": self.meta,
            "ipath": self.ipath,
            "nodes": self.nodes,
            "sequence": self.sequence,
            "genes": {
                "begin": self._begin, "end": self._end,
                "start_ndx": self._start_ndx, "stop_ndx": self._stop_ndx,
            },
        }
        if self.meta:
            state["metagenomic_bin"] = self.metagenomic_bin
        else:
            state["training_info"] = self.training_info
        return state

    def __setstate__(self, state):
        self._num_seq = state["_num_seq"]
        self.meta = state["meta"]
        self.ipath = state.get("ipath", -1)
        self.nodes = state["nodes"]
        self.sequence = state["sequence"]
        g = state["genes"]
        self._begin = g["begin"]
        self._end = g["end"]
        self._start_ndx = g["start_ndx"]
        self._stop_ndx = g["stop_ndx"]
        if self.meta:
            self.metagenomic_bin = state["metagenomic_bin"]
            self.training_info = (
                None if self.metagenomic_bin is None
                else self.metagenomic_bin.training_info
            )
        else:
            self.metagenomic_bin = None
            self.training_info = state["training_info"]

    # --- extraction -----------------------------------------------------------

    def _extract(self, nodes, ipath):
        self.ipath = ipath
        cap = max(64, nodes.length)
        while True:
            b = np.zeros(cap, dtype=np.int32)
            e = np.zeros(cap, dtype=np.int32)
            sn = np.zeros(cap, dtype=np.int32)
            en = np.zeros(cap, dtype=np.int32)
            s = nodes._struct()
            ng = _native.lib.rc_extract_genes(
                ctypes.byref(s), int(ipath),
                _native.i32(b), _native.i32(e), _native.i32(sn), _native.i32(en),
                cap,
            )
            if ng >= 0:
                self._begin = b[:ng].copy()
                self._end = e[:ng].copy()
                self._start_ndx = sn[:ng].copy()
                self._stop_ndx = en[:ng].copy()
                return ng
            cap *= 2

    def _tweak_final_starts(self, nodes, training_info, max_sam_overlap):
        s = nodes._struct()
        _native.lib.rc_tweak_final_starts(
            ctypes.byref(s), len(self),
            _native.i32(self._begin), _native.i32(self._end),
            _native.i32(self._start_ndx), _native.i32(self._stop_ndx),
            _native.u8(training_info.raw), int(max_sam_overlap),
        )

    def _clear(self):
        self._begin = np.zeros(0, dtype=np.int32)
        self._end = np.zeros(0, dtype=np.int32)
        self._start_ndx = np.zeros(0, dtype=np.int32)
        self._stop_ndx = np.zeros(0, dtype=np.int32)
        self.ipath = -1

    # --- writers (reference: lib.pyx:3405-3893) -------------------------------

    def write_gff(self, file, sequence_id, header=True,
                  include_translation_table=False, full_id=True,
                  version_separator="_v"):
        n = 0
        run = "Metagenomic" if self.meta else "Single"
        meta_bin = self.metagenomic_bin
        tinf = self.training_info
        version = __about__.__version__

        if self.meta:
            if meta_bin is None:
                from .metagenomic import METAGENOMIC_BINS
                meta_bin = METAGENOMIC_BINS[5]
            if tinf is None:
                tinf = meta_bin.training_info
            desc = meta_bin.description
        else:
            desc = "Ab initio"

        if header:
            n += file.write("##gff-version  3\n")
        n += file.write(
            f"# Sequence Data: "
            f"seqnum={self._num_seq};"
            f"seqlen={len(self.sequence)};"
            f'seqhdr="{sequence_id}"\n'
        )
        n += file.write(
            f"# Model Data: "
            f"version=pyrodigal_tpu.v{version};"
            f"run_type={run};"
            f'model="{desc}";'
            f"gc_cont={tinf.gc * 100:.2f};"
            f"transl_table={tinf.translation_table};"
            f"uses_sd={int(tinf.uses_sd)}\n"
        )
        source = f"pyrodigal_tpu{version_separator}{version}"
        tt_attr = (f"transl_table={tinf.translation_table};"
                   if include_translation_table else "")
        for gene in self:
            ident = gene._gene_data(sequence_id if full_id
                                    else self._num_seq)
            n += file.write(
                f"{sequence_id}\t{source}\tCDS\t{gene.begin}\t{gene.end}"
                f"\t{gene.sscore + gene.cscore:.1f}"
                f"\t{'+' if gene.strand > 0 else '-'}\t0"
                f"\t{ident};{tt_attr}{gene._score_data()}\n"
            )
        return n

    def write_genes(self, file, sequence_id, width=70, full_id=False):
        n = 0
        for i, gene in enumerate(self):
            data = (
                gene._gene_data(sequence_id) if full_id
                else gene._gene_data(self._num_seq)
            )
            n += file.write(
                f">{sequence_id}_{i + 1} # {gene.begin} # {gene.end} # "
                f"{gene.strand} # {data}\n"
            )
            for line in textwrap.wrap(gene.sequence(), width=width):
                n += file.write(line)
                n += file.write("\n")
        return n

    def write_translations(self, file, sequence_id, width=60,
                           translation_table=None, include_stop=True,
                           strict_translation=True, full_id=False):
        if (translation_table is not None
                and translation_table not in TRANSLATION_TABLES):
            raise ValueError(
                f"{translation_table} is not a valid translation table index"
            )
        n = 0
        for i, gene in enumerate(self):
            data = (
                gene._gene_data(sequence_id) if full_id
                else gene._gene_data(self._num_seq)
            )
            n += file.write(
                f">{sequence_id}_{i + 1} # {gene.begin} # {gene.end} # "
                f"{gene.strand} # {data}\n"
            )
            trans = gene.translate(
                translation_table, include_stop=include_stop,
                strict=strict_translation,
            )
            for line in textwrap.wrap(trans, width=width):
                n += file.write(line)
                n += file.write("\n")
        return n

    def write_genbank(self, file, sequence_id, division="BCT", date=None,
                      translation_table=None, strict_translation=True):
        n = 0
        version = __about__.__version__
        if translation_table is None:
            if self.training_info is not None:
                translation_table = self.training_info.translation_table
        elif translation_table not in TRANSLATION_TABLES:
            raise ValueError(
                f"{translation_table} is not a valid translation table index"
            )
        if date is None:
            date = datetime.date.today()
        elif not isinstance(date, datetime.date):
            raise TypeError(
                f"Expected datetime.date, found {type(date).__name__}"
            )

        slen = len(self.sequence)
        stamp = date.strftime("%d-%b-%y").upper()
        n += file.write(
            f"LOCUS       {sequence_id:<23} {slen} bp    "
            f"DNA     linear   {division} {stamp}\n"
            f"REFERENCE   1  (bases 1 to {slen})\n"
            "  TITLE     Prodigal: prokaryotic gene recognition and"
            " translation initiation\n"
            "            site identification (Hyatt et al., 2010)\n"
            "  JOURNAL   BMC Bioinformatics. 2010;11:119.\n"
            "   PUBMED   20211023\n"
            "FEATURES             Location/Qualifiers\n"
        )
        pad = " " * 21
        for i, gene in enumerate(self):
            begin = f"<{gene.begin}" if gene.start_node.edge else str(gene.begin)
            end = f">{gene.end}" if gene.stop_node.edge else str(gene.end)
            span = (f"{begin}..{end}" if gene.strand == 1
                    else f"complement({begin}..{end})")
            record = [
                f"     CDS             {span}",
                f"{pad}/codon_start=1",
                f'{pad}/inference="ab initio prediction:'
                f'pyrodigal_tpu:{version}"',
                f'{pad}/locus_tag="{sequence_id}_{i + 1}"',
                f"{pad}/transl_table={translation_table}",
            ]
            trans = gene.translate(
                translation_table=translation_table,
                include_stop=False,
                strict=strict_translation,
            )
            record += [pad + block
                       for block in textwrap.wrap(f'/translation="{trans}"',
                                                  59)]
            n += file.write("\n".join(record) + "\n")
        seq = str(self.sequence).lower()
        origin = ["ORIGIN"]
        for i in range(0, slen, 60):
            blocks = " ".join(seq[j:j + 10]
                              for j in range(i, min(i + 60, slen), 10))
            origin.append(f"{i + 1:>9} {blocks}")
        n += file.write("\n".join(origin) + "\n//\n")
        return n

    def write_scores(self, file, sequence_id, header=True):
        """Start-score table (reference: lib.pyx:3783-3893)."""
        n = 0
        nodes = self.nodes
        version = __about__.__version__
        if self.meta and self.training_info is None:
            from .metagenomic import METAGENOMIC_BINS
            tinf = METAGENOMIC_BINS[5].training_info
        else:
            tinf = self.training_info

        rbs_wt = tinf.rbs_weights
        st_wt = tinf.start_weight
        uses_sd = tinf.uses_sd
        no_mot = tinf.missing_motif_weight

        order = nodes.stop_order()
        prev_stop = -1
        prev_strand = 0

        if header:
            n += file.write(
                f'# Sequence Data: seqnum={self._num_seq};'
                f'seqlen={len(self.sequence)};seqhdr="{sequence_id}"\n'
            )
            n += file.write(
                f"# Run Data: version=pyrodigal_tpu.v{version};"
                f"gc_cont={tinf.gc * 100:.2f};"
                f"transl_table={tinf.translation_table};"
                f"uses_sd={int(tinf.uses_sd)}\n"
            )
            n += file.write(
                "Beg\tEnd\tStd\tTotal\tCodPot\tStrtSc\tCodon\tRBSMot\t"
                "Spacer\tRBSScr\tUpsScr\tTypeScr\tGCCont\n"
            )

        for k in order:
            if nodes.type[k] == STOP:
                continue
            st_type = STOP if nodes.edge[k] else int(nodes.type[k])
            if nodes.stop_val[k] != prev_stop or nodes.strand[k] != prev_strand:
                prev_stop = int(nodes.stop_val[k])
                prev_strand = int(nodes.strand[k])
                n += file.write("\n")
            if nodes.strand[k] == 1:
                n += file.write(f"{nodes.ndx[k] + 1:d}\t")
                n += file.write(f"{nodes.stop_val[k] + 3:d}\t")
                n += file.write("+\t")
            else:
                n += file.write(f"{nodes.stop_val[k] - 1:d}\t")
                n += file.write(f"{nodes.ndx[k] + 1:d}\t")
                n += file.write("-\t")
            n += file.write(f"{nodes.cscore[k] + nodes.sscore[k]:.2f}\t")
            n += file.write(f"{nodes.cscore[k]:.2f}\t")
            n += file.write(f"{nodes.sscore[k]:.2f}\t")
            n += file.write(f"{NODE_TYPE_NAMES[st_type]}\t")

            rbs1 = rbs_wt[nodes.rbs0[k]] * st_wt
            rbs2 = rbs_wt[nodes.rbs1[k]] * st_wt
            if uses_sd:
                ri = nodes.rbs0[k] if rbs1 > rbs2 else nodes.rbs1[k]
                n += file.write(f"{RBS_MOTIF[ri]}\t")
                n += file.write(f"{RBS_SPACER[ri]}\t")
                n += file.write(f"{nodes.rscore[k]:.2f}\t")
            else:
                mot_sc = float(nodes.mot_score[k])
                if no_mot > -0.5 and rbs1 > rbs2 and rbs1 > mot_sc * st_wt:
                    n += file.write(f"{RBS_MOTIF[nodes.rbs0[k]]}\t")
                    n += file.write(f"{RBS_SPACER[nodes.rbs0[k]]}\t")
                    n += file.write(f"{nodes.rscore[k]:.2f}\t")
                elif no_mot > -0.5 and rbs2 >= rbs1 and rbs2 > mot_sc * st_wt:
                    n += file.write(f"{RBS_MOTIF[nodes.rbs1[k]]}\t")
                    n += file.write(f"{RBS_SPACER[nodes.rbs1[k]]}\t")
                    n += file.write(f"{nodes.rscore[k]:.2f}\t")
                elif nodes.mot_len[k] == 0:
                    n += file.write(f"None\tNone\t{nodes.rscore[k]:.2f}\t")
                else:
                    qt = _mer_text(int(nodes.mot_len[k]), int(nodes.mot_ndx[k]))
                    n += file.write(
                        f"{qt}\t{int(nodes.mot_spacer[k]):d}bp\t{nodes.rscore[k]:.2f}\t"
                    )
            n += file.write(f"{nodes.uscore[k]:.2f}\t")
            n += file.write(f"{nodes.tscore[k]:.2f}\t")
            n += file.write(f"{nodes.gc_cont[k]:.3f}\n")
        n += file.write("\n")
        return n
