"""Constants of the Prodigal gene-finding algorithm.

Numeric constants follow Prodigal v2.6.3 (see reference node.h:30-38 and
dprog.h); genetic-code data follows the NCBI translation tables as encoded
by the reference (_translation.h, _sequence.h:45-157).
"""

import numpy as np

# --- algorithm constants (reference: src/Prodigal/node.h:30-38) --------------
STT_NOD = 100000
MIN_GENE = 90
MIN_EDGE_GENE = 60
MAX_SAM_OVLP = 60
ST_WINDOW = 60
OPER_DIST = 60
EDGE_BONUS = 0.74
EDGE_UPS = -1.00
META_PEN = 7.5

# reference: src/pyrodigal/prodigal/dprog.pxd / Prodigal dprog.h
MAX_OPP_OVLP = 200
MAX_NODE_DIST = 500

# reference: src/pyrodigal/lib.pyx:166-207
MIN_SINGLE_GENOME = 20000
IDEAL_SINGLE_GENOME = 100000
WINDOW = 120          # GC frame plot sliding window
MASK_SIZE = 50        # default minimum mask size (sequence.h MASK_SIZE)

PRODIGAL_VERSION = "v2.6.3+c1e2d36"

TRANSLATION_TABLES = frozenset(
    set(range(1, 7)) | set(range(9, 17)) | set(range(21, 27)) | {29, 30} | {32, 33}
)

# --- nucleotide digit encoding (reference: _sequence.h:8-17) -----------------
# A=0, G=1, C=2, T=3, N=6 ; complement of known base is x ^ 0b11
A, G, C, T, N = 0, 1, 2, 3, 6
LETTERS = np.frombuffer(b"AGCTNNN", dtype=np.uint8)  # digit -> ASCII
COMPLEMENT = np.array([T, C, G, A, N, N, N], dtype=np.uint8)

# node types
ATG, GTG, TTG, STOP = 0, 1, 2, 3

NODE_TYPE_NAMES = ["ATG", "GTG", "TTG", "Edge"]

# --- RBS motif / spacer display names (reference: lib.pyx:209-224) -----------
RBS_MOTIF = [
    None, "GGA/GAG/AGG", "3Base/5BMM", "4Base/6BMM", "AGxAG", "AGxAG",
    "GGA/GAG/AGG", "GGxGG", "GGxGG", "AGxAG", "AGGAG(G)/GGAGG",
    "AGGA/GGAG/GAGG", "AGGA/GGAG/GAGG", "GGA/GAG/AGG", "GGxGG",
    "AGGA", "GGAG/GAGG", "AGxAGG/AGGxGG", "AGxAGG/AGGxGG",
    "AGxAGG/AGGxGG", "AGGAG/GGAGG", "AGGAG", "AGGAG", "GGAGG",
    "GGAGG", "AGGAGG", "AGGAGG", "AGGAGG",
]

RBS_SPACER = [
    None, "3-4bp", "13-15bp", "13-15bp", "11-12bp", "3-4bp",
    "11-12bp", "11-12bp", "3-4bp", "5-10bp", "13-15bp", "3-4bp",
    "11-12bp", "5-10bp", "5-10bp", "5-10bp", "5-10bp", "11-12bp",
    "3-4bp", "5-10bp", "11-12bp", "3-4bp", "5-10bp", "3-4bp",
    "5-10bp", "11-12bp", "3-4bp", "5-10bp",
]

# --- stop codons per translation table (reference: lib.pyx:174-202) ----------
STOP_CODONS = {
    1:  ("TAA", "TAG", "TGA"),
    2:  ("TAA", "TAG", "AGA", "AGG"),
    3:  ("TAA", "TAG"),
    4:  ("TAA", "TAG"),
    5:  ("TAA", "TAG"),
    6:  ("TAA", "TAG", "TGA"),
    9:  ("TAA", "TAG"),
    10: ("TAA", "TAG"),
    11: ("TAA", "TAG", "TGA"),
    12: ("TAA", "TAG", "TGA"),
    13: ("TAA", "TAG"),
    14: ("TAG"),
    15: ("TAA", "TGA"),
    16: ("TAA", "TGA"),
    21: ("TAA", "TAG"),
    22: ("TCA", "TAA", "TGA"),
    23: ("TTA", "TAA", "TGA"),
    24: ("TAA", "TAG"),
    25: ("TAA", "TAG"),
    26: ("TAA", "TAG", "TGA"),
    27: (),
    28: (),
    29: ("TGA"),
    30: ("TGA"),
    31: (),
    32: ("TAA", "TGA"),
    33: ("TAG"),
}

# --- genetic code tables ------------------------------------------------------
# Amino-acid for codon index (x0<<4 | x1<<2 | x2) with digits A=0,G=1,C=2,T=3.
# This is standard NCBI genetic-code data in Prodigal's digit order
# (reference: _translation.h:4-37).
_CODES = {
    1:  "KKNNRRSSTTTTIMIIEEDDGGGGAAAAVVVVQQHHRRRRPPPPLLLL**YY*WCCSSSSLLFF",
    2:  "KKNN**SSTTTTMMIIEEDDGGGGAAAAVVVVQQHHRRRRPPPPLLLL**YYWWCCSSSSLLFF",
    3:  "KKNNRRSSTTTTMMIIEEDDGGGGAAAAVVVVQQHHRRRRPPPPTTTT**YYWWCCSSSSLLFF",
    4:  "KKNNRRSSTTTTIMIIEEDDGGGGAAAAVVVVQQHHRRRRPPPPLLLL**YYWWCCSSSSLLFF",
    5:  "KKNNSSSSTTTTMMIIEEDDGGGGAAAAVVVVQQHHRRRRPPPPLLLL**YYWWCCSSSSLLFF",
    6:  "KKNNRRSSTTTTIMIIEEDDGGGGAAAAVVVVQQHHRRRRPPPPLLLLQQYY*WCCSSSSLLFF",
    9:  "NKNNSSSSTTTTIMIIEEDDGGGGAAAAVVVVQQHHRRRRPPPPLLLL**YYWWCCSSSSLLFF",
    10: "KKNNRRSSTTTTIMIIEEDDGGGGAAAAVVVVQQHHRRRRPPPPLLLL**YYCWCCSSSSLLFF",
    11: "KKNNRRSSTTTTIMIIEEDDGGGGAAAAVVVVQQHHRRRRPPPPLLLL**YY*WCCSSSSLLFF",
    12: "KKNNRRSSTTTTIMIIEEDDGGGGAAAAVVVVQQHHRRRRPPPPLSLL**YY*WCCSSSSLLFF",
    13: "KKNNGGSSTTTTMMIIEEDDGGGGAAAAVVVVQQHHRRRRPPPPLLLL**YYWWCCSSSSLLFF",
    14: "NKNNSSSSTTTTIMIIEEDDGGGGAAAAVVVVQQHHRRRRPPPPLLLLY*YYWWCCSSSSLLFF",
    15: "KKNNRRSSTTTTIMIIEEDDGGGGAAAAVVVVQQHHRRRRPPPPLLLL*QYY*WCCSSSSLLFF",
    16: "KKNNRRSSTTTTIMIIEEDDGGGGAAAAVVVVQQHHRRRRPPPPLLLL*LYY*WCCSSSSLLFF",
    21: "NKNNSSSSTTTTMMIIEEDDGGGGAAAAVVVVQQHHRRRRPPPPLLLL**YYWWCCSSSSLLFF",
    22: "KKNNRRSSTTTTIMIIEEDDGGGGAAAAVVVVQQHHRRRRPPPPLLLL*LYY*WCC*SSSLLFF",
    23: "KKNNRRSSTTTTIMIIEEDDGGGGAAAAVVVVQQHHRRRRPPPPLLLL**YY*WCCSSSS*LFF",
    24: "KKNNSKSSTTTTIMIIEEDDGGGGAAAAVVVVQQHHRRRRPPPPLLLL**YYWWCCSSSSLLFF",
    25: "KKNNRRSSTTTTIMIIEEDDGGGGAAAAVVVVQQHHRRRRPPPPLLLL**YYGWCCSSSSLLFF",
    26: "KKNNRRSSTTTTIMIIEEDDGGGGAAAAVVVVQQHHRRRRPPPPLALL**YY*WCCSSSSLLFF",
    27: "KKNNRRSSTTTTIMIIEEDDGGGGAAAAVVVVQQHHRRRRPPPPLLLLQQYYWWCCSSSSLLFF",
    28: "KKNNRRSSTTTTIMIIEEDDGGGGAAAAVVVVQQHHRRRRPPPPLLLLQQYYWWCCSSSSLLFF",
    29: "KKNNRRSSTTTTIMIIEEDDGGGGAAAAVVVVQQHHRRRRPPPPLLLLYYYY*WCCSSSSLLFF",
    30: "KKNNRRSSTTTTIMIIEEDDGGGGAAAAVVVVQQHHRRRRPPPPLLLLEEYY*WCCSSSSLLFF",
    31: "KKNNRRSSTTTTIMIIEEDDGGGGAAAAVVVVQQHHRRRRPPPPLLLLEEYYWWCCSSSSLLFF",
    32: "KKNNRRSSTTTTIMIIEEDDGGGGAAAAVVVVQQHHRRRRPPPPLLLL*WYY*WCCSSSSLLFF",
    33: "KKNNSKSSTTTTIMIIEEDDGGGGAAAAVVVVQQHHRRRRPPPPLLLLY*YYWWCCSSSSLLFF",
}

# (34, 64) uint8 amino-acid lookup: TRANS_TABLE[tt, codon_index] -> ASCII
TRANS_TABLE = np.zeros((34, 64), dtype=np.uint8)
for _tt, _aas in _CODES.items():
    TRANS_TABLE[_tt] = np.frombuffer(_aas.encode("ascii"), dtype=np.uint8)

# stop-codon membership per table for the three canonical stops
# (reference: _sequence.h:117-157)
_TAA_STOP = np.array([0,1,1,1,1,1,0,0,0,1,1,1,1,1,0,1,1,0,0,0,0,1,1,1,1,1,1,0,0,0,0,0,1,0], dtype=np.uint8)
_TAG_STOP = np.array([0,1,1,1,1,1,0,0,0,1,1,1,1,1,1,0,0,0,0,0,0,1,0,1,1,1,1,0,0,0,0,0,0,1], dtype=np.uint8)
_TGA_STOP = np.array([0,1,0,0,0,0,1,0,0,0,0,1,1,0,0,1,1,0,0,0,0,0,1,1,0,0,1,0,0,1,1,0,1,0], dtype=np.uint8)


def is_stop_codon(x0, x1, x2, tt):
    """Scalar stop-codon test in digit space (reference: _sequence.h:117-157)."""
    if x0 == T and x1 == A and x2 == G:
        return bool(_TAG_STOP[tt])
    if x0 == T and x1 == G and x2 == A:
        return bool(_TGA_STOP[tt])
    if x0 == T and x1 == A and x2 == A:
        return bool(_TAA_STOP[tt])
    if tt == 2:
        return x0 == A and x1 == G and (x2 == A or x2 == G)
    if tt == 22:
        return x0 == T and x1 == C and x2 == A
    if tt == 23:
        return x0 == T and x1 == T and x2 == A
    return False


def is_start_codon(x0, x1, x2, tt):
    """Scalar start-codon test in digit space (reference: _sequence.h:45-73)."""
    if x0 == A and x1 == T and x2 == G:
        return True
    if tt in (6, 10, 14, 15, 16, 2):
        return False
    if x0 == G and x1 == T and x2 == G:
        return tt not in (1, 3, 12, 2)
    if x0 == T and x1 == T and x2 == G:
        return not (tt < 4 or tt == 9 or (21 <= tt < 25))
    return False


# --- stop / start codon tables in vectorized form ----------------------------
# STOP_TABLE[tt, codon] / START_TABLE[tt, codon] -> uint8 flags over the 64
# codon indices; used by the vectorized (numpy / JAX) node pipelines.
STOP_TABLE = np.zeros((34, 64), dtype=np.uint8)
START_TABLE = np.zeros((34, 64), dtype=np.uint8)
for _tt in range(34):
    for _x0 in range(4):
        for _x1 in range(4):
            for _x2 in range(4):
                _ndx = (_x0 << 4) | (_x1 << 2) | _x2
                STOP_TABLE[_tt, _ndx] = is_stop_codon(_x0, _x1, _x2, _tt)
                START_TABLE[_tt, _ndx] = is_start_codon(_x0, _x1, _x2, _tt)
