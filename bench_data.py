"""Deterministic benchmark fixture generator.

Builds (once, cached under bench_work/) the standard benchmark config:
  - genome.fna : NSEQ sequences x SEQLEN bases of seeded-random ATGC with
    planted forward/reverse primer sites so PCR amplicons actually occur
    (exercises the full pipeline: seeding, DP, pairing, output).
  - panel.txt  : NASSAY PCR primer pairs (the first NPLANT of which are
    planted in the genome; the rest probe random background).

The same files feed both the reference binary (CPU baseline measurement,
recorded in BASELINE.md) and bench.py (this engine's measurement), so the
work is identical on both sides.
"""

import os

import numpy as np

NSEQ = 4
SEQLEN = 2_000_000          # 8 Mb total
NASSAY = 10
NPLANT = 5                  # assays actually present in the genome
PLANTS_PER_SEQ = 6          # sites per planted assay per sequence
AMPLEN = 150
SEED = 20260818

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _rand_seq(rng, n):
    return rng.integers(0, 4, n, dtype=np.uint8)


def _to_str(codes):
    return BASES[codes].tobytes().decode()


def _revcomp(codes):
    return (3 - codes)[::-1]


def build(workdir):
    os.makedirs(workdir, exist_ok=True)
    fna = os.path.join(workdir, "genome.fna")
    panel = os.path.join(workdir, "panel.txt")
    if os.path.exists(fna) and os.path.exists(panel):
        return fna, panel

    rng = np.random.default_rng(SEED)

    # Assay panel: 20-24 nt primers.
    assays = []
    for a in range(NASSAY):
        flen = int(rng.integers(20, 25))
        rlen = int(rng.integers(20, 25))
        f = _rand_seq(rng, flen)
        r = _rand_seq(rng, rlen)
        assays.append((f"BENCH{a:02d}", f, r))

    seqs = []
    for s in range(NSEQ):
        g = _rand_seq(rng, SEQLEN)
        # Plant amplicons: F ... (amplicon interior) ... revcomp(R)
        for a in range(NPLANT):
            _, f, r = assays[a]
            for _ in range(PLANTS_PER_SEQ):
                pos = int(rng.integers(0, SEQLEN - AMPLEN - 1))
                g[pos:pos + len(f)] = f
                rrc = _revcomp(r)
                g[pos + AMPLEN - len(rrc):pos + AMPLEN] = rrc
        seqs.append(g)

    with open(fna + ".tmp", "w") as fh:
        for s, g in enumerate(seqs):
            fh.write(f">bench_seq_{s} synthetic benchmark sequence\n")
            txt = _to_str(g)
            for i in range(0, len(txt), 70):
                fh.write(txt[i:i + 70] + "\n")
    os.replace(fna + ".tmp", fna)

    with open(panel + ".tmp", "w") as fh:
        for name, f, r in assays:
            fh.write(f"{name}\t{_to_str(f)}\t{_to_str(r)}\n")
    os.replace(panel + ".tmp", panel)
    return fna, panel


if __name__ == "__main__":
    f, p = build(os.path.join(os.path.dirname(__file__), "bench_work"))
    print(f)
    print(p)
