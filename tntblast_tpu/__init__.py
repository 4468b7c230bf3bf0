"""tntblast_tpu: an accelerator-backed assay-specific sequence-search engine.

A from-scratch reimplementation of the capabilities of
jgans/thermonucleotideBLAST (reference v2.77): given assay queries (PCR
primer pairs, TaqMan triplets, padlock/MIPS probe pairs, or single
hybridization probes) and a nucleotide database, find every site where the
assay "fires" under the SantaLucia nearest-neighbor thermodynamic model.

Architecture (JAX device path plus a native host engine, not a port):
  - ``thermo``   : SantaLucia parameter tables as arrays (single source of
                   truth for both the native engine and the device DP).
  - ``native``   : C++ exact melt engine (batched DP + co-optimal path
                   enumeration + exact re-scoring) driven through ctypes.
  - ``ops``      : JAX batched DP and gapless-evaluation stages.
  - ``io``       : sequence database readers (FASTA/FASTQ/gzip, GBK/EMBL).
  - ``search``   : candidate generation and assay pairing logic.
  - ``engine``   : single-host end-to-end search pipeline.
  - ``parallel`` : the device search step, its host-side manager, and
                   multi-device / multi-process sharding of fragments.

Numerical contract: bit-identical hit lists vs the reference binary
(amplicons, Tm, dH, dS, alignments, coordinates, output text format).
"""

__version__ = "0.1.0"
