"""BASELINE config-5 scale benchmark: multi-GB database, PCR + padlock
batches, 1-host / 2-process / mesh / device rows.

Builds (once) a 1.024 Gb synthetic database (8 x 128 Mb sequences) with
planted PCR amplicons and padlock ligation sites, then runs each requested
mode once (runs at this scale take minutes; the single-run wall time is
the metric) and records Mb/s plus the sha256 of the hit list.
Byte-equality across modes is the correctness contract.
`build(workdir, nseq=1)` makes the first 128 Mb sequence alone (same seed
and planting), a chromosome-scale single target.

Usage: python tools/scaled_bench.py [mode ...]
  modes: host twoproc screen mesh   (default: host twoproc)
"""

import hashlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402

NSEQ = 8
SEQLEN = 128_000_000           # 1.024 Gb total
NASSAY = 10
NPLANT = 5
PLANTS_PER_SEQ = 40
AMPLEN = 150
NPAD = 6                       # padlock assays (4 planted)
SEED = 20260821

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def emit(o):
    o["t"] = time.strftime("%H:%M:%S")
    print(json.dumps(o))
    sys.stdout.flush()


def _to_str(codes):
    return BASES[codes].tobytes().decode()


def _revcomp(codes):
    return (3 - codes)[::-1]


def build(workdir, nseq=NSEQ):
    """(fasta, PCR panel, PADLOCK panel) paths; the fasta holds the first
    `nseq` sequences of the seeded database."""
    os.makedirs(workdir, exist_ok=True)
    tag = "" if nseq == NSEQ else f"_{nseq}seq"
    fna = os.path.join(workdir, f"scaled{tag}.fna")
    pcr = os.path.join(workdir, "scaled_pcr.txt")
    pad = os.path.join(workdir, "scaled_padlock.txt")
    if all(os.path.exists(p) for p in (fna, pcr, pad)):
        return fna, pcr, pad
    rng = np.random.default_rng(SEED)

    assays = []
    for a in range(NASSAY):
        f = rng.integers(0, 4, int(rng.integers(20, 25)), dtype=np.uint8)
        r = rng.integers(0, 4, int(rng.integers(20, 25)), dtype=np.uint8)
        assays.append((f"SCPCR{a:02d}", f, r))
    pads = []
    for a in range(NPAD):
        up = rng.integers(0, 4, int(rng.integers(20, 25)), dtype=np.uint8)
        dn = rng.integers(0, 4, int(rng.integers(20, 25)), dtype=np.uint8)
        pads.append((f"SCPAD{a:02d}", up, dn))

    t0 = time.time()
    with open(fna + ".tmp", "w") as fh:
        for s in range(nseq):
            g = rng.integers(0, 4, SEQLEN, dtype=np.uint8)
            for a in range(NPLANT):
                _, f, r = assays[a]
                for _ in range(PLANTS_PER_SEQ):
                    pos = int(rng.integers(0, SEQLEN - AMPLEN - 1))
                    g[pos:pos + len(f)] = f
                    rrc = _revcomp(r)
                    g[pos + AMPLEN - len(rrc):pos + AMPLEN] = rrc
            for a in range(4):                 # planted padlock sites:
                # query columns are (up_arm, down_arm); the engine's
                # DOWN arm (col 2) binds first, so the plus-strand site
                # is up_arm || down_arm with gap 0 (verified small-scale)
                name, up, dn = pads[a]
                site = np.concatenate([up, dn])
                for _ in range(PLANTS_PER_SEQ):
                    pos = int(rng.integers(0, SEQLEN - len(site) - 1))
                    g[pos:pos + len(site)] = site
            txt = BASES[g].tobytes()
            fh.write(f">scaled_seq_{s} synthetic 128 Mb sequence\n")
            for i in range(0, len(txt), 70):
                fh.write(txt[i:i + 70].decode())
                fh.write("\n")
            emit({"gen_seq": s, "s": round(time.time() - t0, 1)})
    os.replace(fna + ".tmp", fna)
    with open(pcr + ".tmp", "w") as fh:
        for name, f, r in assays:
            fh.write(f"{name}\t{_to_str(f)}\t{_to_str(r)}\n")
    os.replace(pcr + ".tmp", pcr)
    with open(pad + ".tmp", "w") as fh:
        for name, up, dn in pads:
            fh.write(f"{name}\t{_to_str(up)}\t{_to_str(dn)}\n")
    os.replace(pad + ".tmp", pad)
    return fna, pcr, pad


def sha(path):
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


GB_MB = NSEQ * SEQLEN / 1e6


def run_mode(mode, fmt, fna, qfile, workdir):
    out = os.path.join(workdir, f"scaled_{fmt}_{mode}.out")
    if os.path.exists(out):
        os.unlink(out)
    if fmt == "PCR":
        argv = ["-i", qfile, "-d", fna, "-A", "PCR", "-e", "40", "-E",
                "45", "-l", "2000", "-o", out]
    else:
        argv = ["-i", qfile, "-d", fna, "-A", "PADLOCK", "-e", "40",
                "-E", "45", "-o", out]
    env = dict(os.environ)
    t0 = time.time()
    if mode == "host":
        env["TNTBLAST_TPU_THREADS"] = "2"
        rc = subprocess.call(
            [sys.executable, "-m", "tntblast_tpu"] + argv,
            env=env, cwd=HERE, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL)
    elif mode == "screen":
        env["TNTBLAST_TPU_THREADS"] = "2"
        rc = subprocess.call(
            [sys.executable, "-m", "tntblast_tpu"] + argv
            + ["--tpu-screen", "A"],
            env=env, cwd=HERE, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL)
    elif mode == "mesh":
        env["TNTBLAST_TPU_THREADS"] = "2"
        rc = subprocess.call(
            [sys.executable, "-m", "tntblast_tpu"] + argv + ["--mesh", "T"],
            env=env, cwd=HERE, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL)
    elif mode == "twoproc":
        env["TNTBLAST_TPU_THREADS"] = "1"
        env["JAX_PLATFORMS"] = "cpu"     # host-path ranks
        port = 29517 + (1 if fmt == "PCR" else 2)
        procs = [subprocess.Popen(
            [sys.executable, "-m", "tntblast_tpu.parallel.multiproc",
             "--coordinator", f"127.0.0.1:{port}", "--num-procs", "2",
             "--proc-id", str(p), "--"] + argv,
            env=env, cwd=HERE, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL) for p in (0, 1)]
        rc = max(p.wait() for p in procs)
    else:
        emit({"mode": mode, "error": "unknown mode"})
        return
    dt = time.time() - t0
    emit({"mode": mode, "fmt": fmt, "rc": rc, "s": round(dt, 1),
          "mbps": round(GB_MB / dt, 2),
          "sha": sha(out)[:16] if os.path.exists(out) else None})


def main():
    work = os.path.join(HERE, "bench_work")
    fna, pcr, pad = build(work)
    emit({"built": fna, "mb": GB_MB})
    modes = sys.argv[1:] or ["host", "twoproc"]
    for fmt, qfile in (("PCR", pcr), ("PADLOCK", pad)):
        for mode in modes:
            run_mode(mode, fmt, fna, qfile, work)


if __name__ == "__main__":
    main()
