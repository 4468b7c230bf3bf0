"""End-to-end golden parity: run the CLI on every recorded
reference configuration and require byte-identical output (file and
terminal; only the wall-clock seconds line is normalized).

Goldens were produced by the reference binary (jgans/thermonucleotideBLAST
v2.77 built with plain make, OMP_NUM_THREADS=1); see
tests/tools/gen_e2e_goldens.py.
"""

import io
import pathlib
import re
import sys

import pytest

HERE = pathlib.Path(__file__).resolve().parent
DATA = HERE / "data"
GOLD = HERE / "golden" / "e2e"

CONFIGS = sorted(p.stem for p in GOLD.glob("*.cmd"))


def normalize_stdout(text, out_path):
    text = re.sub(r"Search completed in \d+ sec", "Search completed in N sec",
                  text)
    # The recorded "Output = <path>" line carries the golden's absolute path
    text = text.replace(str(out_path), "OUTPATH")
    return text


@pytest.mark.parametrize("name", CONFIGS)
def test_golden_config(name, tmp_path, monkeypatch, capfd):
    from tntblast_tpu import cli

    args = (GOLD / f"{name}.cmd").read_text().split()
    out_file = tmp_path / f"{name}.out"
    args += ["-o", str(out_file)]

    monkeypatch.chdir(DATA)
    monkeypatch.setenv("TNTBLAST_TPU_THREADS", "1")

    stdout = io.StringIO()
    real_stdout = sys.stdout
    sys.stdout = stdout
    try:
        print("Running on local machine [1 thread(s)]")
        ret = cli.local_main(args, stdout=stdout)
    finally:
        sys.stdout = real_stdout
    assert ret == 0, f"exit={ret}; stderr produced"

    got_out = out_file.read_text() if out_file.exists() else ""
    want_path = GOLD / f"{name}.out"
    want_out = want_path.read_text() if want_path.exists() else ""
    assert got_out == want_out, f"output file mismatch for {name}"
    # network output mode (-m 2) writes .sif/.atr companions
    for ext in (".sif", ".atr"):
        want_c = GOLD / f"{name}.out{ext}"
        if want_c.exists():
            got_c = pathlib.Path(str(out_file) + ext)
            assert got_c.exists(), f"missing {ext} output for {name}"
            assert got_c.read_text() == want_c.read_text(), \
                f"{ext} mismatch for {name}"

    golden_out_path = f"/root/repo/tests/golden/e2e/{name}.out"
    got_stdout = normalize_stdout(stdout.getvalue(), str(out_file))
    want_stdout = normalize_stdout(
        (GOLD / f"{name}.stdout").read_text(), golden_out_path)
    assert got_stdout == want_stdout, f"stdout mismatch for {name}"


@pytest.mark.parametrize("name", ["pcr_frag", "taqman", "padlock",
                                  "probe_small", "plex", "query_seg",
                                  "query_seg_frag"])
def test_golden_config_threaded(name, tmp_path, monkeypatch):
    """The threaded fragment loop (engine._run_search_parallel) must
    produce a byte-identical hit list to the sequential run."""
    from tntblast_tpu import cli

    args = (GOLD / f"{name}.cmd").read_text().split()
    out_file = tmp_path / f"{name}.out"
    args += ["-o", str(out_file)]

    monkeypatch.chdir(DATA)
    monkeypatch.setenv("TNTBLAST_TPU_THREADS", "4")

    stdout = io.StringIO()
    ret = cli.local_main(args, stdout=stdout)
    assert ret == 0

    got_out = out_file.read_text() if out_file.exists() else ""
    want_out = (GOLD / f"{name}.out").read_text()
    assert got_out == want_out, f"threaded output mismatch for {name}"


@pytest.mark.parametrize("name", ["pcr_small", "taqman", "probe_small"])
def test_golden_config_device_screen(name, tmp_path, monkeypatch):
    """--tpu-screen (Pallas screening kernel + native verdicts) must be
    output-invariant: screening is provably conservative."""
    from tntblast_tpu import cli

    args = (GOLD / f"{name}.cmd").read_text().split()
    out_file = tmp_path / f"{name}.out"
    args += ["-o", str(out_file), "--tpu-screen", "T"]

    monkeypatch.chdir(DATA)
    monkeypatch.setenv("TNTBLAST_TPU_THREADS", "1")

    stdout = io.StringIO()
    ret = cli.local_main(args, stdout=stdout)
    assert ret == 0

    got_out = out_file.read_text() if out_file.exists() else ""
    want_out = (GOLD / f"{name}.out").read_text()
    assert got_out == want_out, f"device-screen output mismatch for {name}"


@pytest.mark.parametrize("name", ["pcr_frag", "taqman", "pcr_small"])
def test_golden_config_mesh(name, tmp_path, monkeypatch):
    """--mesh T (SPMD fragment sharding over the 8-device CPU mesh,
    parallel/mesh.py) must be output-invariant: the sharded seed+screen
    step feeds the same pre-screened seed lists as the single-device
    path, so the hit list stays byte-identical to the reference golden."""
    from tntblast_tpu import cli

    args = (GOLD / f"{name}.cmd").read_text().split()
    out_file = tmp_path / f"{name}.out"
    args += ["-o", str(out_file), "--mesh", "T"]

    monkeypatch.chdir(DATA)
    monkeypatch.setenv("TNTBLAST_TPU_THREADS", "2")

    stdout = io.StringIO()
    ret = cli.local_main(args, stdout=stdout)
    assert ret == 0

    got_out = out_file.read_text() if out_file.exists() else ""
    want_out = (GOLD / f"{name}.out").read_text()
    assert got_out == want_out, f"mesh output mismatch for {name}"


def test_usage_text_parity():
    """-h usage must be byte-identical to the reference
    (options.cpp:420-498), modulo the two appended device flag lines and the
    USE_BLAST_DB-conditional lines (the recorded golden is from a no-BLAST
    build; ours corresponds to the USE_BLAST_DB build)."""
    from tntblast_tpu.cli import usage_text

    ours = [l for l in usage_text().splitlines(keepends=True)
            if "--tpu-" not in l and "--blast-" not in l
            and "--mesh" not in l]
    want = (HERE / "golden" / "usage_noblast.txt").read_text()
    assert "".join(ours) == want


def test_one_output_file_per_query(tmp_path, monkeypatch):
    """-n T writes one output file per assay, named <out>.<assay name>
    (reference tntblast_local.cpp:190-231); recorded from the reference
    binary under golden/e2e/per_query/."""
    from tntblast_tpu import cli

    pq = GOLD / "per_query"
    out_base = tmp_path / "probe.out"
    monkeypatch.chdir(DATA)
    monkeypatch.setenv("TNTBLAST_TPU_THREADS", "1")
    ret = cli.local_main(
        ["-i", "assay_probe.txt", "-d", "small_db.fna", "-A", "PROBE",
         "-E", "40", "-n", "T", "-o", str(out_base)],
        stdout=io.StringIO())
    assert ret == 0
    golds = sorted(p for p in pq.iterdir() if not p.name.endswith("stdout"))
    assert golds, "no recorded per-query goldens"
    for g in golds:
        suffix = g.name[len("probe.out"):]
        got = tmp_path / ("probe.out" + suffix)
        assert got.exists(), f"missing per-query file {g.name}"
        assert got.read_text() == g.read_text(), f"mismatch for {g.name}"
