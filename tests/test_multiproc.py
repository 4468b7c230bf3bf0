"""Multi-process distributed runtime (parallel/multiproc.py, the
reference MPI master/worker analogue, tntblast_master.cpp:28 /
tntblast_worker.cpp:23): N jax.distributed processes each search a
static shard of the (target, fragment) work-item list; results gather to
process 0, whose merged hit list must be BYTE-IDENTICAL to the recorded
reference golden (SURVEY §4 item 3)."""

import os
import pathlib
import subprocess
import sys

import pytest

HERE = pathlib.Path(__file__).resolve().parent
DATA = HERE / "data"
GOLD = HERE / "golden" / "e2e"
REPO = HERE.parent

_PORT = 9741


def _run_procs(name, num_procs, tmp_path):
    global _PORT
    _PORT += 1  # fresh port per test: no TIME_WAIT collisions
    args = (GOLD / f"{name}.cmd").read_text().split()
    out_file = tmp_path / f"{name}.out"

    env = dict(os.environ)
    env.update({
        "JAX_PLATFORMS": "cpu",
        "TNTBLAST_TPU_THREADS": "1",
        "PYTHONPATH": str(REPO),
        # one virtual device per process is enough for the gather
        "XLA_FLAGS": "--xla_force_host_platform_device_count=1",
    })
    procs = []
    for i in range(num_procs):
        cmd = [sys.executable, "-m", "tntblast_tpu.parallel.multiproc",
               "--coordinator", f"127.0.0.1:{_PORT}",
               "--num-procs", str(num_procs), "--proc-id", str(i), "--",
               *args, "-o", str(out_file) if i == 0
               else str(tmp_path / f"rank{i}.ignore")]
        procs.append(subprocess.Popen(
            cmd, cwd=DATA, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err.decode()[-2000:]
    return out_file


@pytest.mark.parametrize("name,num_procs", [
    ("pcr_frag", 2),      # fragmented targets: shard axis really splits
    ("taqman", 3),        # probe containment + secondary Tms
    ("inverse_target", 2),  # -m 3: merged no-match target report
])
def test_multiproc_matches_golden(name, num_procs, tmp_path):
    out_file = _run_procs(name, num_procs, tmp_path)
    got = out_file.read_text() if out_file.exists() else ""
    want = (GOLD / f"{name}.out").read_text()
    assert got == want, f"{num_procs}-process output mismatch for {name}"


def _run_procs_args(extra_args, out_file, num_procs, n_virtual_dev=1,
                    base_cmd="pcr_frag"):
    global _PORT
    _PORT += 1
    args = (GOLD / f"{base_cmd}.cmd").read_text().split()
    env = dict(os.environ)
    env.update({
        "JAX_PLATFORMS": "cpu",
        "TNTBLAST_TPU_THREADS": "1",
        "PYTHONPATH": str(REPO),
        "XLA_FLAGS":
            f"--xla_force_host_platform_device_count={n_virtual_dev}",
    })
    procs = []
    for i in range(num_procs):
        cmd = [sys.executable, "-m", "tntblast_tpu.parallel.multiproc",
               "--coordinator", f"127.0.0.1:{_PORT}",
               "--num-procs", str(num_procs), "--proc-id", str(i), "--",
               *args, *extra_args,
               "-o", str(out_file) if i == 0
               else str(out_file) + f".rank{i}.ignore"]
        procs.append(subprocess.Popen(
            cmd, cwd=DATA, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    errs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err.decode()[-2000:]
        errs.append(err.decode())
    return errs


def test_multiproc_device_panel(tmp_path):
    """Process-per-host topology: each process drives its own device
    panel (--tpu-screen under jax.distributed).  Output must be
    byte-identical and the panel must actually run on every process."""
    out_file = tmp_path / "out.txt"
    errs = _run_procs_args(["--tpu-screen", "T"], out_file, 2)
    got = out_file.read_text() if out_file.exists() else ""
    want = (GOLD / "pcr_frag.out").read_text()
    assert got == want
    for e in errs:
        assert "device path; default backend cpu" in e, e[-500:]


def test_multiproc_mesh_per_process(tmp_path):
    """Process x device: 2 processes, each meshing 2 virtual devices —
    process per host, devices per process — in simulation."""
    out_file = tmp_path / "out.txt"
    errs = _run_procs_args(["--mesh", "T"], out_file, 2, n_virtual_dev=2)
    got = out_file.read_text() if out_file.exists() else ""
    want = (GOLD / "pcr_frag.out").read_text()
    assert got == want
    for e in errs:
        assert "device path; default backend cpu" in e, e[-500:]


def test_multiproc_per_query_files(tmp_path):
    """-n T (one output file per query) under the distributed runtime
    must produce the same per-query files as the single-process run
    (VERDICT r3 weak #6)."""
    import filecmp
    import io

    from tntblast_tpu import cli

    single_dir = tmp_path / "single"
    multi_dir = tmp_path / "multi"
    single_dir.mkdir()
    multi_dir.mkdir()
    args = (GOLD / "pcr_frag.cmd").read_text().split()

    cwd = os.getcwd()
    try:
        os.chdir(DATA)
        rc = cli.local_main(
            args + ["-n", "T", "-o", str(single_dir / "out.txt")],
            stdout=io.StringIO())
    finally:
        os.chdir(cwd)
    assert rc == 0

    _run_procs_args(["-n", "T"], multi_dir / "out.txt", 2)
    singles = sorted(p.name for p in single_dir.iterdir())
    multis = sorted(p.name for p in multi_dir.iterdir()
                    if ".ignore" not in p.name)
    assert singles == multis and singles, (singles, multis)
    for name in singles:
        assert filecmp.cmp(single_dir / name, multi_dir / name,
                           shallow=False), name


def test_multiproc_partition_balances_skewed_db():
    """LPT-by-bases partition (VERDICT r4 #5): a database with one large
    chromosome among many small plasmids must split so the heaviest
    process carries at most ~ideal + one fragment — and every process
    must compute the identical assignment."""
    from tntblast_tpu.parallel.multiproc import partition_items

    # one 50 Mb chromosome fragmented into 100 x 500 kb + 1000 x 10 kb
    items = [(0, i * 500_000, (i + 1) * 500_000 - 1, 49_999_999)
             for i in range(100)]
    items += [(1 + t, 0, 9_999, 9_999) for t in range(1000)]
    sizes = [stop - start + 1 for (_, start, stop, _) in items]
    total = sum(sizes)
    for num_procs in (2, 3, 8):
        owner = partition_items(items, num_procs)
        assert owner == partition_items(items, num_procs)  # deterministic
        loads = [0] * num_procs
        for o, sz in zip(owner, sizes):
            loads[o] += sz
        ideal = total / num_procs
        assert max(loads) <= ideal + 500_000, (num_procs, loads)
        # well within the 15%-of-ideal target
        assert max(loads) / ideal <= 1.15, (num_procs, loads)

    # the old static idx % P shard FAILS when expensive items share a
    # residue class (e.g. big/small alternating targets): all the big
    # fragments land on process 0
    alt = []
    for i in range(100):
        alt.append((2 * i, 0, 499_999, 499_999))      # big target
        alt.append((2 * i + 1, 0, 9_999, 9_999))      # small target
    alt_sizes = [stop - start + 1 for (_, start, stop, _) in alt]
    mod0 = sum(alt_sizes[0::2])
    assert mod0 / (sum(alt_sizes) / 2) > 1.15
    owner = partition_items(alt, 2)
    loads = [0, 0]
    for o, sz in zip(owner, alt_sizes):
        loads[o] += sz
    assert max(loads) / (sum(alt_sizes) / 2) <= 1.15, loads
