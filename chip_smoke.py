"""Smoke test of the device search path on one GPU.

Drives the normal CLI entry point (`cli.local_main` with `--tpu-screen T`)
at deployment sizes and checks every result against a reference, in one
process that owns the card:

  (a) device report: JAX platform, device kind and count, and the card's
      name and power limit from nvidia-smi; any platform but gpu fails;
  (b) rebuilds the native engine from its sources (set-up time);
  (c) compiles the panel step at bench widths and prints its compile time
      and memory analysis;
  (d) runs the `gpu`-marked tests on the card: the screen DP against a
      numpy recurrence, the device evaluator against the native engine,
      and the whole panel step against the CPU backend, all exactly;
  (e) hit-list parity and sizes: the 12 screened golden configs, the 8 Mb
      bench deployment (sha-checked against the reference output) and one
      128 Mb chromosome (PCR and PADLOCK panels, device against host),
      with set-up time apart from steady time, Mb/s and peak device
      memory;
  (f) repeats the 8 Mb device run and counts compilations: there must be
      none.

Every number line names the card and its power limit.  The last line of
standard output is one JSON object, printed only when every phase passed.
Each search run is logged as it begins and ends, under a watchdog: a run
that outlasts its limit dumps every thread's stack to stderr and ends the
script with a non-zero exit.

`--four-cards` runs only the multi-device paths instead, on the 8 Mb and
128 Mb deployments: `--mesh T` over four cards in this process, and four
`parallel.multiproc` ranks bound to one card each, both against this
process's one-card device hit list.  Every rank must say that it runs the
device path on a GPU.  This process and each rank then get
a share of every card's memory (XLA_PYTHON_CLIENT_MEM_FRACTION).

Run from the repository root:  python3 chip_smoke.py [--four-cards]
"""

import argparse
import contextlib
import faulthandler
import hashlib
import io
import json
import os
import signal
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "bench_work")
OUT = os.path.join(WORK, "smoke")
REQUIRED_PLATFORM = "gpu"
WARM_BASES = 1_000_000          # warm-up slice of the 128 Mb target
FOUR_CARD_MEM_FRACTION = "0.3"  # per process and card in --four-cards
RUN_LIMIT_S = 120     # watchdog on one search run, compile included
RANKS_LIMIT_S = 180   # four multiproc ranks, start-up and compile included
GPU_PATH = "device path; default backend gpu"
BACKEND_COMPILE_EVENT = "/jax/core/compile/backend_compile_duration"
CACHE_HIT_EVENT = "/jax/compilation_cache/cache_hits"
# the test files that hold `gpu`-marked tests (named, not collected from
# tests/, so that another installed `tests` package cannot shadow the
# repository's during collection)
GPU_TEST_FILES = ("tests/test_device_search.py",
                  "tests/test_eval_gapless_jax.py")

CARD = "card unknown"
COMPILES = [0]
CACHE_HITS = [0]


def log(msg):
    print(f"[{CARD}] {msg}", flush=True)


def sha256(path):
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


@contextlib.contextmanager
def watchdog(what, limit):
    """Logs the start and end of `what`.  If it has not ended after
    `limit` seconds, every thread's stack goes to stderr and the process
    ends with a non-zero exit, so that a hang shows where it is."""
    log(f"begin {what}")
    t0 = time.perf_counter()
    faulthandler.dump_traceback_later(limit, exit=True)
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()
    log(f"end {what} ({time.perf_counter() - t0:.3f} s)")


def device_report(count):
    """Phase (a): the devices JAX sees; fails unless they are `count`
    GPUs or more."""
    global CARD
    import jax

    from tntblast_tpu.devinfo import nvidia_smi

    devs = jax.devices()
    dev = devs[0]
    cards = nvidia_smi()
    CARD = cards[0]
    print(f"jax platform={dev.platform} device_kind={dev.device_kind} "
          f"count={len(devs)}", flush=True)
    print(f"host cpus: os.cpu_count()={os.cpu_count()} usable="
          f"{len(os.sched_getaffinity(0))}", flush=True)
    for line in cards:
        print(f"nvidia-smi: {line}", flush=True)
    if dev.platform != REQUIRED_PLATFORM:
        raise SystemExit(f"chip_smoke: JAX platform is {dev.platform!r}, "
                         f"not {REQUIRED_PLATFORM!r}: no GPU to test")
    if len(devs) < count:
        raise SystemExit(f"chip_smoke: {len(devs)} device(s), "
                         f"{count} needed")
    from jax import monitoring

    def on_event(event, duration, **_):
        if event == BACKEND_COMPILE_EVENT:
            COMPILES[0] += 1

    def on_hit(event, **_):
        if event == CACHE_HIT_EVENT:
            CACHE_HITS[0] += 1

    monitoring.register_event_duration_secs_listener(on_event)
    monitoring.register_event_listener(on_hit)
    return dev


def build_native():
    """Phase (b): rebuild the native engine from the committed sources
    (a copied tree may carry a library built elsewhere)."""
    from tntblast_tpu import native

    t0 = time.perf_counter()
    native.build()
    log(f"set-up: native engine build {time.perf_counter() - t0:.3f} s")


def peak_bytes(dev):
    return (dev.memory_stats() or {}).get("peak_bytes_in_use",
                                          "not available")


def run_cli(argv, cwd=None):
    """cli.local_main with stdout captured; returns (rc, seconds,
    stderr text)."""
    from tntblast_tpu import cli

    prev = os.getcwd()
    err = io.StringIO()
    t0 = time.perf_counter()
    try:
        if cwd:
            os.chdir(cwd)
        with contextlib.redirect_stderr(err):
            rc = cli.local_main(argv, stdout=io.StringIO())
    finally:
        os.chdir(prev)
    return rc, time.perf_counter() - t0, err.getvalue()


def checked_run(what, argv, cwd=None):
    with watchdog(what, RUN_LIMIT_S):
        rc, dt, err = run_cli(argv, cwd)
    if rc != 0:
        raise SystemExit(f"chip_smoke: {what} exited {rc}: {err[-2000:]}")
    return dt, err


# --- deployments ---------------------------------------------------------

def bench_deployment():
    """The 8 Mb bench: 4 x 2 Mb genome, 10-assay PCR panel."""
    import bench_data

    fna, panel = bench_data.build(WORK)
    warm = os.path.join(WORK, "warm.fna")
    if not os.path.exists(warm):
        with open(fna) as src, open(warm, "w") as dst:
            n_hdr = 0
            for line in src:
                if line.startswith(">"):
                    n_hdr += 1
                    if n_hdr > 1:
                        break
                dst.write(line)
    flags = ["-i", panel, "-A", "PCR", "-e", "40", "-E", "45", "-l", "2000"]
    mb = bench_data.NSEQ * bench_data.SEQLEN / 1e6
    return [("bench 8 Mb PCR", fna, warm, flags, mb)]


def chromosome_deployments():
    """One 128 Mb sequence of tools/scaled_bench.py's seeded database
    (its seed and planting, NSEQ cut from 8 to 1), PCR and PADLOCK."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import scaled_bench

    t0 = time.perf_counter()
    fna, pcr, pad = scaled_bench.build(WORK, nseq=1)
    log(f"set-up: 128 Mb target generated/loaded in "
        f"{time.perf_counter() - t0:.3f} s")
    warm = os.path.join(WORK, "warm_128mb.fna")
    if not os.path.exists(warm):
        with open(fna) as src, open(warm, "w") as dst:
            dst.write(src.readline())
            n = 0
            while n < WARM_BASES:
                line = src.readline()
                dst.write(line)
                n += len(line) - 1
    mb = scaled_bench.SEQLEN / 1e6
    return [
        ("chromosome 128 Mb PCR", fna, warm,
         ["-i", pcr, "-A", "PCR", "-e", "40", "-E", "45", "-l", "2000"], mb),
        ("chromosome 128 Mb PADLOCK", fna, warm,
         ["-i", pad, "-A", "PADLOCK", "-e", "40", "-E", "45"], mb),
    ]


def bench_panel_step():
    """(DevicePanel, fragments) of the bench at its real widths: the bench
    panel's group and one device batch of bench fragments."""
    import bench_data
    from tntblast_tpu.engine import make_melt_engine
    from tntblast_tpu.io.fastx import open_database, seq_len_increment
    from tntblast_tpu.model import (
        expand_degenerate_signatures, read_input_file)
    from tntblast_tpu.options import Options
    from tntblast_tpu.parallel.panel import FragmentPanelManager

    fna, panel = bench_data.build(WORK)
    opt = Options()
    opt.parse(["-i", panel, "-d", fna, "-A", "PCR", "-e", "40", "-E", "45",
               "-l", "2000", "-o", os.devnull])
    opt.sig_list = expand_degenerate_signatures(
        read_input_file(opt.input_filename, opt.ignore_probe, False),
        opt.degen_rescale_ct)
    mgr = FragmentPanelManager(opt, make_melt_engine(opt, n_threads=1))
    db = open_database(opt.dbase_filename)
    mpl = opt.max_product_length() + 2
    frags = []
    for tgt in range(db.size()):
        tlen = db.approx_seq_len(tgt)
        delta = seq_len_increment(tlen, opt.fragment_target_threshold)[0]
        start, stop = 0, delta
        while True:
            frags.append(db.read(tgt, start, stop + mpl)[1])
            if stop == tlen - 1:
                break
            start, stop = stop + 1, min(stop + delta, tlen - 1)
    frags = frags[:mgr.batch]
    g = mgr.groups[0]
    return g.device_panel(mgr._tile_len(max(len(f) for f in frags))), frags


def compile_check():
    """Phase (c): compile the panel step at bench widths, with the
    persistent compile cache off so that the time is a cold compile.  JAX
    decides once per process whether it uses that cache, so the decision
    is reset around the compile."""
    import jax
    from jax.experimental.compilation_cache import compilation_cache

    dp, frags = bench_panel_step()
    cfg = dp.config
    payload = dp._pack_host(frags)
    cached = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    n0, hits = COMPILES[0], CACHE_HITS[0]
    try:
        with watchdog("compile check", RUN_LIMIT_S):
            t0 = time.perf_counter()
            compiled = dp._step(len(frags), False).lower(
                *payload, *dp.args).compile()
            dt = time.perf_counter() - t0
    finally:
        jax.config.update("jax_enable_compilation_cache", cached)
        compilation_cache.reset_cache()
    if COMPILES[0] == n0 or CACHE_HITS[0] != hits:
        raise SystemExit("chip_smoke: the compile check was served from a "
                         "cache, not compiled")
    log(f"compile: panel step at bench widths (batch {len(frags)}, tile "
        f"{cfg.tile_len}, slots {dp.n_real}, wq {cfg.wq_max}, cap "
        f"{cfg.cap}, conditions {cfg.num_cond}) compiled cold in "
        f"{dt:.3f} s")
    log(f"compile: memory_analysis {compiled.memory_analysis()}")


def gpu_tests():
    """Phase (d): the `gpu`-marked tests, run on the card."""
    import pytest

    class Count:
        def __init__(self):
            self.passed, self.other = [], []

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed.append(report.nodeid)
            elif report.failed or report.skipped:
                self.other.append((report.nodeid, report.outcome))

    count = Count()
    t0 = time.perf_counter()
    with watchdog("gpu tests", RUN_LIMIT_S):
        rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider"]
                         + [os.path.join(REPO, f) for f in GPU_TEST_FILES],
                         plugins=[count])
    dt = time.perf_counter() - t0
    for nodeid in count.passed:
        log(f"gpu test passed: {nodeid}")
    if rc != 0 or count.other or not count.passed:
        raise SystemExit(f"chip_smoke: gpu tests rc={rc} "
                         f"not passed: {count.other}")
    log(f"gpu tests: {len(count.passed)} passed in {dt:.3f} s")


def golden_parity():
    """Phase (e), part 1: the screened golden configs on the card."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_e2e_screen import CONFIGS, DATA, GOLD

    os.makedirs(OUT, exist_ok=True)
    for name in CONFIGS:
        args = (GOLD / f"{name}.cmd").read_text().split()
        out = os.path.join(OUT, f"golden_{name}.out")
        dt, _ = checked_run(f"golden {name} device",
                            args + ["-o", out, "--tpu-screen", "T", "-v", "F"],
                            cwd=DATA)
        got = open(out).read() if os.path.exists(out) else ""
        if got != (GOLD / f"{name}.out").read_text():
            raise SystemExit(f"chip_smoke: golden {name}: device hit list "
                             "differs from the reference output")
        log(f"golden {name}: device hit list identical ({dt:.3f} s, "
            "compile included)")
    log(f"goldens: {len(CONFIGS)} of {len(CONFIGS)} identical")


def measure(dev, name, fna, warm, flags, mb, device):
    """One e2e run through cli.local_main: warm-up on a slice with the
    same panel and tile shape (set-up, compile included), then the timed
    run.  Returns the hit list's sha256."""
    label = "device" if device else "host"
    extra = ["--tpu-screen", "T"] if device else []
    out = os.path.join(OUT, f"{name.replace(' ', '_')}_{label}.out")
    warm_s, _ = checked_run(f"{name} {label} warm-up",
                            flags + ["-d", warm, "-o", out, "-v", "F"] + extra)
    n0 = COMPILES[0]
    steady_s, err = checked_run(f"{name} {label} steady",
                                flags + ["-d", fna, "-o", out, "-v", "F"]
                                + extra)
    digest = sha256(out)
    mem = f" peak_bytes_in_use={peak_bytes(dev)}" if device else ""
    log(f"{name} {label}: set-up {warm_s:.3f} s (warm-up slice, compile "
        f"included), steady {steady_s:.3f} s = {mb / steady_s:.3f} Mb/s, "
        f"compiles in steady run {COMPILES[0] - n0}, sha256 {digest}{mem}")
    if device and GPU_PATH not in err:
        raise SystemExit(f"chip_smoke: {name}: device path did not run: "
                         f"{err[-1000:]}")
    return digest


def sizes(dev):
    """Phase (e), part 2: the 8 Mb bench and the 128 Mb chromosome, host
    and device; returns the 8 Mb deployment for phase (f)."""
    from bench import BENCH_GOLDEN_SHA256

    bench = bench_deployment()
    for dep in bench:
        for device in (False, True):
            digest = measure(dev, *dep, device=device)
            if digest != BENCH_GOLDEN_SHA256:
                raise SystemExit(f"chip_smoke: {dep[0]} sha {digest} is not "
                                 f"the reference {BENCH_GOLDEN_SHA256}")
    for dep in chromosome_deployments():
        host = measure(dev, *dep, device=False)
        device = measure(dev, *dep, device=True)
        if host != device:
            raise SystemExit(f"chip_smoke: {dep[0]}: device hit list "
                             "differs from the host path's")
        log(f"{dep[0]}: device hit list identical to the host path's")
    return bench[0]


def cache_check(dep):
    """Phase (f): a repeated device run compiles nothing."""
    name, fna, _, flags, mb = dep
    n0 = COMPILES[0]
    out = os.path.join(OUT, "repeat_device.out")
    dt, _ = checked_run(f"{name} device repeat",
                        flags + ["-d", fna, "-o", out, "-v", "F",
                                 "--tpu-screen", "T"])
    n = COMPILES[0] - n0
    log(f"cache: repeated {name} device run {dt:.3f} s = {mb / dt:.3f} "
        f"Mb/s, {n} new compilations")
    if n:
        raise SystemExit(f"chip_smoke: the repeated run compiled {n} "
                         "program(s)")


# --- four cards ----------------------------------------------------------

def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def multiproc_run(name, argv, n):
    """`n` parallel.multiproc ranks, rank i bound to card i; rank 0
    writes the hit list, and every rank must say that it runs the device
    path on a GPU.  Ranks still running after RANKS_LIMIT_S dump their
    stacks (faulthandler on SIGABRT) and are killed.  Returns seconds."""
    port = free_port()
    env = dict(os.environ, XLA_PYTHON_CLIENT_MEM_FRACTION=(
        FOUR_CARD_MEM_FRACTION))
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in [env.get("PYTHONPATH")] if p])
    t0 = time.perf_counter()
    procs, logs = [], []
    for i in range(n):
        cmd = [sys.executable, "-X", "faulthandler",
               "-m", "tntblast_tpu.parallel.multiproc",
               "--coordinator", f"localhost:{port}", "--num-procs", str(n),
               "--proc-id", str(i), "--local-device-ids", str(i), "--"]
        logs.append(os.path.join(OUT, f"rank{i}.err"))
        with open(logs[-1], "w") as err:
            procs.append(subprocess.Popen(
                cmd + argv, cwd=REPO, env=env, stdout=subprocess.DEVNULL,
                stderr=err))
    deadline = time.monotonic() + RANKS_LIMIT_S
    try:
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        log(f"{name}: multiproc ranks still running after {RANKS_LIMIT_S} "
            "s; their stacks follow")
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGABRT)
        time.sleep(5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    dt = time.perf_counter() - t0
    errs = []
    for path in logs:
        with open(path) as fh:
            errs.append("".join(ln for ln in fh
                                if "Nvml call failed" not in ln))
    bad = [i for i, p in enumerate(procs)
           if p.returncode or GPU_PATH not in errs[i]]
    if bad:
        raise SystemExit(
            f"chip_smoke: {name}: multiproc ranks {bad} failed or ran off "
            f"the GPU (exit codes {[p.returncode for p in procs]})"
            + "".join(f"\n--- rank {i} stderr\n{errs[i][-3000:]}"
                      for i in bad))
    return dt


def four_cards(dev, n):
    os.makedirs(OUT, exist_ok=True)
    for name, fna, warm, flags, mb in (bench_deployment()
                                       + chromosome_deployments()):
        one = measure(dev, name, fna, warm, flags, mb, device=True)
        out = os.path.join(OUT, f"{name.replace(' ', '_')}_mesh.out")
        checked_run(f"{name} --mesh T warm-up",
                    flags + ["-d", warm, "-o", out, "-v", "F", "--mesh", "T"])
        dt, err = checked_run(f"{name} --mesh T steady",
                              flags + ["-d", fna, "-o", out, "-v", "F",
                                       "--mesh", "T"])
        if GPU_PATH not in err:
            raise SystemExit(f"chip_smoke: {name} --mesh T: device path did "
                             f"not run on a GPU: {err[-1000:]}")
        mesh = sha256(out)
        log(f"{name} --mesh T over {n} cards: steady {dt:.3f} s = "
            f"{mb / dt:.3f} Mb/s (compile in warm-up), sha256 {mesh}, "
            f"peak_bytes_in_use(card 0)={peak_bytes(dev)}")
        out = os.path.join(OUT, f"{name.replace(' ', '_')}_multiproc.out")
        with watchdog(f"{name} multiproc {n} ranks", RANKS_LIMIT_S + 60):
            dt = multiproc_run(name, flags + ["-d", fna, "-o", out, "-v", "F",
                                              "--tpu-screen", "T"], n)
        ranks = sha256(out)
        log(f"{name} multiproc {n} ranks x 1 card: {dt:.3f} s = "
            f"{mb / dt:.3f} Mb/s (rank start-up and compile included), "
            f"sha256 {ranks}")
        if not one == mesh == ranks:
            raise SystemExit(f"chip_smoke: {name}: hit lists differ: 1 card "
                             f"{one}, mesh {mesh}, multiproc {ranks}")
        log(f"{name}: 1-card, mesh and multiproc hit lists identical")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the --mesh and 4-rank multiproc paths on "
                         "four cards")
    args = ap.parse_args(argv)
    n = 4 if args.four_cards else 1
    if args.four_cards:
        os.environ["XLA_PYTHON_CLIENT_MEM_FRACTION"] = FOUR_CARD_MEM_FRACTION
    sys.path.insert(0, REPO)
    dev = device_report(n)
    build_native()
    if args.four_cards:
        log(f"four cards: this process and each rank hold "
            f"{FOUR_CARD_MEM_FRACTION} of each card's memory")
        four_cards(dev, n)
    else:
        compile_check()
        gpu_tests()
        golden_parity()
        cache_check(sizes(dev))
    import jax

    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
