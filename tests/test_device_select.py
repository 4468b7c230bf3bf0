"""Which path a search runs, and what happens when the device fails:
`--tpu-screen T` runs the device path on JAX's default backend, `A` only
on a GPU, a device error ends the search with a non-zero exit, and
chip_smoke.py refuses any platform but a GPU.  Also where the program
keeps its compile cache."""

import io
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

HERE = pathlib.Path(__file__).resolve().parent
DATA = HERE / "data"
GOLD = HERE / "golden" / "e2e"
REPO = HERE.parent

PCR_ARGS = ["-i", "assay_pcr.txt", "-d", "small_db.fna", "-A", "PCR",
            "-e", "40", "-E", "40", "-v", "F"]


def _run(argv, tmp_path, monkeypatch):
    from tntblast_tpu import cli

    monkeypatch.chdir(DATA)
    monkeypatch.setenv("TNTBLAST_TPU_THREADS", "1")
    out = tmp_path / "o.out"
    ret = cli.local_main(argv + ["-o", str(out)], stdout=io.StringIO())
    return ret, out


def test_auto_on_cpu_runs_host_path(tmp_path, monkeypatch, capsys):
    """`A` without a GPU runs the host path, says so, and gives the
    reference output; the device panel is never built."""
    from tntblast_tpu.parallel import panel as panel_mod

    def no_panel(*a, **k):
        raise AssertionError("device panel built without a GPU")

    monkeypatch.setattr(panel_mod.FragmentPanelManager, "__init__",
                        no_panel)
    ret, out = _run(PCR_ARGS + ["--tpu-screen", "A"], tmp_path, monkeypatch)
    assert ret == 0
    assert "host path; default backend cpu" in capsys.readouterr().err
    assert out.read_text() == (GOLD / "pcr_small.out").read_text()


def test_forced_on_cpu_runs_device_path(tmp_path, monkeypatch, capsys):
    """`T` runs the device path on the default backend, here the CPU the
    tests ask for, and says so on one stderr line."""
    ret, out = _run(PCR_ARGS + ["--tpu-screen", "T"], tmp_path, monkeypatch)
    assert ret == 0
    err = capsys.readouterr().err
    assert "device path; default backend cpu (cpu)" in err
    assert out.read_text() == (GOLD / "pcr_small.out").read_text()


def test_auto_selects_device_path_on_gpu(monkeypatch):
    """`A` picks the device path when the default device is a GPU."""
    from tntblast_tpu.engine import select_device_path
    from tntblast_tpu.options import Options

    class FakeGpu:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    opt = Options()
    opt.tpu_screen = "auto"
    err = io.StringIO()
    assert select_device_path(opt, [FakeGpu()], stream=err)
    assert err.getvalue() == ("device path; default backend gpu "
                              "(NVIDIA H100 80GB HBM3)\n")
    opt.tpu_screen = False
    assert not select_device_path(opt, [FakeGpu()], stream=err)


@pytest.mark.parametrize("option", ["tpu_screen", "use_mesh"])
def test_forced_needs_gpu_or_asked_platform(option):
    """A forced device path on a backend that JAX_PLATFORMS did not name
    (JAX fell back to the CPU because CUDA failed to start) is a device
    error, not a device run on the CPU."""
    import jax

    from tntblast_tpu.engine import DeviceError, select_device_path
    from tntblast_tpu.options import Options

    class FakeCpu:
        platform = "cpu"
        device_kind = "cpu"

    opt = Options()
    setattr(opt, option, True)
    asked = jax.config.jax_platforms
    jax.config.update("jax_platforms", None)
    try:
        with pytest.raises(DeviceError, match="found the cpu backend"):
            select_device_path(opt, [FakeCpu()], stream=io.StringIO())
        setattr(opt, option, False)
        opt.tpu_screen = "auto"
        err = io.StringIO()
        assert not select_device_path(opt, [FakeCpu()], stream=err)
        assert err.getvalue() == "host path; default backend cpu (cpu)\n"
    finally:
        jax.config.update("jax_platforms", asked)


@pytest.mark.parametrize("threads", ["1", "4"])
def test_device_error_exits_nonzero(tmp_path, monkeypatch, capsys,
                                    threads):
    """A failing device call ends the search with a non-zero exit that
    names the platform and the reason: no silent host fallback, on the
    sequential and the threaded loop alike."""
    from tntblast_tpu import cli
    from tntblast_tpu.parallel.device_search import DevicePanel

    def broken(self, *a, **k):
        raise RuntimeError("injected device failure")

    monkeypatch.setattr(DevicePanel, "submit_fragments", broken)
    monkeypatch.chdir(DATA)
    monkeypatch.setenv("TNTBLAST_TPU_THREADS", threads)
    ret = cli.local_main(PCR_ARGS + ["-o", str(tmp_path / "o.out"),
                                     "--tpu-screen", "T"],
                         stdout=io.StringIO())
    assert ret != 0
    err = capsys.readouterr().err
    assert "device path failed on cpu" in err
    assert "injected device failure" in err


def test_cache_dir_from_environment(monkeypatch, tmp_path):
    from tntblast_tpu import jaxconf

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert jaxconf.cache_dir() == str(tmp_path)


def test_cache_dir_default_is_in_checkout(monkeypatch):
    from tntblast_tpu import jaxconf

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert jaxconf.cache_dir() == str(REPO / ".jax_cache")
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def _smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_on_cpu():
    """chip_smoke.py on a CPU backend exits non-zero and prints no
    result line."""
    res = _smoke(REPO)
    assert res.returncode != 0
    assert "platform=cpu" in res.stdout
    assert '"ok"' not in res.stdout
    assert "not 'gpu'" in res.stderr


def test_chip_smoke_fails_alone(tmp_path):
    """chip_smoke.py without the rest of the repository fails too."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    res = _smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
