"""The port's warm-up (Av1Encoder.warm_device, started by a caller of
SvtAv1Encoder.warm_device, never by init) and the thread safety of its
kernel build (ops/cuda/build.py).

On the CPU warm_device does nothing, as does SVT_TPU_NO_WARM=1 and an
encode the device MD cannot take. Where it runs, a failure in its thread
surfaces at the encoder's next device call: here the thread is started
on an encoder told it runs on a card, with the kernel build made to
fail. Its work builds the kernels only for an encoder that runs them. Two threads asking build.load for one kernel compile it once and
load it once (a stub compiler script stands in for nvcc)."""

import stat
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from svt_av1_psyex_tpu_torch.codec.encoder import Av1Encoder, SequenceConfig  # noqa: E402
from svt_av1_psyex_tpu_torch.ops.cuda import build, is_warming, warming  # noqa: E402


def _frame(w=64, h=64):
    rng = np.random.default_rng(1)
    return [rng.integers(0, 256, (h, w)).astype(np.uint8),
            np.full((h // 2, w // 2), 128, np.uint8),
            np.full((h // 2, w // 2), 128, np.uint8)]


def _encoder(**kw):
    return Av1Encoder(SequenceConfig(width=64, height=64), preset=12,
                      device="cpu", **kw)


def test_does_nothing_on_the_cpu():
    enc = _encoder()
    enc.warm_device(tpl_frames=12, tf_windows=(3, 6))
    assert enc._warm_thread is None
    assert enc.encode_frame(_frame(), 120, force_key=True)


def test_api_init_starts_no_thread_on_the_cpu():
    from svt_av1_psyex_tpu_torch.api.encoder import SvtAv1Encoder

    api = SvtAv1Encoder(device="cpu")
    api.config.source_width = api.config.source_height = 64
    api.init()
    assert api._enc._warm_thread is None
    api.warm_device()
    assert api._enc._warm_thread is None


def test_api_init_does_not_start_warm(monkeypatch):
    """init leaves warm_device to the caller; the API's warm_device
    passes TPL's keyframe group length and the TF windows on."""
    from svt_av1_psyex_tpu_torch.api.encoder import SvtAv1Encoder

    calls = []
    monkeypatch.setattr(Av1Encoder, "warm_device",
                        lambda self, *a: calls.append(a))
    api = SvtAv1Encoder(device="cpu")
    c = api.config
    c.source_width = c.source_height = 64
    c.enc_mode = 8
    api.init()
    assert calls == []
    api.warm_device()
    assert len(calls) == 1
    tpl_frames, tf_windows = calls[0]
    assert tpl_frames > 1 and 3 in tf_windows
    monkeypatch.setenv("SVT_TPU_HOST_TF", "1")
    api.warm_device()
    assert calls[1] == (tpl_frames, ())


@pytest.mark.parametrize("kernels", ["plain", "hand"])
def test_warm_builds_kernels_only_for_them(kernels, monkeypatch):
    """The warm-up's work (run here on the calling thread, on the CPU)
    loads the kernel libraries only for an encoder that runs the
    kernels: a plain encoder warms and encodes with the build failing."""
    def fail(name):
        raise RuntimeError(f"nvcc failed for {name}.cu")

    monkeypatch.setattr(build, "load", fail)
    enc = _encoder(kernels=kernels)
    if kernels == "hand":
        with pytest.raises(RuntimeError, match="nvcc failed"):
            enc._warm_programs(4, (3,))
        return
    enc._warm_programs(4, (3, 6))
    assert enc.encode_frame(_frame(), 120, force_key=True)


@pytest.mark.parametrize("case", ["no_warm", "host_md"])
def test_does_nothing_when_switched_off(case, monkeypatch):
    """SVT_TPU_NO_WARM=1, or an encode the device MD cannot take (two
    tile columns), starts no thread even on a card."""
    enc = _encoder(tile_cols_log2=1 if case == "host_md" else 0)
    if case == "no_warm":
        monkeypatch.setenv("SVT_TPU_NO_WARM", "1")
    enc.device = torch.device("cuda", 0)
    enc.warm_device()
    assert enc._warm_thread is None


def test_failure_surfaces_at_the_next_device_call(monkeypatch):
    def fail(name):
        raise RuntimeError(f"nvcc failed for {name}.cu")

    monkeypatch.setattr(build, "load", fail)
    enc = _encoder()
    enc.device = torch.device("cuda", 0)
    enc.warm_device()
    assert enc._warm_thread is not None
    enc._warm_thread.join(timeout=60)
    assert not enc._warm_thread.is_alive()
    enc.device = torch.device("cpu")
    with pytest.raises(RuntimeError, match="warm_device") as info:
        enc.encode_frame(_frame(), 120, force_key=True)
    assert "nvcc failed for fullloop.cu" in str(info.value.__cause__)
    assert enc._warm_thread is None and enc._warm_error is None
    assert enc.encode_frame(_frame(), 120, force_key=True)


def test_warming_is_per_thread():
    seen = []
    with warming():
        assert is_warming()
        t = threading.Thread(target=lambda: seen.append(is_warming()))
        t.start()
        t.join(timeout=10)
    assert seen == [False] and not is_warming()


def test_build_from_two_threads_compiles_and_loads_once(tmp_path,
                                                        monkeypatch):
    """build.load from two threads at once, with a stub compiler that
    builds a C library with the system compiler: one compile, one loaded
    library shared by both threads."""
    src_dir, out_dir = tmp_path / "src", tmp_path / "out"
    src_dir.mkdir()
    (src_dir / "stub.cu").write_text("int svt_stub(void) { return 7; }\n")
    log = tmp_path / "compiles"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import subprocess, sys, time\n"
        f"open({str(log)!r}, 'a').write('x')\n"
        "time.sleep(0.5)\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "sys.exit(subprocess.call(['cc', '-shared', '-fPIC', '-x', 'c',\n"
        "                          '-o', out, sys.argv[-1]]))\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(build, "SRC_DIR", src_dir)
    monkeypatch.setattr(build, "BUILD_DIR", out_dir)
    monkeypatch.setattr(build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(build, "_libs", {})
    start = threading.Barrier(2)
    libs, errors = [], []

    def run():
        try:
            start.wait(timeout=30)
            libs.append(build.load("stub"))
        except Exception as e:   # reported below
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors
    assert log.read_text() == "x"
    assert len(libs) == 2 and libs[0] is libs[1]
    assert libs[0].svt_stub() == 7
    assert sorted(p.name for p in out_dir.iterdir()) == ["libstub.so"]
