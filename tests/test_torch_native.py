"""The port's host C++ libraries vs mdd_tpu's, on the CPU: the denoiser bit
for bit (seeded noisy waveforms at aggressiveness 1-4, an empty and a
short input), the mmap ark reader (`index` / `view` / `read`, a view held
past `close`), `bulk_load` and `matrix_rows` against both readers and the
port's pure-Python pass, the `mdd_denoise` tool on a wav, and the
refusals where mdd_tpu passes the input through: a compile that fails, a
missing compiler, a non-zero return of the denoiser.

mdd_tpu's libraries are built from a copy of its sources in a temporary
directory (its module's paths patched there for the module's tests), so
that this file never races tests/test_native.py's build on another
worker."""

import gc
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

import mdd_tpu.native as jax_native
from mdd_tpu.frontend import kaldi_io as jax_kaldi_io
from mdd_tpu_torch import cli, native
from mdd_tpu_torch.frontend import kaldi_io
from mdd_tpu_torch.frontend.wav import read_wav, write_wav
from mdd_tpu_torch.ops import build

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_libs(tmp_path_factory):
    """mdd_tpu.native bound to libraries built from a private copy of its
    sources -> that copy's build directory."""
    src = tmp_path_factory.mktemp("jax_native") / "native"
    shutil.copytree(ROOT / "native", src, ignore=shutil.ignore_patterns(
        "build"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_NATIVE_DIR", src)
        mp.setattr(jax_native, "_LIB_PATH", src / "build" / "libmdddenoise.so")
        mp.setattr(jax_native, "_ARK_LIB_PATH",
                   src / "build" / "libmddarkio.so")
        mp.setattr(jax_native, "_lib", None)
        mp.setattr(jax_native, "_ark_lib", None)
        assert jax_native.ensure_built(), "mdd_tpu's native build failed"
        assert jax_native.native_available()
        yield src / "build"


def _noisy(seconds: float, seed: int) -> np.ndarray:
    """Tone bursts under a Hann envelope in white noise, int16 scale."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000.0
    clean = np.zeros_like(t)
    for f0, start in zip(rng.uniform(150, 900, 3), (0.1, 0.4, 0.7)):
        seg = (t >= start * seconds) & (t < (start + 0.2) * seconds)
        clean[seg] = (8000 * np.sin(2 * np.pi * f0 * t[seg])
                      * np.hanning(seg.sum()))
    return (clean + 500 * rng.standard_normal(t.size)).astype(np.float32)


@pytest.mark.parametrize("aggressiveness", [1, 2, 3, 4])
@pytest.mark.parametrize("seconds,seed", [(0.6, 0), (1.7, 1)])
def test_denoise_matches_jax_bit_for_bit(jax_libs, aggressiveness, seconds,
                                         seed):
    x = _noisy(seconds, seed)
    ours = native.spectral_denoise(x, 16000, aggressiveness)
    ref = jax_native.spectral_denoise(x, 16000, aggressiveness)
    assert ours.dtype == np.float32 and ours.shape == x.shape
    assert np.array_equal(ours.view(np.uint32), ref.view(np.uint32))
    assert not np.array_equal(ours, x)


@pytest.mark.parametrize("n", [0, 1, 100, 511])
def test_denoise_empty_and_short_inputs_match_jax(jax_libs, n):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32) * 300
    ours = native.spectral_denoise(x)
    ref = jax_native.spectral_denoise(x)
    assert ours.shape == (n,)
    assert np.array_equal(ours.view(np.uint32), ref.view(np.uint32))


def test_denoise_raises_snr():
    """The property mdd_tpu's own test holds (tests/test_native.py): at
    least 3 dB better on white noise around speech-band tone bursts."""
    rng = np.random.default_rng(0)
    t = np.arange(3 * 16000) / 16000.0
    clean = np.zeros_like(t, dtype=np.float32)
    for f0, start in [(220.0, 0.5), (440.0, 1.2), (330.0, 2.0)]:
        seg = (t >= start) & (t < start + 0.4)
        clean[seg] = 8000 * np.sin(2 * np.pi * f0 * t[seg]) * np.hanning(
            seg.sum())
    noisy = clean + rng.standard_normal(t.size).astype(np.float32) * 500

    def snr(y):
        return 10 * np.log10(np.sum(clean ** 2) / np.sum((y - clean) ** 2))

    assert snr(native.spectral_denoise(noisy)) > snr(noisy) + 3.0


@pytest.fixture(scope="module")
def ark(tmp_path_factory):
    """Two arks of seeded float32 matrices -> (dir, {utt: matrix})."""
    d = tmp_path_factory.mktemp("ark")
    rng = np.random.default_rng(0)
    mats = {}
    for name, n in (("a", 20), ("b", 7)):
        with kaldi_io.ArkScpWriter(str(d / f"{name}.ark"),
                                   str(d / f"{name}.scp")) as w:
            for i in range(n):
                m = rng.standard_normal(
                    (int(rng.integers(1, 60)), 81)).astype(np.float32)
                mats[f"{name}{i}"] = m
                w.write(f"{name}{i}", m)
    return d, mats


def test_reader_matches_jax(jax_libs, ark):
    d, mats = ark
    with native.NativeArkReader(str(d / "a.ark")) as r, \
            jax_native.NativeArkReader(str(d / "a.ark")) as ref:
        assert r.n == ref.n == 20
        assert r.utts == ref.utts == [f"a{i}" for i in range(20)]
        assert r.by_offset == ref.by_offset
        assert np.array_equal(r.rows, ref.rows)
        assert np.array_equal(r.cols, ref.cols)
        for utt, rx in kaldi_io.read_scp(str(d / "a.scp")).items():
            i = r.by_offset[int(rx.rsplit(":", 1)[1])]
            assert np.array_equal(r.read(i), ref.read(i))
            assert np.array_equal(r.read(i), mats[utt])
            assert np.array_equal(r.view(i), ref.view(i))


def test_view_survives_close(ark):
    d, _ = ark
    r = native.NativeArkReader(str(d / "a.ark"))
    v = r.view(3)
    want = np.array(v)
    r.close()
    assert r._h is not None           # the munmap waits for the view
    assert np.array_equal(v, want)
    del v
    gc.collect()
    assert r._h is None
    with pytest.raises(ValueError):
        r.view(0)


def test_reader_refuses_what_it_cannot_index(tmp_path):
    with pytest.raises(OSError):
        native.NativeArkReader(str(tmp_path / "missing.ark"))
    bad = tmp_path / "double.ark"
    with open(bad, "wb") as f:   # a float64 (BDM) entry: not plain BFM
        f.write(b"u0 \x00BBDM \x04" + np.int32(2).tobytes() + b"\x04"
                + np.int32(3).tobytes() + np.arange(6.0).tobytes())
    with pytest.raises(OSError):
        native.NativeArkReader(str(bad))
    # the format dispatch: bulk_load reads it in Python, as mdd_tpu does
    (mat,) = kaldi_io.bulk_load([f"{bad}:3"])
    assert np.array_equal(mat, np.arange(6.0, dtype=np.float32).reshape(2, 3))
    assert kaldi_io.matrix_rows([f"{bad}:3"]) == [2]


def test_bulk_load_matches_both_readers_and_the_python_pass(jax_libs, ark):
    d, mats = ark
    scp = {**kaldi_io.read_scp(str(d / "a.scp")),
           **kaldi_io.read_scp(str(d / "b.scp"))}
    rxs = list(scp.values())[::-1] + [str(d / "a.ark")]   # a bare ark path
    want = [mats[u] for u in list(scp)[::-1]] + [mats["a0"]]
    ours = kaldi_io.bulk_load(rxs)
    plain = kaldi_io.bulk_load_python(rxs)
    ref = jax_kaldi_io.bulk_load(rxs)
    for a, b, c, w in zip(ours, plain, ref, want):
        assert a.dtype == np.float32
        assert np.array_equal(a, w) and np.array_equal(a, b)
        assert np.array_equal(a, c)
    rows = [m.shape[0] for m in want]
    assert kaldi_io.matrix_rows(rxs) == jax_kaldi_io.matrix_rows(rxs) == rows


def test_denoise_cli_round_trips_a_wav(jax_libs, tmp_path):
    x = _noisy(1.2, 3)
    src = tmp_path / "in.wav"
    write_wav(str(src), x, 16000)
    data, _ = read_wav(str(src))
    outs = {}
    for name, binary in (("ours", native.denoise_cli_path()),
                         ("ref", str(jax_libs / "mdd_denoise"))):
        outs[name] = tmp_path / f"{name}.wav"
        subprocess.run([binary, str(src), str(outs[name]), "4"], check=True,
                       timeout=60)
    assert outs["ours"].read_bytes() == outs["ref"].read_bytes()
    y, sr = read_wav(str(outs["ours"]))
    assert sr == 16000 and y.shape == data.shape
    # the tool writes PCM16: the library's output, rounded
    np.testing.assert_allclose(y, native.spectral_denoise(data), atol=1.0)


@pytest.fixture
def broken_csrc(tmp_path, monkeypatch):
    """The build pointed at sources that do not compile, the loaded
    libraries forgotten."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("denoise.cc", "ark_io.cc"):
        (csrc / name).write_text("this is not C++\n")
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_ark_lib", None)
    return csrc


def test_failed_build_raises_everywhere(broken_csrc, ark):
    d, _ = ark
    x = _noisy(0.5, 0)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.spectral_denoise(x)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.NativeArkReader(str(d / "a.ark"))
    # no silent Python path for a library that does not build
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        kaldi_io.bulk_load(list(kaldi_io.read_scp(str(d / "a.scp")).values()))
    assert not list((broken_csrc.parent / "_build").glob("*.tmp"))


def test_missing_compiler_raises(broken_csrc, monkeypatch):
    monkeypatch.setenv("CXX", str(broken_csrc / "no-such-g++"))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.spectral_denoise(np.zeros(10, np.float32))


def test_denoiser_failure_raises(monkeypatch):
    class Failing:
        @staticmethod
        def mdd_denoise_process(*args):
            return 1

    monkeypatch.setattr(native, "_lib", Failing())
    with pytest.raises(RuntimeError, match="returned 1"):
        native.spectral_denoise(np.ones(1000, np.float32))


def test_infer_fails_naming_no_denoise_when_the_denoiser_does_not_build(
        broken_csrc, tmp_path):
    """Where mdd_tpu warns and serves without denoise, the port stops."""
    args = cli.build_parser().parse_args(
        ["infer", "--wav-transcript-path", str(tmp_path), "--conf",
         str(tmp_path / "c.yaml"), "--cmvn", str(tmp_path / "cmvn.txt"),
         "--device", "cpu"])
    assert args.denoise
    (tmp_path / "c.yaml").write_text(f"vocab_file: {tmp_path / 'units'}\n")
    import mdd_tpu_torch.cli as port_cli

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_cli, "_load_best", lambda cfg, ckpt: (None, None))
        with pytest.raises(SystemExit, match="--no-denoise"):
            port_cli._build_engine(args)


def test_host_build_is_keyed_by_source_and_flags():
    paths = {t: build.host_path(t) for t in build.HOST_TARGETS}
    assert paths["libmdddenoise.so"].name.startswith("libmdddenoise-")
    assert paths["libmdddenoise.so"].suffix == ".so"
    assert paths["mdd_denoise"].suffix == ""
    # one source, two flag sets: two builds
    assert paths["mdd_denoise"].name.split("-")[1] != \
        paths["libmdddenoise.so"].name.split("-")[1].split(".")[0]
    assert build.GXX_FLAGS == ("-O2", "-fPIC", "-std=c++17", "-Wall")
